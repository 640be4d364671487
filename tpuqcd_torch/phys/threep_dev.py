"""Three-point contractions and momentum projection on packed propagators.

Counterpart of ``tpuqcd/phys/threep_dev.py``.  Packed propagator layout
(phys/contract_dev.py): ``[2(ri), 2(par), 4(snk s), 3(snk c), 4(src s),
3(src c), T, Z, S]``, S = Y * X//2.

* Momentum projection: a packed density -> complex [n_mom, T] with the
  phases e^{-i p.(x - x0)}, by a phase-list sum for a few momenta and by
  one spatial ``torch.fft.fftn`` and a gather for momentum lists of
  FFT_MOM_THRESHOLD or more.  Every projecting function takes ``fft``
  (None: by the list's length); the chosen path runs or raises, there is
  no fall back from one to the other.  The sums run in complex128.
* Insertions: every ultra-local Gamma shares the open-spin bilinear
  density D[g, h](x) = sum_{c, q, b} B(x)_{(g c),(q b)} S(x)_{(h c),(q b)},
  so one pass over the propagator pair gives all 16; the one-derivative
  insertions gamma_mu D<->_nu reuse it on (B, D_nu S) and (D_nu^T B, S),
  the symmetric covariant derivative acting on the sink colour through
  the neighbour tables of the Dslash (ops/gauge_tools.neighbour_tables),
  t included.  All of it runs as complex einsums over chunks of sites of
  one parity (contract_dev.SITE_CHUNK), so no intermediate is larger than
  a chunk of a propagator; only the densities [G, 2(par), T, Z, S] are
  whole.
* The fixed-sink sequential source A_f = dC2(t_sink)/dS_f is
  torch.autograd.grad of the real part of the projected proton density
  (contract_dev.proton_2pt_site_dev) over the real planes of the leg:
  for the holomorphic C2, dC2/dS = dReC2/dS_re - i dReC2/dS_im.  The
  density is site-local, so the gradient is taken on the t_sink
  timeslice alone and placed into a zero propagator.
* The backward propagator B = conj(g5 M_{f'}^{-1} g5 conj(A)) from one
  batched solve of the 12 columns.

Sink-momentum convention.  The sink phase is e^{-i p'.(x - x0)}, relative
to the source position x0 like every other phase of the run.  tpuqcd
puts e^{-i p'.x} on the sink (its threep_dev.py:406, :415-428, and
threep.py:52-55), so with p' != 0 and a source off the origin its
three-point function is e^{-i p'.x0} times the port's: a phase that the
two-point function at p' does not carry, which makes the ratio C3 / C2
depend on where the source sits and cancels in an average over source
positions.  The port's sequential source moves with a translated source;
tpuqcd's does not (tests/test_torch_threep.py::
test_sequential_source_moves_with_the_source).  At x0 = 0 the two agree.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..fields import eo_to_full
from ..gammas import G5_DIAG, GAMMA, PARITY_PLUS
from ..lattice import Lattice
from ..ops.gauge_tools import neighbour_tables

#: momentum-list length from which one spatial FFT + gather beats the
#: n x V phase sum (tpuqcd's value)
FFT_MOM_THRESHOLD = 32


# --- momentum projection -----------------------------------------------------

def momentum_phases(lat: Lattice, momenta, src_pos=(0, 0, 0), device=None,
                    lmesh=None) -> torch.Tensor:
    """e^{-i p.(x - x0)} for integer momenta [n, 3] (units 2 pi / L):
    complex128 [n, Z, Y, X]; src_pos = (x0, y0, z0).  On a mesh
    (``lmesh``) at this rank's block's global z and y only."""
    m = torch.as_tensor(np.asarray(momenta), dtype=torch.float64, device=device).reshape(-1, 3)
    x0, y0, z0 = src_pos
    (zs, nz), (ys, ny) = (0, lat.Lz), (0, lat.Ly)
    if lmesh is not None:
        (zs, nz), (ys, ny) = (lmesh.z_offset, lmesh.local_dims[1]), (lmesh.y_offset,
                                                                    lmesh.local_y)

    def ar(lo, n_, o, total):
        return (torch.arange(lo, lo + n_, dtype=torch.float64, device=device) - o) / total
    arg = (m[:, 0, None, None, None] * ar(0, lat.Lx, x0, lat.Lx)[None, None, None, :]
           + m[:, 1, None, None, None] * ar(ys, ny, y0, lat.Ly)[None, None, :, None]
           + m[:, 2, None, None, None] * ar(zs, nz, z0, lat.Lz)[None, :, None, None])
    return torch.polar(torch.ones_like(arg), -2.0 * torch.pi * arg)


def momentum_phases_pk(lat: Lattice, momenta, src_pos=(0, 0, 0), device=None,
                       lmesh=None) -> torch.Tensor:
    """The phases in the parity-split device layout: float64
    [2(ri), n, 2(par), T, Z, S], S = Y * X//2; on a mesh (``lmesh``) on this
    rank's block, whose packing is the global one."""
    blk = lat if lmesh is None else lmesh.local_lat
    ph = momentum_phases(lat, momenta, src_pos, device, lmesh)    # [n, Z, Y, X]
    s = blk.eo_sub_parity(device)[None, :, :, :, None]            # [1, T, Z, Y, 1]
    ph0, ph1 = ph[:, None, :, :, 0::2], ph[:, None, :, :, 1::2]   # [n, 1, Z, Y, Xh]
    pk = torch.stack([torch.where(s, ph1, ph0), torch.where(s, ph0, ph1)], dim=1)
    pk = pk.reshape(pk.shape[0], 2, *blk.site_shape)
    return torch.stack([pk.real, pk.imag])


def _mom_indices(lat: Lattice, momenta, device):
    m = torch.as_tensor(np.asarray(momenta), dtype=torch.int64, device=device).reshape(-1, 3)
    return m[:, 2] % lat.Lz, m[:, 1] % lat.Ly, m[:, 0] % lat.Lx


def _fft_grid(dens: torch.Tensor, lat: Lattice, src_pos) -> torch.Tensor:
    """Complex densities [..., 2(par), T, Z, S] -> the complex128 momentum
    grids [..., T, Z, Y, X] (one FFT over the spatial volume of every
    timeslice, the source rolled to 0); ``lat`` may hold fewer timeslices
    than the lattice, if they start at an even t."""
    lead = dens.shape[:-4]
    c = dens.to(torch.complex128).reshape(*lead, 2, lat.Lt, lat.Lz, lat.Ly, lat.Lx // 2)
    full = eo_to_full(c, lat, site_ndim_left=len(lead))
    x0, y0, z0 = (int(v) for v in src_pos)
    if x0 or y0 or z0:   # e^{-ip.(x-x0)}: roll so the source sits at 0
        full = torch.roll(full, (-z0, -y0, -x0), dims=(-3, -2, -1))
    return torch.fft.fftn(full, dim=(-3, -2, -1))


def _project(dens: torch.Tensor, lat: Lattice, momenta, src_pos, fft: bool | None,
             lmesh=None) -> torch.Tensor:
    """Complex densities [..., 2(par), T, Z, S] -> complex128 [..., n_mom, T]
    by the FFT + gather or the phase sum (see project_momenta_pk).  On a
    mesh the densities are this rank's block: its partial sums are placed
    at its timeslices and summed over the ranks (solvers/reductions.mesh_sum)."""
    whole_xyz = lmesh is None or lmesh.nz == lmesh.ny == 1
    if fft is None:
        fft = len(momenta) >= FFT_MOM_THRESHOLD and whole_xyz
    if fft and not whole_xyz:
        raise ValueError("the FFT projection needs each rank to hold whole timeslices: on a "
                         "mesh with nz or ny > 1 take the phase sum (fft=False)")
    blk = lat if lmesh is None else lmesh.local_lat
    if fft:
        iz, iy, ix = _mom_indices(lat, momenta, dens.device)
        c = _fft_grid(dens, blk, src_pos)[..., iz, iy, ix].transpose(-1, -2)
    else:
        ph = momentum_phases_pk(lat, momenta, src_pos, dens.device, lmesh)
        c = torch.einsum("nptzs,...ptzs->...nt", torch.complex(ph[0], ph[1]),
                         dens.to(torch.complex128))
    if lmesh is None:
        return c
    from ..solvers.reductions import mesh_sum
    out = c.new_zeros((*c.shape[:-1], lat.Lt))
    out[..., lmesh.t_offset:lmesh.t_offset + blk.Lt] = c
    return mesh_sum(out, lmesh)


def project_momenta_pk(dens_pk: torch.Tensor, lat: Lattice, momenta,
                       src_pos=(0, 0, 0), fft: bool | None = None,
                       lmesh=None) -> torch.Tensor:
    """Packed density [2(ri), 2(par), T, Z, S] -> complex128 [n_mom, T] on
    the density's device; src_pos = (x0, y0, z0).  ``fft`` picks the FFT +
    gather (default: for FFT_MOM_THRESHOLD momenta or more, where each rank
    holds whole timeslices) or the phase sum.  On a mesh (``lmesh``) the
    density is this rank's block and every rank gets the whole [n_mom, T]."""
    return _project(torch.complex(dens_pk[0].double(), dens_pk[1].double()), lat, momenta,
                    src_pos, fft, lmesh)


def project_all_momenta_fft_pk(dens_pk: torch.Tensor, lat: Lattice,
                               src_pos=(0, 0, 0)) -> torch.Tensor:
    """The full momentum grid from one spatial FFT: complex128 [T, Lz, Ly,
    Lx] with out[t, nz % Lz, ny % Ly, nx % Lx] the phase-sum projection at
    integer momentum (nx, ny, nz)."""
    return _fft_grid(torch.complex(dens_pk[0].double(), dens_pk[1].double()), lat, src_pos)


# --- site chunks ---------------------------------------------------------------

def _cdtype(x: torch.Tensor) -> torch.dtype:
    return torch.complex128 if x.dtype == torch.float64 else torch.complex64


def _at(x_flat: torch.Tensor, p: int, idx, cdt: torch.dtype) -> torch.Tensor:
    """Sites idx (a slice or an index tensor) of parity p of a packed field
    flattened over its sites, [2(ri), 2(par), ..., n] -> complex [..., len(idx)]."""
    rdt = torch.float64 if cdt == torch.complex128 else torch.float32
    return torch.complex(x_flat[0, p][..., idx].to(rdt), x_flat[1, p][..., idx].to(rdt))


def _over_sites(fn, inner, site_shape, device, cdt) -> torch.Tensor:
    """fn(p, sl) -> complex [*inner, len(sl)] for the sites sl of parity p,
    over chunks of both parities -> complex [*inner, 2(par), T*Z*S]."""
    from .contract_dev import SITE_CHUNK
    n = int(np.prod(site_shape))
    out = torch.empty((*inner, 2, n), dtype=cdt, device=device)
    for p in (0, 1):
        for lo in range(0, n, SITE_CHUNK):
            sl = slice(lo, min(lo + SITE_CHUNK, n))
            out[..., p, sl] = fn(p, sl)
    return out


def _packed(c: torch.Tensor, site_shape) -> torch.Tensor:
    """complex [*inner, 2(par), n] -> packed real [2(ri), 2(par), *inner, T, Z, S]."""
    c = c.movedim(-2, 0)
    return torch.stack([c.real, c.imag]).reshape(2, 2, *c.shape[1:-1], *site_shape)


def _bilinear(b: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """D[g,h] = sum_{c,q,b} B_{(g c),(q b)} S_{(h c),(q b)} on complex chunks
    [4, 3, 4, 3, x] -> [4, 4, x]."""
    return torch.einsum("gcqbx,hcqbx->ghx", b, s)


# --- covariant derivative on the sink colour ---------------------------------------

#: the mesh axes the covariant derivative reads across (x never)
DERIV_AXES = ("t", "z", "y")


class _Hood(NamedTuple):
    """Where a covariant shift reads: the packed links at the block's own
    sites ``u`` and at the sites the tables gather from ``u_x`` (both
    flattened over their sites), the tables, and ``ghosted``, which gives a
    packed field flattened over those sites: itself on a whole lattice, the
    block with its ghost layer on a mesh."""
    u: torch.Tensor
    u_x: torch.Tensor
    tables: tuple
    ghosted: Callable


def _hood(u_pk: torch.Tensor, lat: Lattice, site_shape, device, lmesh) -> _Hood:
    """u_pk is the whole gauge (every rank holds it); on a mesh the block's
    links and its ghost layer in t, z and y are cut from it, and a field's
    ghost layer is exchanged (parallel/sharded.exchange_ghosts)."""
    if lmesh is None:
        u = u_pk.flatten(-3)
        return _Hood(u, u, neighbour_tables(lat, device), lambda f: f.flatten(-3))
    from ..parallel.sharded import exchange_ghosts, ghost_block, ghost_tables
    return _Hood(lmesh.shard(u_pk).flatten(-3),
                 ghost_block(lmesh, u_pk, DERIV_AXES).flatten(-3),
                 ghost_tables(site_shape, lat.Lx, DERIV_AXES, device),
                 lambda f: exchange_ghosts(lmesh, f, DERIV_AXES).flatten(-3))


def _link(u_flat: torch.Tensor, nu: int, p: int, idx, cdt, conj: bool) -> torch.Tensor:
    """U_nu at the sites idx of parity p of the packed gauge flattened over
    its sites [4, 2(par), 3, 3, 2(ri), n] -> complex [3, 3, len(idx)]."""
    rdt = torch.float64 if cdt == torch.complex128 else torch.float32
    w = u_flat[nu, p]
    c = torch.complex(w[:, :, 0][..., idx].to(rdt), w[:, :, 1][..., idx].to(rdt))
    return c.conj() if conj else c


def _shift(hood: _Hood, f_x, nu: int, sign: int, p: int, sl, conj: bool) -> torch.Tensor:
    """U_nu(x) f(x+nu) (sign +1) or U_nu(x-nu)^dag f(x-nu) (sign -1) on the
    sink colour, at the sites sl of parity p (f_x: hood.ghosted(f)):
    complex [4, 3, 4, 3, x]."""
    cdt = _cdtype(f_x)
    nb = hood.tables[1 - p][nu, 0 if sign > 0 else 1][sl]   # the neighbours, on parity 1 - p
    fn = _at(f_x, 1 - p, nb, cdt)
    if sign > 0:
        return torch.einsum("ijx,sjqbx->siqbx", _link(hood.u, nu, p, sl, cdt, conj), fn)
    return torch.einsum("jix,sjqbx->siqbx", _link(hood.u_x, nu, 1 - p, nb, cdt, conj).conj(),
                        fn)


def _deriv(hood: _Hood, f_x, nu: int, p: int, sl, conj: bool) -> torch.Tensor:
    """(D_nu f)(x) = [U_nu(x) f(x+nu) - U_nu(x-nu)^dag f(x-nu)] / 2 at the
    sites sl of parity p: complex [4, 3, 4, 3, x]."""
    return 0.5 * (_shift(hood, f_x, nu, +1, p, sl, conj) - _shift(hood, f_x, nu, -1, p, sl, conj))


def _cov(u_pk, f_pk, lat, conj_links, lmesh, op) -> torch.Tensor:
    """op(hood, f_x, p, sl) over the sites of a packed propagator -> packed."""
    site_shape = f_pk.shape[-3:]
    hood = _hood(u_pk, lat, site_shape, f_pk.device, lmesh)
    f_x = hood.ghosted(f_pk)
    c = _over_sites(lambda p, sl: op(hood, f_x, p, sl), tuple(f_pk.shape[2:-3]), site_shape,
                    f_pk.device, _cdtype(f_pk))
    return _packed(c, site_shape).to(f_pk.dtype)


def cov_shift_pk(u_pk: torch.Tensor, f_pk: torch.Tensor, nu: int, sign: int, lat: Lattice,
                 conj_links: bool = False, lmesh=None) -> torch.Tensor:
    """U_nu(x) f(x+nu) (sign +1) or U_nu(x-nu)^dag f(x-nu) (sign -1) on the
    sink colour of a packed propagator [2(ri), 2(par), 4, 3, q, b, T, Z, S]
    (any source axes q, b: 1, 1 for a spinor).  u_pk: the packed gauge [4,
    2(par), 3, 3, 2(ri), T, Z, S] (the run's, boundary phase in);
    ``conj_links`` uses conj(U) (the derivative of a backward propagator).
    On a mesh (``lmesh``) f_pk is this rank's block, u_pk whole."""
    return _cov(u_pk, f_pk, lat, conj_links, lmesh, lambda hood, f_x, p, sl: _shift(
        hood, f_x, nu, sign, p, sl, conj_links))


def cov_deriv_sym_pk(u_pk: torch.Tensor, f_pk: torch.Tensor, nu: int, lat: Lattice,
                     conj_links: bool = False, lmesh=None) -> torch.Tensor:
    """The symmetric covariant derivative on the sink colour of a packed
    propagator: (D_nu f)(x) = [U_nu(x) f(x+nu) - U_nu(x-nu)^dag f(x-nu)] / 2;
    on a mesh as cov_shift_pk."""
    return _cov(u_pk, f_pk, lat, conj_links, lmesh, lambda hood, f_x, p, sl: _deriv(
        hood, f_x, nu, p, sl, conj_links))


# --- insertions ------------------------------------------------------------------

def _src_xyz(src_pos):
    return (src_pos[3], src_pos[2], src_pos[1])


def bilinear_density_pk(bwd_pk: torch.Tensor, fwd_pk: torch.Tensor) -> torch.Tensor:
    """The open-spin density D[g, h](x) of two packed propagators: packed
    [2(ri), 2(par), 4(g), 4(h), T, Z, S]."""
    cdt, site_shape = _cdtype(fwd_pk), fwd_pk.shape[-3:]
    b_flat, s_flat = bwd_pk.flatten(-3), fwd_pk.flatten(-3)
    c = _over_sites(lambda p, sl: _bilinear(_at(b_flat, p, sl, cdt), _at(s_flat, p, sl, cdt)),
                    (4, 4), site_shape, fwd_pk.device, cdt)
    return _packed(c, site_shape)


def threep_ultralocal_pk(bwd_pk: torch.Tensor, fwd_pk: torch.Tensor, gammas: dict,
                         lat: Lattice, momenta, src_pos=(0, 0, 0, 0),
                         fft: bool | None = None, lmesh=None) -> dict:
    """C3 for a dict of ultra-local insertions {name: Gamma [4, 4]}: one pass
    over the propagator pair weights the bilinear density with every Gamma,
    then one projection; src_pos = (t0, z0, y0, x0).  Returns {name:
    complex128 [n_mom, T]} on the propagators' device; on a mesh
    (``lmesh``) from this rank's blocks, on every rank."""
    cdt, site_shape = _cdtype(fwd_pk), fwd_pk.shape[-3:]
    g = torch.stack([torch.as_tensor(m) for m in gammas.values()]).to(fwd_pk.device, cdt)
    b_flat, s_flat = bwd_pk.flatten(-3), fwd_pk.flatten(-3)

    def chunk(p, sl):
        d = _bilinear(_at(b_flat, p, sl, cdt), _at(s_flat, p, sl, cdt))
        return torch.einsum("agh,ghx->ax", g, d)

    dens = _over_sites(chunk, (len(g),), site_shape, fwd_pk.device, cdt)
    c3 = _project(dens.reshape(len(g), 2, *site_shape), lat, momenta, _src_xyz(src_pos), fft,
                  lmesh)
    return {name: c3[i] for i, name in enumerate(gammas)}


def _onederiv(bwd_pk, fwd_pk, u_pk, lat, momenta, src_pos, fft, nus, lmesh) -> torch.Tensor:
    """(1/2)[B gamma_mu (D_nu S) - (D_nu^T B) gamma_mu S] for every mu and
    the given nus, projected: complex128 [len(nus), 4(mu), n_mom, T]."""
    cdt, site_shape = _cdtype(fwd_pk), fwd_pk.shape[-3:]
    g = GAMMA.to(fwd_pk.device, cdt)
    hood = _hood(u_pk, lat, site_shape, fwd_pk.device, lmesh)
    b_flat, s_flat = bwd_pk.flatten(-3), fwd_pk.flatten(-3)
    b_x, s_x = hood.ghosted(bwd_pk), hood.ghosted(fwd_pk)

    def chunk(p, sl):
        b, s = _at(b_flat, p, sl, cdt), _at(s_flat, p, sl, cdt)
        out = []
        for nu in nus:
            ds = _deriv(hood, s_x, nu, p, sl, False)
            db = _deriv(hood, b_x, nu, p, sl, True)   # D^T B: conjugated links
            out.append(0.5 * torch.einsum("agh,ghx->ax", g, _bilinear(b, ds) - _bilinear(db, s)))
        return torch.stack(out)

    dens = _over_sites(chunk, (len(nus), 4), site_shape, fwd_pk.device, cdt)
    return _project(dens.reshape(len(nus), 4, 2, *site_shape), lat, momenta,
                    _src_xyz(src_pos), fft, lmesh)


def threep_one_derivative_pk(bwd_pk: torch.Tensor, fwd_pk: torch.Tensor, u_pk: torch.Tensor,
                             mu: int, nu: int, lat: Lattice, momenta, src_pos=(0, 0, 0, 0),
                             fft: bool | None = None, lmesh=None) -> torch.Tensor:
    """The one-derivative insertion gamma_mu D<->_nu: (1/2)[B gamma_mu (D_nu
    S) - (D_nu^T B) gamma_mu S], complex128 [n_mom, T]; u_pk the run's packed
    gauge (whole, also on a mesh)."""
    return _onederiv(bwd_pk, fwd_pk, u_pk, lat, momenta, src_pos, fft, (int(nu),),
                     lmesh)[0, int(mu)]


def threep_one_derivative_all_pk(bwd_pk: torch.Tensor, fwd_pk: torch.Tensor,
                                 u_pk: torch.Tensor, lat: Lattice, momenta,
                                 src_pos=(0, 0, 0, 0), fft: bool | None = None,
                                 lmesh=None) -> dict:
    """The 4 x 4 (gamma_mu, D_nu) sweep in one pass over the propagator pair
    and one projection: {"der_g{mu}_D{nu}": complex128 [n_mom, T]}."""
    c3 = _onederiv(bwd_pk, fwd_pk, u_pk, lat, momenta, src_pos, fft, (0, 1, 2, 3), lmesh)
    return {f"der_g{mu}_D{nu}": c3[nu, mu] for mu in range(4) for nu in range(4)}


# --- sequential source and backward propagator -------------------------------------

def proton_seq_source_pk(su_pk: torch.Tensor, sd_pk: torch.Tensor, t_sink: int,
                         flavor_leg: str, lat: Lattice, proj: torch.Tensor | None = None,
                         snk_mom=None, src_pos=(0, 0, 0), lmesh=None) -> torch.Tensor:
    """The fixed-sink sequential source A_f(x) = dC2(t_sink)/dS_f(x) of the
    projected proton correlator with sink momentum ``snk_mom`` (zero by
    default): the packed propagator [2(ri), 2(par), 4, 3, 4, 3, T, Z, S],
    zero off t_sink.  flavor_leg "u" or "d": the propagator the current
    couples to (for u the gradient sums both Wick pairings).  The sink
    phase is e^{-i p'.(x - x0)}, src_pos = (x0, y0, z0) (see the module
    docstring).  On a mesh (``lmesh``) this rank's block: the ranks that
    hold t_sink compute it, the others return zeros; no rank communicates."""
    from .contract_dev import proton_2pt_site_dev
    proj = PARITY_PLUS if proj is None else proj
    mom = np.zeros((1, 3), np.int64) if snk_mom is None else np.asarray([snk_mom])
    t_loc = int(t_sink)
    if lmesh is not None:
        if not lmesh.holds_t(t_sink):
            return torch.zeros_like(su_pk)
        t_loc -= lmesh.t_offset
    ts = slice(t_loc, t_loc + 1)
    su, sd = su_pk[..., ts, :, :].detach(), sd_pk[..., ts, :, :].detach()
    ph = momentum_phases_pk(lat, mom, src_pos, su_pk.device,
                            lmesh)[:, 0, :, ts]                      # [2(ri), 2(par), 1, Z, S]
    with torch.enable_grad():
        leg = (su if flavor_leg == "u" else sd).clone().requires_grad_(True)
        dens = (proton_2pt_site_dev(leg, sd, proj) if flavor_leg == "u"
                else proton_2pt_site_dev(su, leg, proj))
        c2_re = (ph[0] * dens[0] - ph[1] * dens[1]).sum()
        (grad,) = torch.autograd.grad(c2_re, leg)
    out = torch.zeros_like(su_pk)
    out[0, ..., ts, :, :] = grad[0]
    out[1, ..., ts, :, :] = -grad[1]
    return out


def _g5_conj(prop_pk: torch.Tensor) -> torch.Tensor:
    """conj(g5 P), g5 on the sink spin of a packed propagator."""
    g5 = torch.tensor(G5_DIAG, dtype=prop_pk.dtype, device=prop_pk.device).view(4, 1, 1, 1, 1, 1, 1)
    return torch.stack([prop_pk[0] * g5, -prop_pk[1] * g5])


def backward_prop_pk(seq_pk: torch.Tensor, solve_batch) -> torch.Tensor:
    """The backward propagator B = conj(g5 M_{f'}^{-1} g5 conj(A)) of a packed
    sequential source A: its 12 columns g5 conj(A) [12, 2(par), 2(ri), 4, 3,
    T, Z, S] go through solve_batch (the flavor-flipped batched solve) as
    one batch.  Returns the packed backward propagator."""
    from .propagator import assemble_propagator_pk, propagator_columns
    xs = solve_batch(propagator_columns(_g5_conj(seq_pk)).contiguous())
    return _g5_conj(assemble_propagator_pk(xs))
