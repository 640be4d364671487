"""Stochastic disconnected loops on packed spinors.

Counterpart of ``tpuqcd/phys/loops_dev.py``.  Packed spinor layout (the
solver layout, phys/propagator.py): ``[2(par), 2(ri), 4, 3, T, Z, S]``,
a batch of them ``[n, 2(par), 2(ri), ...]``.

* Z4 noise is drawn on a CPU ``torch.Generator`` and then moved to the
  run's device, so one seed gives one noise on the CPU and on the card.
* Every ultra-local insertion needs only the open-spin bilinear
  D[s, u](x) = sum_c conj(a)(x)_{s c} b(x)_{u c}; each Gamma weights its
  16 entries.  Both run as complex einsums over chunks of sites of one
  parity (the site engine of phys/threep_dev.py), and the weighted
  densities are projected by threep_dev's projection: one spatial FFT for
  FFT_MOM_THRESHOLD momenta or more, the phase sum otherwise (``fft``
  chooses); the chosen path runs or raises.
* The loop of a batch is the sum over its rows, taken inside the chunk:
  the dilution classes of a noise, or the low modes, make one density and
  one projection (tpuqcd projects each row and sums the results).
* One-derivative loops put the symmetric covariant derivative
  (threep_dev.cov_deriv_sym_pk's, on the colour) on the right-hand field;
  the run computes its four directions in one pass over the sites.

Every loop is a dict {name: complex128 [n_mom, T]} on the fields' device.

On a mesh (``lmesh``, a parallel/mesh.LatticeMesh) every field is this
rank's block: the noise is drawn whole from the same CPU generator on
every rank and cut (so a mesh of any shape draws the one-card noise), time
dilution reads global timeslices, the derivative reads the ghost layer of
threep_dev._hood, the projections and the deflation coefficients are
summed over the ranks (solvers/reductions.mesh_sum), and every rank gets
the whole loops.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterable

import torch

from ..gammas import G5_DIAG
from ..lattice import Lattice
from ..solvers.reductions import mesh_sum
from .threep_dev import _at, _cdtype, _deriv, _hood, _over_sites, _project, cov_deriv_sym_pk

_Z4_RE = torch.tensor([1.0, 0.0, -1.0, 0.0])
_Z4_IM = torch.tensor([0.0, 1.0, 0.0, -1.0])


def z4_noise_pk(gen: torch.Generator, lat: Lattice, device=None,
                dtype: torch.dtype = torch.float32, lmesh=None) -> torch.Tensor:
    """Z4 volume noise in the packed layout, entries 1, i, -1, -i: drawn on
    the CPU generator ``gen``, then moved to ``device``; on a mesh drawn
    whole and cut to this rank's block first."""
    k = torch.randint(0, 4, (2, 4, 3, *lat.site_shape), generator=gen)
    if lmesh is not None:
        k = lmesh.shard(k)
    return torch.stack([_Z4_RE[k], _Z4_IM[k]], dim=1).to(device, dtype)


def z4_noises(seed: int, n: int, lat: Lattice, device=None,
              lmesh=None) -> Iterable[torch.Tensor]:
    """n Z4 noises drawn one after the other from a CPU generator seeded
    ``seed``, each when it is asked for (on a mesh: this rank's blocks)."""
    gen = torch.Generator().manual_seed(int(seed))
    return (z4_noise_pk(gen, lat, device, lmesh=lmesh) for _ in range(n))


def dilute_time_pk(eta_pk: torch.Tensor, t_class: int, n_classes: int,
                   lmesh=None) -> torch.Tensor:
    """Time dilution: zero the timeslices with t % n_classes != t_class, t
    the global timeslice (on a mesh the block starts at lmesh.t_offset)."""
    t = torch.arange(eta_pk.shape[-3], device=eta_pk.device)
    if lmesh is not None:
        t = t + lmesh.t_offset
    mask = (t % n_classes) == t_class
    return eta_pk * mask.to(eta_pk.dtype)[:, None, None]


def dilute_spin_color_pk(eta_pk: torch.Tensor, s: int, c: int) -> torch.Tensor:
    out = torch.zeros_like(eta_pk)
    out[..., s, c, :, :, :] = eta_pk[..., s, c, :, :, :]
    return out


def diluted_sources_pk(eta_pk: torch.Tensor, dilute_t: int = 1,
                       dilute_sc: bool = False, lmesh=None) -> torch.Tensor:
    """The complete dilution partition of one noise as a batch [n, 2(par),
    2(ri), ...]: dilute_t time classes, each split into the 12 spin-colour
    classes with ``dilute_sc``.  The projectors sum to 1, so the summed
    per-class estimates stay unbiased."""
    parts = ([dilute_time_pk(eta_pk, tc, dilute_t, lmesh) for tc in range(dilute_t)]
             if dilute_t > 1 else [eta_pk])
    if dilute_sc:
        parts = [dilute_spin_color_pk(e, s, c) for e in parts for s in range(4)
                 for c in range(3)]
    return torch.stack(parts)


# --- the bilinear engine ------------------------------------------------------------

def _engine_layout(x: torch.Tensor) -> torch.Tensor:
    """A packed spinor or a batch [n, 2(par), 2(ri), 4, 3, T, Z, S] -> the
    propagator layout of threep_dev's site engine with the rows as its
    source axes, [2(ri), 2(par), 4, 3, n, 1, T, Z, S]."""
    b = x if x.ndim == 8 else x[None]
    return b.permute(2, 1, 3, 4, 0, 5, 6, 7).unsqueeze(5)


def _weights(mats: dict, device, cdt) -> torch.Tensor:
    return torch.stack([torch.as_tensor(m) for m in mats.values()]).to(device, cdt)


def _bilinear(ac: torch.Tensor, bc: torch.Tensor) -> torch.Tensor:
    """D[s, u] = sum_{c, rows} conj(a)_{s c} b_{u c} of complex chunks [4, 3,
    n, 1, x] -> [4, 4, x]."""
    return torch.einsum("scnox,ucnox->sux", ac.conj(), bc)


def _loop_all(a_pk: torch.Tensor, b_pk: torch.Tensor, mats: dict, lat: Lattice, momenta,
              fft: bool | None = None, u_pk: torch.Tensor | None = None,
              nus=None, lmesh=None) -> dict:
    """sum_rows sum_x e^{-i q.x} a^dag O b for every O of ``mats`` {name: [4,
    4]}; with ``nus`` and the run's packed gauge u_pk (whole, also on a
    mesh), b is replaced by D_nu b and the names get a suffix _D<nu>.  On a
    mesh a_pk and b_pk are this rank's blocks."""
    cdt = _cdtype(b_pk)
    site_shape = b_pk.shape[-3:]
    a_flat, b_eng = _engine_layout(a_pk).flatten(-3), _engine_layout(b_pk)
    g = _weights(mats, b_pk.device, cdt)

    def weigh(ac, bc):       # [4, 3, n, 1, x] pair -> [G, x]
        return torch.einsum("gsu,sux->gx", g, _bilinear(ac, bc))

    if nus is None:
        b_flat = b_eng.flatten(-3)

        def chunk(p, sl):
            return weigh(_at(a_flat, p, sl, cdt), _at(b_flat, p, sl, cdt))
        dens = _over_sites(chunk, (len(g),), site_shape, b_pk.device, cdt)
        loops = _project(dens.reshape(len(g), 2, *site_shape), lat, momenta, (0, 0, 0), fft,
                         lmesh)
        return {name: loops[i] for i, name in enumerate(mats)}
    hood = _hood(u_pk, lat, site_shape, b_pk.device, lmesh)
    b_x = hood.ghosted(b_eng)

    def chunk_der(p, sl):
        ac = _at(a_flat, p, sl, cdt)
        return torch.stack([weigh(ac, _deriv(hood, b_x, nu, p, sl, False)) for nu in nus])

    dens = _over_sites(chunk_der, (len(nus), len(g)), site_shape, b_pk.device, cdt)
    loops = _project(dens.reshape(len(nus), len(g), 2, *site_shape), lat, momenta,
                     (0, 0, 0), fft, lmesh)
    return {f"{name}_D{nu}": loops[j, i] for j, nu in enumerate(nus)
            for i, name in enumerate(mats)}


def loop_bilinear_pk(a_pk: torch.Tensor, b_pk: torch.Tensor) -> torch.Tensor:
    """D[s, u](x) = sum_c conj(a)_{s c} b_{u c} of two packed spinors:
    packed [2(ri), 2(par), 4(s), 4(u), T, Z, S]."""
    cdt = _cdtype(b_pk)
    a_flat, b_flat = _engine_layout(a_pk).flatten(-3), _engine_layout(b_pk).flatten(-3)
    site_shape = b_pk.shape[-3:]
    d = _over_sites(lambda p, sl: _bilinear(_at(a_flat, p, sl, cdt), _at(b_flat, p, sl, cdt)),
                    (4, 4), site_shape, b_pk.device, cdt)
    d = d.movedim(-2, 0).reshape(2, 4, 4, *site_shape)
    return torch.stack([d.real, d.imag])


def _one_end_mats(gammas: dict, kappa: float, mu: float) -> dict:
    """4 i kappa mu O g5 for every O (g5 diagonal, multiplied from the right)."""
    g5 = torch.tensor(G5_DIAG, dtype=torch.complex128)
    return {name: 4j * kappa * mu * torch.as_tensor(g).to(torch.complex128) * g5[None, :]
            for name, g in gammas.items()}


def loop_plain_pk(eta_pk: torch.Tensor, psi_pk: torch.Tensor, gammas: dict, lat: Lattice,
                  momenta, fft: bool | None = None) -> dict:
    """The single-noise estimate sum_x e^{-i q.x} eta^dag O psi."""
    return _loop_all(eta_pk, psi_pk, gammas, lat, momenta, fft)


def loop_one_end_pk(psi_pk: torch.Tensor, gammas: dict, lat: Lattice, momenta, kappa: float,
                    mu: float, fft: bool | None = None) -> dict:
    """The one-end d - u estimate 4 i kappa mu psi^dag O g5 psi, with psi =
    (M_d^dag)^{-1} eta = g5 M_u^{-1} g5 eta."""
    return _loop_all(psi_pk, psi_pk, _one_end_mats(gammas, kappa, mu), lat, momenta, fft)


def cov_deriv_sym_spinor_pk(u_pk: torch.Tensor, psi_pk: torch.Tensor, nu: int,
                            lat: Lattice) -> torch.Tensor:
    """The symmetric covariant derivative of a packed spinor [2(par), 2(ri),
    4, 3, T, Z, S]: threep_dev.cov_deriv_sym_pk on the spinor as a
    propagator with degenerate source axes."""
    f = psi_pk.transpose(0, 1)[:, :, :, :, None, None]
    return cov_deriv_sym_pk(u_pk, f, nu, lat)[:, :, :, :, 0, 0].transpose(0, 1)


def loop_plain_der_pk(eta_pk: torch.Tensor, psi_pk: torch.Tensor, u_pk: torch.Tensor,
                      gammas: dict, nu: int, lat: Lattice, momenta,
                      fft: bool | None = None) -> dict:
    """The one-derivative loop eta^dag O (D_nu psi)."""
    d = _loop_all(eta_pk, psi_pk, gammas, lat, momenta, fft, u_pk, (int(nu),))
    return {name: d[f"{name}_D{int(nu)}"] for name in gammas}


def loop_one_end_der_pk(psi_pk: torch.Tensor, u_pk: torch.Tensor, gammas: dict, nu: int,
                        lat: Lattice, momenta, kappa: float, mu: float,
                        fft: bool | None = None) -> dict:
    """The one-end one-derivative loop 4 i kappa mu psi^dag O g5 (D_nu psi)."""
    d = _loop_all(psi_pk, psi_pk, _one_end_mats(gammas, kappa, mu), lat, momenta, fft, u_pk,
                  (int(nu),))
    return {name: d[f"{name}_D{int(nu)}"] for name in gammas}


def loops_stochastic_pk(solve_fn_pk: Callable, noises: Iterable[torch.Tensor], gammas: dict,
                        lat: Lattice, momenta, *, one_end: bool = False, kappa: float = 0.0,
                        mu: float = 0.0, solve_fn_dag_pk: Callable | None = None) -> dict:
    """The single-noise estimators averaged over ``noises``: plain with
    solve_fn_pk(b) = M^{-1} b, or one-end with solve_fn_dag_pk(b) =
    (M_d^dag)^{-1} b."""
    acc, n = None, 0
    for eta in noises:
        if one_end:
            est = loop_one_end_pk(solve_fn_dag_pk(eta), gammas, lat, momenta, kappa, mu)
        else:
            est = loop_plain_pk(eta, solve_fn_pk(eta), gammas, lat, momenta)
        acc, n = _acc(acc, est), n + 1
    return {k: v / n for k, v in acc.items()}


def _acc(tot, est):
    if est is None:
        return tot
    if tot is None:
        return dict(est)
    return {k: tot[k] + est[k] for k in tot}


def make_deflate_pk(evecs: torch.Tensor, lmesh=None) -> Callable:
    """The deflation projector Q = 1 - V V^dag on packed spinors (one, or a
    batch [m, ...]); evecs: an orthonormal stack [n, 2(par), 2(ri), 4, 3, T,
    Z, S].  The coefficients and the subtraction run in complex128.  On a
    mesh evecs and the spinors are this rank's blocks, and the coefficients
    are summed over the ranks before the subtraction."""
    n = evecs.shape[0]
    V = torch.complex(evecs[:, :, 0].double(), evecs[:, :, 1].double()).reshape(n, -1)

    def deflate(eta_pk: torch.Tensor) -> torch.Tensor:
        e = torch.complex(eta_pk[..., 0, :, :, :, :, :].double(),
                          eta_pk[..., 1, :, :, :, :, :].double())
        shape = e.shape
        e = e.reshape(-1, V.shape[1])                       # [m, N]
        c = mesh_sum(e @ V.conj().T, lmesh)                # <v_i, e> = [m, n]
        d = (e - c @ V).reshape(shape)
        return torch.stack([d.real, d.imag], dim=-6).to(eta_pk.dtype)

    return deflate


def _oneend_single_pk(psis, gammas, lat, momenta, kappa, mu, u_pk, derivs, timer=None,
                      lmesh=None):
    """(est, der) of psi = (M_d^dag)^{-1} sources, summed over the rows of a
    batch: the ultra-local one-end loops and, with ``derivs``, the
    one-derivative ones in all four directions.  timer(stage), when given,
    is a context around each: "loops", "derivatives"."""
    timer = timer or (lambda name: contextlib.nullcontext())
    mats = _one_end_mats(gammas, kappa, mu)
    with timer("loops"):
        est = _loop_all(psis, psis, mats, lat, momenta, lmesh=lmesh)
    der = None
    if derivs:
        with timer("derivatives"):
            der = _loop_all(psis, psis, mats, lat, momenta, None, u_pk, (0, 1, 2, 3), lmesh)
    return est, der


def oneend_estimate_for_noise_pk(eta_pk: torch.Tensor, solve_ddag_batch: Callable,
                                 gammas: dict, lat: Lattice, momenta, kappa: float,
                                 mu: float, *, u_pk=None, derivs: bool = False,
                                 dilute_t: int = 1, dilute_sc: bool = False,
                                 deflate_fn: Callable | None = None,
                                 timer: Callable | None = None, lmesh=None):
    """The one-end (and one-derivative) estimate of one packed noise: its
    dilution partition, deflated by deflate_fn when given, solved as one
    batch, the per-class estimates summed (timer: see _oneend_single_pk;
    on a mesh eta_pk is this rank's block)."""
    srcs = diluted_sources_pk(eta_pk, dilute_t, dilute_sc, lmesh)
    if deflate_fn is not None:
        srcs = deflate_fn(srcs)
    return _oneend_single_pk(solve_ddag_batch(srcs), gammas, lat, momenta, kappa, mu, u_pk,
                             derivs, timer, lmesh)


def stochastic_oneend_pk(noises: Iterable[torch.Tensor], solve_ddag_batch: Callable,
                         gammas: dict, lat: Lattice, momenta, kappa: float, mu: float, *,
                         u_pk=None, derivs: bool = False, dilute_t: int = 1,
                         dilute_sc: bool = False, deflate_fn: Callable | None = None,
                         timer: Callable | None = None, lmesh=None):
    """The stochastic one-end estimator of the loop program: for each noise
    its dilution partition, deflated, solved as one batch, the classes
    summed; averaged over the noises.  solve_ddag_batch(b [n, 2(par),
    2(ri), ...]) returns (M_d^dag)^{-1} b = g5 M_u^{-1} g5 b per row (on a
    mesh of this rank's blocks).  Returns (est, der or None)."""
    acc = acc_der = None
    n = 0
    for eta in noises:
        est, der = oneend_estimate_for_noise_pk(
            eta, solve_ddag_batch, gammas, lat, momenta, kappa, mu, u_pk=u_pk, derivs=derivs,
            dilute_t=dilute_t, dilute_sc=dilute_sc, deflate_fn=deflate_fn, timer=timer,
            lmesh=lmesh)
        acc, acc_der, n = _acc(acc, est), _acc(acc_der, der), n + 1
    avg = {k: v / n for k, v in acc.items()}
    return avg, ({k: v / n for k, v in acc_der.items()} if acc_der is not None else None)


def oneend_lowmode_exact_pk(evecs: torch.Tensor, solve_ddag_batch: Callable, gammas: dict,
                            lat: Lattice, momenta, kappa: float, mu: float, *, u_pk=None,
                            derivs: bool = False, timer: Callable | None = None, lmesh=None):
    """The exact low-mode part of the one-end estimator for an orthonormal
    basis {v_i} [n, 2(par), 2(ri), ...]: with w_i = (M_d^dag)^{-1} v_i,

        sum_i 4 i kappa mu sum_x e^{-i q.x} w_i^dag(x) O g5 w_i(x),

    the piece that deflating the noise with Q = 1 - V V^dag removes, so the
    deflated stochastic part and this sum to the unbiased loop for any
    orthonormal basis (on a mesh this rank's blocks).  Returns (est, der or
    None), a sum over the modes."""
    return _oneend_single_pk(solve_ddag_batch(evecs), gammas, lat, momenta, kappa, mu, u_pk,
                             derivs, timer, lmesh)


def loop_lowmode_pk(evals, evecs_pk: torch.Tensor, apply_dag_pk: Callable, gammas: dict,
                    lat: Lattice, momenta) -> dict:
    """The exact low-mode loop part from eigenpairs (lambda_i, v_i) of M
    M^dag: S(x, x) ~ sum_i (1/lambda_i) (M^dag v_i)(x) v_i(x)^dag."""
    w = torch.stack([apply_dag_pk(v) / float(lam) for lam, v in zip(evals, evecs_pk)])
    return _loop_all(evecs_pk, w, gammas, lat, momenta)
