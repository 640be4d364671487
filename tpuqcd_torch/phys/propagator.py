"""Quark propagators: 12 spin-colour solves -> the per-site 12x12 tensor.

Counterpart of ``tpuqcd/phys/propagator.py``.  Sources and solutions stay
packed [2(par), 2(ri), 4, 3, T, Z, S] on the run's device, the 12 columns
of a propagator as one batch [12, ...] in source-major order s*3+c; the
assembled propagator is the device layout of phys/contract_dev.py,
[2(ri), 2(par), 4(snk s), 3(snk c), 4(src s), 3(src c), T, Z, S].
"""
from __future__ import annotations

import torch

from ..fields import eo_to_full, full_to_eo
from ..lattice import Lattice
from ..ops.layout import spinor_from_device, spinor_to_device
from ..utils.packed import pack_spinor, unpack_spinor
from .smear import gaussian_smear_pk


def full_to_packed(psi_full: torch.Tensor, lat: Lattice,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """complex [T, Z, Y, X, 4, 3] -> packed [2(par), 2(ri), 4, 3, T, Z, S]."""
    return pack_spinor(spinor_to_device(full_to_eo(psi_full, lat), lat), dtype)


def packed_to_full(psi_pk: torch.Tensor, lat: Lattice) -> torch.Tensor:
    """packed [2(par), 2(ri), 4, 3, T, Z, S] -> complex [T, Z, Y, X, 4, 3]."""
    return eo_to_full(spinor_from_device(unpack_spinor(psi_pk), lat), lat)


def point_sources(lat: Lattice, pos: tuple[int, int, int, int],
                  dtype: torch.dtype = torch.complex64, device=None, lmesh=None) -> torch.Tensor:
    """12 delta sources at pos = (t, z, y, x): [4(src s), 3(src c), T, Z, Y,
    X, 4, 3]; on a mesh (``lmesh``) this rank's block of them, zero but on
    the rank that holds pos."""
    t, z, y, x = pos
    shape = lat.full_shape
    if lmesh is not None:
        shape = lmesh.local_lat.full_shape
        t, z, y = t - lmesh.t_offset, z - lmesh.z_offset, y - lmesh.y_offset
    src = torch.zeros((4, 3, *shape, 4, 3), dtype=dtype, device=device)
    if all(0 <= c < n for c, n in zip((t, z, y), shape)):
        for s in range(4):
            for c in range(3):
                src[s, c, t, z, y, x, s, c] = 1.0
    return src


def packed_sources(sources: torch.Tensor, lat: Lattice,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """12 full-layout sources [4, 3, T, Z, Y, X, 4, 3] -> the packed batch
    [12, 2(par), 2(ri), 4, 3, T, Z, S] in source-major s*3+c order (the
    multi-RHS solver's input); a rank's block with its LatticeMesh.local_lat
    (its even-odd packing is the global one)."""
    flat = sources.reshape(12, *sources.shape[2:])
    return pack_spinor(spinor_to_device(full_to_eo(flat, lat, site_ndim_left=1), lat), dtype)


def smear_sources(u_smear_pk: torch.Tensor, b_pks: torch.Tensor, lat: Lattice,
                  alpha: float, n_steps: int, lmesh=None) -> torch.Tensor:
    """Gaussian-smear a packed batch of sources [12, 2(par), 2(ri), ...] on
    the packed APE-smeared gauge; one batched smearing for all columns
    (tpuqcd smears its 12 full-layout sources one by one,
    phys/propagator.py:60).  On a mesh: this rank's blocks, the links with
    their ghost layer (phys/smear.gaussian_smear_pk)."""
    return gaussian_smear_pk(u_smear_pk, b_pks, lat, alpha, n_steps, lmesh)


def assemble_propagator_pk(cols_pk: torch.Tensor) -> torch.Tensor:
    """12 packed solutions [12, 2(par), 2(ri), 4, 3, T, Z, S] (source-major
    s*3+c order; a tensor or a sequence) -> the packed device propagator
    [2(ri), 2(par), 4(snk s), 3, 4(src s), 3, T, Z, S]."""
    p = cols_pk if torch.is_tensor(cols_pk) else torch.stack(list(cols_pk))
    return p.reshape(4, 3, *p.shape[1:]).permute(3, 2, 4, 5, 0, 1, 6, 7, 8)


def propagator_columns(prop_pk: torch.Tensor) -> torch.Tensor:
    """Inverse of assemble_propagator_pk: -> [12, 2(par), 2(ri), 4, 3, T, Z, S]."""
    cols = prop_pk.permute(4, 5, 1, 0, 2, 3, 6, 7, 8)
    return cols.reshape(12, *cols.shape[2:])


def sink_smear_packed(u_smear_pk: torch.Tensor, x_pk: torch.Tensor, lat: Lattice,
                      alpha: float, n_steps: int) -> torch.Tensor:
    """Gaussian-smear one packed solution [2(par), 2(ri), 4, 3, T, Z, S]."""
    return gaussian_smear_pk(u_smear_pk, x_pk, lat, alpha, n_steps)


def sink_smear_prop_pk(u_smear_pk: torch.Tensor, prop_pk: torch.Tensor, lat: Lattice,
                       alpha: float, n_steps: int, lmesh=None) -> torch.Tensor:
    """Gaussian-smear the sink index of a packed device propagator.
    Smearing is spin-diagonal and acts on (sink colour x space) only, so
    the 12 source columns smear independently, as one batch.  On a mesh:
    this rank's block, the links with their ghost layer."""
    sm = gaussian_smear_pk(u_smear_pk, propagator_columns(prop_pk), lat, alpha, n_steps,
                           lmesh)
    return assemble_propagator_pk(sm)


def sink_smear_timeslice_pk(u_smear_pk: torch.Tensor, prop_pk: torch.Tensor, lat: Lattice,
                            t: int, alpha: float, n_steps: int, lmesh=None) -> torch.Tensor:
    """sink_smear_prop_pk of a packed propagator that is zero off timeslice t
    (a sequential source).  Smearing is spatial, so only t's even-odd pair
    of timeslices (t0 = t - t % 2, t0 + 1) is smeared, as a lattice two
    slices long: a timeslice's even-odd packing depends on t only through
    its parity.  The result is zero off that pair, as the input.  On a
    mesh (``lmesh``; t global) the ranks of t's block smear the pair,
    which lies in one block since blocks start at even t, exchanging faces
    within their z and y rings; every other rank returns its zero block
    without communicating."""
    t0 = int(t) - int(t) % 2
    out = torch.zeros_like(prop_pk)
    if lmesh is not None:
        if not lmesh.holds_t(t):
            return out
        t0 -= lmesh.t_offset
    pair = slice(t0, t0 + 2)
    sub = Lattice((lat.Lx, lat.Ly, lat.Lz, 2))
    out[..., pair, :, :] = sink_smear_prop_pk(u_smear_pk[..., pair, :, :].contiguous(),
                                              prop_pk[..., pair, :, :], sub, alpha, n_steps,
                                              lmesh)
    return out


def compute_propagator(u_pk: torch.Tensor, b_pks: torch.Tensor, lat: Lattice, *,
                       kappa: float, mu: float, flavor: int = 1, tol: float = 1e-8,
                       solver: str = "cg", maxiter: int = 5000, csw: float = 0.0,
                       verbose: bool = False) -> torch.Tensor:
    """Solve M x = b for the 12 packed sources b_pks [12, 2(par), 2(ri), ...]
    as one batched stream (solve.solve_tm_batch) and assemble the packed
    device propagator in float32."""
    from ..solve import solve_tm_batch
    res = solve_tm_batch(u_pk, b_pks, lat, kappa=kappa, mu=mu, flavor=flavor, tol=tol,
                         solver=solver, maxiter=maxiter, csw=csw)
    if verbose:
        for i in range(12):
            print(f"  prop col ({i // 3},{i % 3}): relres={res.relres[i]:.2e} "
                  f"iters={res.iters[i]}")
    return assemble_propagator_pk(res.x.to(torch.float32))
