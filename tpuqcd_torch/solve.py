"""Certified twisted-mass solve: sloppy Krylov iteration inside an f64
defect-correction loop.

Counterpart of ``tpuqcd/solve.py:30-166, :251, :445``.  The iteration operator
runs in the sloppy dtype on a reconstruct-12 gauge copy; true residuals,
the even-odd preparation, the reconstruction and the final full-system
residual use the float64 operator on the full 18-real gauge.  On a CUDA
device every one of them goes through the Dslash kernel.

    lat = Lattice((16, 16, 16, 32))
    res = solve_tm(u_pk, b_pk, lat, kappa=0.115, mu=0.05, tol=1e-10)
    x = res.x          # [2(par), 2(ri), 4, 3, T, Z, S] float64
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .lattice import Lattice
from .operators import PackedTMOperatorPC
from .solvers.bicgstab import bicgstab
from .solvers.cg import _cg_cycle
from .solvers.reductions import norm2


class SolveResult(NamedTuple):
    x: torch.Tensor        # [2(par), 2(ri), 4, 3, T, Z, S] float64
    relres: float          # certified |bhat - Mhat x_e| / |bhat|
    iters: int             # sloppy matvec count
    refinements: int


def _refined_solve(pc, u_s, u_hp, bhat, *, tol, maxiter, inner_tol, solver, x0=None):
    """Defect correction: each pass solves Mhat dx = r in the sloppy dtype
    (pc on the sloppy gauge u_s) to inner_tol and adds dx to the f64
    iterate; stops when the f64 true residual (pc on u_hp) meets tol,
    after maxiter sloppy matvecs, or 40 passes."""
    bsq = norm2(bhat).item()
    tol2 = tol * tol * bsq
    sdt = u_s.dtype

    def inner(r_s, budget):
        if solver == "bicgstab":
            res = bicgstab(lambda v: pc.apply(u_s, v), r_s, tol=inner_tol,
                           maxiter=budget)
            return res.x, res.iters
        bn = pc.apply_dagger(u_s, r_s)
        dx, _, k = _cg_cycle(lambda v: pc.normal(u_s, v), bn, torch.zeros_like(bn),
                             inner_tol * inner_tol * norm2(bn).item(), budget)
        return dx, 2 * k + 1

    if x0 is None:
        x = torch.zeros_like(bhat)
        rsq = 4.0 * bsq
    else:
        x = x0.to(bhat.dtype).clone()
        rsq = norm2(bhat - pc.apply(u_hp, x)).item()
    k, nref = 0, 0
    while rsq > tol2 and k < maxiter and nref < 40:
        r = bhat - pc.apply(u_hp, x)
        dx, used = inner(r.to(sdt), maxiter - k)
        x += dx.to(x.dtype)
        rsq = norm2(bhat - pc.apply(u_hp, x)).item()
        k += used + 2
        nref += 1
    return x, (rsq / max(bsq, 1e-300)) ** 0.5, k, nref


def solve_tm(u_pk: torch.Tensor, b_pk: torch.Tensor, lat: Lattice, *, kappa: float,
             mu: float, flavor: int = 1, tol: float = 1e-10, maxiter: int = 5000,
             inner_tol: float = 1e-5, solver: str = "cg",
             sloppy_dtype: torch.dtype = torch.float32, t_boundary: int = -1,
             x0_e: torch.Tensor | None = None) -> SolveResult:
    """Solve the two-parity twisted-mass system M x = b.

    u_pk: packed gauge [4, 2, 3, 3, 2, T, Z, S] (any float dtype);
    b_pk: packed source [2(par), 2(ri), 4, 3, T, Z, S].
    solver: "cg" (normal equations) or "bicgstab" (on Mhat directly).
    t_boundary: the T-boundary phase folded into u_pk (-1 antiperiodic,
    +1 periodic); the sloppy reconstruct-12 operator restores it.
    tol is on the even-odd preconditioned system; x0_e warm-starts the
    even-parity iterate.
    """
    if solver not in ("cg", "bicgstab"):
        raise ValueError(f"solver must be cg or bicgstab, got {solver!r}")
    pc = PackedTMOperatorPC(lat, kappa=kappa, mu=mu, flavor=flavor, t_boundary=t_boundary)
    # one contiguous reconstruct-12 copy per solve: the kernel rebuilds row 2
    u_s = u_pk[:, :, :2].to(sloppy_dtype).contiguous()
    u_hp = u_pk.to(torch.float64).contiguous()
    b_hp = b_pk.to(torch.float64)
    bhat = pc.prepare(u_hp, b_hp)
    x_e, relres, iters, nref = _refined_solve(
        pc, u_s, u_hp, bhat, tol=tol, maxiter=maxiter, inner_tol=inner_tol,
        solver=solver, x0=x0_e)
    return SolveResult(x=pc.reconstruct(u_hp, x_e, b_hp), relres=relres, iters=iters,
                       refinements=nref)


def full_system_relres(u_pk: torch.Tensor, b_pk: torch.Tensor, x_pk: torch.Tensor,
                       lat: Lattice, *, kappa: float, mu: float, flavor: int = 1) -> float:
    """Certified float64 |b - M x| / |b| of the two-parity system, fields
    [2(par), 2(ri), 4, 3, T, Z, S] and the 18-real gauge."""
    pc = PackedTMOperatorPC(lat, kappa=kappa, mu=mu, flavor=flavor)
    b64 = b_pk.to(torch.float64)
    r = b64 - pc.apply_full(u_pk.to(torch.float64).contiguous(), x_pk.to(torch.float64))
    return (norm2(r).item() / max(norm2(b64).item(), 1e-300)) ** 0.5


def solve_tm_mg(mg, b_pk: torch.Tensor, *, tol: float = 1e-10,
                inner_tol: float | None = None, maxiter: int = 200,
                verbose: bool = False) -> SolveResult:
    """MG-preconditioned solve of the two-parity system M x = b on a
    mg.dsolve.DeviceMG hierarchy (tpuqcd/solve.py:445).

    b_pk: packed source [2(par), 2(ri), 4, 3, T, Z, S]; the source is
    rounded to float32, as in tpuqcd, and the hierarchy's float64
    defect correction certifies |b - M x| / |b|.  Returns x in the same
    parity-first layout, float64.
    """
    res = mg.solve_certified(b_pk.to(torch.float32).transpose(0, 1).contiguous(), tol=tol,
                             inner_tol=inner_tol, maxiter=maxiter, verbose=verbose)
    return SolveResult(x=res.x.transpose(0, 1).contiguous(), relres=res.relres,
                       iters=res.iters, refinements=res.refinements)
