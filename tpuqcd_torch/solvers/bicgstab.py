"""BiCGStab on packed spinor fields.

Counterpart of ``tpuqcd/solvers/bicgstab.py``: solves the non-Hermitian
Mhat x = b directly, with the complex scalars carried as (re, im) pairs
of float64 0-d tensors.  One ``.item()`` per step reads the residual
norm and the breakdown test together.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils.packed import caxpy, cdot_packed
from .reductions import norm2


class BiCGStabResult(NamedTuple):
    x: torch.Tensor
    relres: float
    iters: int             # matvec count
    converged: bool


def _cdiv(ar, ai, br, bi):
    d = br * br + bi * bi
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def bicgstab(matvec: Callable, b: torch.Tensor, *, tol: float = 1e-6,
             maxiter: int = 1000, x0: torch.Tensor | None = None) -> BiCGStabResult:
    """Solve M x = b to iterated |r|/|b| <= tol (certify with solve.py's
    refinement loop)."""
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    bsq = norm2(b).item()
    tol2 = tol * tol * bsq
    r = b - matvec(x)
    rhat = r
    p = r
    v = torch.zeros_like(b)
    one = torch.ones((), dtype=torch.float64, device=b.device)
    zero = torch.zeros_like(one)
    rho_r, rho_i, alpha_r, alpha_i, omega_r, omega_i = one, zero, one, zero, one, zero
    rsq, k, breakdown = norm2(r).item(), 0, False
    while rsq > tol2 and k < maxiter and not breakdown:
        rho_new_r, rho_new_i = cdot_packed(rhat, r)
        # beta = (rho_new / rho_old) (alpha / omega)
        beta_r, beta_i = _cmul(*_cdiv(rho_new_r, rho_new_i, rho_r, rho_i),
                               *_cdiv(alpha_r, alpha_i, omega_r, omega_i))
        # p = r + beta (p - omega v)
        p = caxpy(beta_r, beta_i, caxpy(-omega_r, -omega_i, v, p), r)
        v = matvec(p)
        den_r, den_i = cdot_packed(rhat, v)
        alpha_r, alpha_i = _cdiv(rho_new_r, rho_new_i, den_r, den_i)
        s = caxpy(-alpha_r, -alpha_i, v, r)
        t = matvec(s)
        ts_r, ts_i = cdot_packed(t, s)
        tt = norm2(t)
        omega_r, omega_i = ts_r / tt, ts_i / tt
        x = caxpy(omega_r, omega_i, s, caxpy(alpha_r, alpha_i, p, x))
        r = caxpy(-omega_r, -omega_i, t, s)
        rho_r, rho_i = rho_new_r, rho_new_i
        stats = torch.stack([norm2(r), rho_new_r ** 2 + rho_new_i ** 2, tt]).tolist()
        rsq, breakdown = stats[0], stats[1] < 1e-60 or stats[2] < 1e-60
        k += 2
    relres = (rsq / max(bsq, 1e-300)) ** 0.5
    return BiCGStabResult(x=x, relres=relres, iters=k, converged=rsq <= tol2)
