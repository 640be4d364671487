"""Conjugate gradient, and CG on the normal equations.

Counterpart of ``tpuqcd/solvers/cg.py``.  The iteration is a host loop:
each step reads the new residual norm with one ``.item()`` (where tpuqcd
runs ``lax.while_loop`` on the device).  Step sizes stay 0-d tensors on
the device, rounded to float32 as in tpuqcd.  x, r and p are updated in
place, which saves three field allocations per step.

The operator is any function ``A(x) -> Ax`` on one tensor.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .reductions import norm2, redot


class CGResult(NamedTuple):
    x: torch.Tensor
    relres: float          # final true |r| / |b|
    iters: int             # matvec count
    converged: bool


def _scalar(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """f64 step size -> float32 -> the field dtype (tpuqcd cg.py:51, :55)."""
    return s.to(torch.float32).to(like.dtype)


def _cg_cycle(matvec: Callable, b: torch.Tensor, x0: torch.Tensor, tol2_abs: float,
              maxiter: int):
    """Plain CG until the iterated |r|^2 <= tol2_abs or maxiter steps.

    Returns (x, rsq, k).  x0 is updated in place."""
    x = x0
    r = b - matvec(x)
    p = r.clone()
    rsq = norm2(r)
    rsq_host = rsq.item()
    k = 0
    while rsq_host > tol2_abs and k < maxiter:
        ap = matvec(p)
        pap = redot(p, ap)
        alpha = torch.where(pap > 0, rsq / pap, torch.zeros_like(pap))
        a = _scalar(alpha, x)
        x.addcmul_(p, a)
        r.addcmul_(ap, a, value=-1)
        rsq_new = norm2(r)
        p.mul_(_scalar(rsq_new / rsq, x)).add_(r)
        rsq = rsq_new
        rsq_host = rsq.item()
        k += 1
    return x, rsq_host, k


def cg(matvec: Callable, b: torch.Tensor, *, tol: float = 1e-10, maxiter: int = 1000,
       x0: torch.Tensor | None = None, restart_every: int = 250) -> CGResult:
    """Solve A x = b (A Hermitian positive definite) to |r|/|b| <= tol,
    by cycles of at most ``restart_every`` steps with the true residual
    recomputed between cycles (defect correction)."""
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    bsq = norm2(b).item()
    tol2_abs = tol * tol * bsq
    total, rsq = 0, 4.0 * bsq
    while rsq > tol2_abs and total < maxiter:
        dx, _, k = _cg_cycle(matvec, b - matvec(x), torch.zeros_like(b), tol2_abs,
                             restart_every)
        x += dx
        rsq = norm2(b - matvec(x)).item()
        total += k + 2
    relres = (rsq / max(bsq, 1e-300)) ** 0.5
    return CGResult(x=x, relres=relres, iters=total, converged=rsq <= tol2_abs)


def cg_normal(apply_fn: Callable, apply_dagger_fn: Callable, b: torch.Tensor,
              **kw) -> CGResult:
    """Solve M x = b via M^dag M x = M^dag b; relres is of M x = b."""
    res = cg(lambda x: apply_dagger_fn(apply_fn(x)), apply_dagger_fn(b), **kw)
    r = b - apply_fn(res.x)
    relres = (norm2(r).item() / max(norm2(b).item(), 1e-300)) ** 0.5
    return CGResult(x=res.x, relres=relres, iters=res.iters, converged=res.converged)
