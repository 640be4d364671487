"""Conjugate gradient, and CG on the normal equations.

Counterpart of ``tpuqcd/solvers/cg.py``.  The iteration is a host loop:
each step reads the new residual norm with one ``.item()`` (where tpuqcd
runs ``lax.while_loop`` on the device).  Step sizes stay 0-d tensors on
the device, rounded to float32 as in tpuqcd.  x, r and p are updated in
place, which saves three field allocations per step.

The operator is any function ``A(x) -> Ax`` on one tensor.

Batches ``[N, *field]`` come in two meanings, both from tpuqcd:
``_cg_cycle_cols`` is ``jax.vmap`` of ``_cg_cycle`` (a column freezes
once its own condition is false, so each column's iterate and count are
those of its single solve), ``cg_batched`` is tpuqcd's own batched CG
(one common count, inactive columns take zero steps).  Both read the
residuals of the whole batch with one transfer per step; their matvec
acts on the whole batch.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .reductions import norm2, norm2_cols, redot, redot_cols


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


def _cols(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Per-column f64 scalars [N] -> float32 -> the field dtype, shaped
    to broadcast over a batch [N, *field]."""
    return _scalar(s, like).reshape(-1, *([1] * (like.ndim - 1)))


def _cg_cycle_cols(matvec: Callable, b: torch.Tensor, tol2_abs: torch.Tensor,
                   budget: torch.Tensor, live: torch.Tensor):
    """``_cg_cycle`` from x0 = 0 on every column of a batch at once, with
    the meaning of ``jax.vmap`` over it: column i steps while its own
    |r_i|^2 > tol2_abs[i] and k_i < budget[i], then stays as it is while
    the others go on; columns not in ``live`` take no step at all.

    tol2_abs float64 [N], budget int64 [N], live bool [N], all on b's
    device.  Returns (x, rsq [N], k [N])."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rsq = norm2_cols(r)
    k = torch.zeros_like(budget)
    live = live & (rsq > tol2_abs) & (k < budget)
    while live.any().item():
        ap = matvec(p)
        pap = redot_cols(p, ap)
        alpha = torch.where((pap > 0) & live, rsq / pap, torch.zeros_like(pap))
        a = _cols(alpha, x)
        x.addcmul_(p, a)
        r.addcmul_(ap, a, value=-1)
        rsq_new = torch.where(live, norm2_cols(r), rsq)
        # p = r + beta p on the live columns, p as it is on the others
        beta = torch.where(live, rsq_new / rsq, torch.ones_like(rsq))
        p.mul_(_cols(beta, x)).addcmul_(r, _cols(live.to(rsq.dtype), x))
        rsq = rsq_new
        k = k + live
        live = live & (rsq > tol2_abs) & (k < budget)
    return x, rsq, k


def cg_batched(matvec: Callable, b: torch.Tensor, *, tol: float = 1e-6,
               maxiter: int = 1000) -> CGResult:
    """Batched multi-RHS CG (tpuqcd/solvers/cg.py:115): b [N, *field], one
    iteration stream with per-column scalars, until every column meets
    tol.  ``matvec`` acts on the whole batch.  relres is float64 [N] of
    the iterated residuals, iters the common step count."""
    bsq = norm2_cols(b)
    tol2 = tol * tol * bsq
    x = torch.zeros_like(b)
    r = b.clone()
    p = b.clone()
    rsq, k = bsq, 0
    active = rsq > tol2
    while active.any().item() and k < maxiter:
        ap = matvec(p)
        pap = redot_cols(p, ap)
        alpha = torch.where((pap > 0) & active, rsq / pap, torch.zeros_like(pap))
        a = _cols(alpha, x)
        x.addcmul_(p, a)
        r.addcmul_(ap, a, value=-1)
        rsq_new = norm2_cols(r)
        beta = torch.where(active, rsq_new / torch.clamp(rsq, min=1e-300),
                           torch.zeros_like(rsq))
        p.mul_(_cols(beta, x)).add_(r)
        rsq = rsq_new
        active = rsq > tol2
        k += 1
    relres = torch.sqrt(rsq / torch.clamp(bsq, min=1e-300))
    return CGResult(x=x, relres=relres, iters=k, converged=not active.any().item())


def cg_refined(matvec_sloppy: Callable, matvec_hp: Callable, b_hp: torch.Tensor, *,
               tol: float = 1e-10, inner_tol: float = 1e-6, maxiter: int = 2000,
               max_refine: int = 30, sloppy_dtype: torch.dtype = torch.float32) -> CGResult:
    """Mixed-precision CG by defect correction (tpuqcd/solvers/cg.py:174):
    true residuals with the high-precision operator, the error equation
    A dx = r solved by the sloppy operator to inner_tol.  A must be
    Hermitian positive definite."""
    bsq = norm2(b_hp).item()
    tol2_abs = tol * tol * bsq
    x = torch.zeros_like(b_hp)
    rsq, total, n_ref = 4.0 * bsq, 0, 0
    while rsq > tol2_abs and total < maxiter and n_ref < max_refine:
        r_s = (b_hp - matvec_hp(x)).to(sloppy_dtype)
        dx, _, k = _cg_cycle(matvec_sloppy, r_s, torch.zeros_like(r_s),
                             inner_tol * inner_tol * norm2(r_s).item(), maxiter - total)
        x += dx.to(x.dtype)
        rsq = norm2(b_hp - matvec_hp(x)).item()
        total += k + 3
        n_ref += 1
    relres = (rsq / max(bsq, 1e-300)) ** 0.5
    return CGResult(x=x, relres=relres, iters=total, converged=rsq <= tol2_abs)
