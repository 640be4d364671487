"""BiCGStab on packed spinor fields.

Counterpart of ``tpuqcd/solvers/bicgstab.py``: solves the non-Hermitian
Mhat x = b directly, with the complex scalars carried as (re, im) pairs
of float64 0-d tensors.  One ``.item()`` per step reads the residual
norm and the breakdown test together.  ``bicgstab_cols`` is the same
iteration on a batch [N, 2(ri), ...] with the meaning of ``jax.vmap``
over it: per-column scalars, and a column that has met its condition
stays as it is while the others go on.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils.packed import caxpy, cdot_packed
from .reductions import norm2, norm2_cols


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


def _cdot_cols(x_pk: torch.Tensor, y_pk: torch.Tensor):
    """<x_i, y_i> of packed batches [N, 2(ri), ...] -> (re, im) float64 [N],
    each column reduced as cdot_packed reduces it alone."""
    pairs = [cdot_packed(a, b) for a, b in zip(x_pk.unbind(0), y_pk.unbind(0))]
    return torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])


def _caxpy_cols(ar: torch.Tensor, ai: torch.Tensor, x_pk: torch.Tensor,
                y_pk: torch.Tensor) -> torch.Tensor:
    """caxpy with one complex scalar per column of a batch [N, 2(ri), ...]."""
    shape = (-1, *([1] * (x_pk.ndim - 2)))
    a_r, a_i = ar.to(x_pk.dtype).reshape(shape), ai.to(x_pk.dtype).reshape(shape)
    xr, xi = x_pk[:, 0], x_pk[:, 1]
    return y_pk + torch.stack([a_r * xr - a_i * xi, a_r * xi + a_i * xr], dim=1)


def bicgstab_cols(matvec: Callable, b: torch.Tensor, tol: float, budget: torch.Tensor,
                  live: torch.Tensor):
    """bicgstab from x0 = 0 on every column of a packed batch [N, 2(ri),
    ...] at once: column i steps while |r_i|^2 > tol^2 |b_i|^2, k_i <
    budget[i] and no breakdown, and is frozen afterwards; columns not in
    ``live`` take no step.  ``matvec`` acts on the whole batch.  Returns
    (x, matvec counts [N])."""
    n = b.shape[0]
    tol2 = tol * tol * norm2_cols(b)
    x = torch.zeros_like(b)
    r, rhat, p = b.clone(), b, b
    v = torch.zeros_like(b)
    one = torch.ones(n, dtype=torch.float64, device=b.device)
    zero = torch.zeros_like(one)
    rho_r, rho_i, alpha_r, alpha_i, omega_r, omega_i = one, zero, one, zero, one, zero
    k = torch.zeros_like(budget)
    live = live & (norm2_cols(r) > tol2) & (k < budget)
    while live.any().item():
        sel = live.reshape(-1, *([1] * (b.ndim - 1)))

        def keep(new, old):
            return torch.where(sel if new.ndim > 1 else live, new, old)

        rho_new_r, rho_new_i = _cdot_cols(rhat, r)
        beta_r, beta_i = _cmul(*_cdiv(rho_new_r, rho_new_i, rho_r, rho_i),
                               *_cdiv(alpha_r, alpha_i, omega_r, omega_i))
        p_new = _caxpy_cols(beta_r, beta_i, _caxpy_cols(-omega_r, -omega_i, v, p), r)
        v_new = matvec(p_new)
        den_r, den_i = _cdot_cols(rhat, v_new)
        al_r, al_i = _cdiv(rho_new_r, rho_new_i, den_r, den_i)
        s = _caxpy_cols(-al_r, -al_i, v_new, r)
        t = matvec(s)
        ts_r, ts_i = _cdot_cols(t, s)
        tt = norm2_cols(t)
        om_r, om_i = ts_r / tt, ts_i / tt
        x = keep(_caxpy_cols(om_r, om_i, s, _caxpy_cols(al_r, al_i, p_new, x)), x)
        r = keep(_caxpy_cols(-om_r, -om_i, t, s), r)
        p, v = keep(p_new, p), keep(v_new, v)
        rho_r, rho_i = keep(rho_new_r, rho_r), keep(rho_new_i, rho_i)
        alpha_r, alpha_i = keep(al_r, alpha_r), keep(al_i, alpha_i)
        omega_r, omega_i = keep(om_r, omega_r), keep(om_i, omega_i)
        k = k + 2 * live
        broke = (rho_new_r ** 2 + rho_new_i ** 2 < 1e-60) | (tt < 1e-60)
        live = live & (norm2_cols(r) > tol2) & (k < budget) & ~broke
    return x, k
