"""Multi-shift CG: solve (A + sigma_i) x_i = b for all shifts from one
Krylov space.

Counterpart of ``tpuqcd/solvers/multishift.py:36-93``.  Residual-polynomial
form: CG residuals are r_k = P_k(A) b with P_0 = 1 and

    P_{k+1}(l) = (g_k - a_k l) P_k(l) - (g_k - 1) P_{k-1}(l),
    g_k = 1 + b_{k-1} a_k / a_{k-1};

shifted residuals stay collinear, r_k^s = r_k / pi_k with pi_k = P_k(-s):

    pi_{k+1} = (g_k + a_k s) pi_k - (g_k - 1) pi_{k-1},
    a_k^s = a_k pi_k / pi_{k+1},      b_k^s = b_k (pi_k / pi_{k+1})^2,
    p_{k+1}^s = r_{k+1} / pi_{k+1} + b_k^s p_k^s.

The seed system is the smallest shift, absorbed into the matvec, so every
other shifted system converges at least as fast.  The fields keep b's
dtype; every scalar, the per-shift ones too, is a float64 tensor on the
field's device, rounded to float32 where it scales a field, as in
tpuqcd.  The host reads one value per iteration, the seed residual for
the stop test.  Reductions sum over the ranks inside
``solvers.reductions.over``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .reductions import norm2, redot


class MultiShiftResult(NamedTuple):
    xs: torch.Tensor       # [n_shift, *field], b's dtype
    relres: torch.Tensor   # [n_shift] float64, the iterated shifted residuals
    iters: int


def _f32(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """float64 scalars -> float32 -> the field dtype (tpuqcd's rounding)."""
    return s.to(torch.float32).to(like.dtype)


def multishift_cg(matvec: Callable, b: torch.Tensor, shifts, *, tol: float = 1e-8,
                  maxiter: int = 1000) -> MultiShiftResult:
    """A Hermitian positive definite; shifts ascending (the seed is
    shifts[0]).  Stops when the seed's iterated |r| <= tol |b| or after
    maxiter steps."""
    dev = b.device
    shifts = torch.as_tensor(shifts, dtype=torch.float64, device=dev)
    ns = shifts.shape[0]
    rel = shifts - shifts[0]
    sigma0 = _f32(shifts[0], b)

    def mv(x):
        return matvec(x) + sigma0 * x

    bsq = norm2(b)
    tol2 = tol * tol * bsq.item()
    bshape = (ns, *([1] * b.ndim))

    def bc(v):     # per-shift scalars broadcast over the field
        return _f32(v, b).reshape(bshape)

    r, p = b.clone(), b.clone()
    rsq, rsq_host = bsq, bsq.item()
    xs = torch.zeros((ns, *b.shape), dtype=b.dtype, device=dev)
    ps = b.expand(ns, *b.shape).clone()
    one = torch.ones((), dtype=torch.float64, device=dev)
    pi_k, pi_km1 = torch.ones(ns, dtype=torch.float64, device=dev), torch.ones_like(rel)
    alpha_km1, beta_km1 = one, torch.zeros_like(one)
    k = 0
    while rsq_host > tol2 and k < maxiter:
        ap = mv(p)
        alpha = rsq / redot(p, ap)
        r.addcmul_(ap, _f32(alpha, b), value=-1)
        rsq_new = norm2(r)
        beta = rsq_new / rsq
        gamma = 1.0 + beta_km1 * alpha / alpha_km1
        pi_kp1 = (gamma + alpha * rel) * pi_k - (gamma - 1.0) * pi_km1
        ratio = pi_k / pi_kp1
        xs.addcmul_(ps, bc(alpha * ratio))
        ps.mul_(bc(beta * ratio * ratio)).addcmul_(r.expand_as(ps), bc(1.0 / pi_kp1))
        p.mul_(_f32(beta, b)).add_(r)
        pi_km1, pi_k = pi_k, pi_kp1
        alpha_km1, beta_km1, rsq = alpha, beta, rsq_new
        rsq_host = rsq.item()
        k += 1
    relres = torch.sqrt(rsq / torch.clamp(bsq, min=1e-300)) / pi_k.abs()
    return MultiShiftResult(xs=xs, relres=relres, iters=k)
