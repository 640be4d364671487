"""Krylov solvers on packed-real fields with a leading re/im axis.

Counterpart of ``tpuqcd/solvers/krylov_pk.py``: the MR smoother, fixed
CG and BiCGStab for the MG null-vector setup, and flexible GCR for the
coarsest level and the outer MG-preconditioned solve.  Every scalar of a
cycle is a 0-d tensor on the field's device: the fixed-iteration loops,
the smoother and a GCR restart cycle never read a value back to the host
(where tpuqcd traces lax loops, these are Python loops over device
work).  Only ``gcr_pk`` reads the residual norm, once per restart cycle.

The operator is any function ``A(x) -> Ax`` on one packed field.  The
smoother and the GCR cycle also take a batch [N, 2(ri), ...] with
``cols=True`` (utils/pkalg): one scalar per column, the operator on the
whole batch.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils import pkalg as pk


def mr_smoother_pk(matvec: Callable, b: torch.Tensor, iters: int = 4,
                   omega: float = 0.85, cols: bool = False) -> torch.Tensor:
    """Minimal-residual relaxation from x0 = 0."""
    x, r = torch.zeros_like(b), b
    for _ in range(iters):
        ar = matvec(r)
        nr, ni = pk.cdot(ar, r, cols=cols)
        den = torch.clamp(pk.norm2(ar, cols=cols), min=1e-30)
        al_r, al_i = omega * nr / den, omega * ni / den
        x, r = pk.caxpy(al_r, al_i, r, x, cols), pk.csub(al_r, al_i, ar, r, cols)
    return x


def cg_fixed_pk(matvec: Callable, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Fixed-iteration CG from x0 = 0 on a Hermitian positive definite
    (normal) operator: the CG-NE null-vector setup, inverse iteration on
    M^dag M toward the smallest singular vectors."""
    x, r, p, rsq = torch.zeros_like(b), b, b, pk.norm2(b)
    for _ in range(iters):
        ap = matvec(p)
        al = rsq / torch.clamp(pk.cdot(p, ap)[0], min=1e-30)
        x = pk.caxpy(al, 0.0 * al, p, x)
        r = pk.csub(al, 0.0 * al, ap, r)
        rsq_new = pk.norm2(r)
        beta = rsq_new / torch.clamp(rsq, min=1e-30)
        p = pk.caxpy(beta, 0.0 * beta, p, r)
        rsq = rsq_new
    return x


def _gcr_cycle(matvec: Callable, precond: Callable, x: torch.Tensor, r: torch.Tensor,
               m: int, cols: bool = False, basis_dtype: torch.dtype | None = None):
    """One flexible-GCR restart cycle of m iterations with modified
    Gram-Schmidt against the stored (Z, V) directions.

    basis_dtype (default x's) stores Z and V: bfloat16 halves the solver's
    largest workspace, 2 m fields (tpuqcd's gcr_dtype).  The arithmetic
    stays in x's dtype: Gram-Schmidt widens one stored direction at a
    time, and the iteration's own update takes the normalised z and v
    before they are rounded for storage (tpuqcd/solvers/krylov_pk.py:84-101).
    No direction is held past its use: the preconditioner of the next
    iteration runs beside Z, V, x and r only (mg/dsolve.DeviceMG.batch_buffers)."""
    bdt = x.dtype if basis_dtype is None else basis_dtype
    Z = torch.empty((m, *x.shape), dtype=bdt, device=x.device)
    V = torch.empty_like(Z)
    for i in range(m):
        z = precond(r)
        v = matvec(z)
        for j in range(i):
            vj = V[j].to(v.dtype)
            br, bi = pk.cdot(vj, v, cols=cols)
            z = pk.csub(br, bi, Z[j].to(z.dtype), z, cols)
            v = pk.csub(br, bi, vj, v, cols)
            del vj
        inv = torch.rsqrt(torch.clamp(pk.norm2(v, cols=cols), min=1e-30))
        z, v = inv * z, inv * v
        Z[i], V[i] = z, v
        ar, ai = pk.cdot(v, r, cols=cols)
        x = pk.caxpy(ar, ai, z, x, cols)
        r = pk.csub(ar, ai, v, r, cols)
        del z, v                    # stored: not held through the next preconditioning
    return x, r


def gcr_fixed_pk(matvec: Callable, b: torch.Tensor, *, iters: int, restart: int = 8,
                 precond: Callable | None = None, cols: bool = False) -> torch.Tensor:
    """Fixed-work flexible GCR from x0 = 0, no convergence exit: the
    coarsest-level solve of the V-cycle."""
    if precond is None:
        def precond(r):
            return r
    x, r = torch.zeros_like(b), b
    done = 0
    while done < iters:
        m = min(restart, iters - done)
        x, r = _gcr_cycle(matvec, precond, x, r, m, cols)
        done += m
        if done < iters:
            r = pk.caxpy(-1.0, 0.0, matvec(x), b, cols)   # true residual
    return x


class GCRResultPk(NamedTuple):
    x: torch.Tensor
    relres: float
    iters: int
    converged: bool


def gcr_pk(matvec: Callable, b: torch.Tensor, *, precond: Callable | None = None,
           tol: float = 1e-8, maxiter: int = 200, restart: int = 8,
           x0: torch.Tensor | None = None) -> GCRResultPk:
    """Right-preconditioned flexible GCR to |r|/|b| <= tol; the true
    residual is recomputed, and read by the host, once per cycle."""
    if precond is None:
        def precond(r):
            return r
    x = torch.zeros_like(b) if x0 is None else x0
    bsq = pk.norm2(b).item()
    tol2 = tol * tol * bsq
    r = pk.caxpy(-1.0, 0.0, matvec(x), b)
    rsq = pk.norm2(r).item()
    total = 0
    while total < maxiter and rsq > tol2:
        x, _ = _gcr_cycle(matvec, precond, x, r, restart)
        r = pk.caxpy(-1.0, 0.0, matvec(x), b)
        rsq = pk.norm2(r).item()
        total += restart
    relres = (rsq / max(bsq, 1e-300)) ** 0.5
    return GCRResultPk(x=x, relres=relres, iters=total, converged=rsq <= tol2)


def bicgstab_fixed_pk(matvec: Callable, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Fixed-iteration BiCGStab from x0 = 0 (rhat = b): the BiCGStab
    null-vector setup."""
    x, r = torch.zeros_like(b), b
    p, v = torch.zeros_like(b), torch.zeros_like(b)
    one = torch.ones((), dtype=torch.float32, device=b.device)
    rho, alpha, omega = (one, 0 * one), (one, 0 * one), (one, 0 * one)
    for _ in range(iters):
        rho_new = pk.cdot(b, r)
        beta = pk.smul(pk.sdiv(rho_new, rho), pk.sdiv(alpha, omega))
        t1 = pk.csub(omega[0], omega[1], v, p)
        p = pk.caxpy(beta[0], beta[1], t1, r)
        v = matvec(p)
        alpha = pk.sdiv(rho_new, pk.cdot(b, v))
        s = pk.csub(alpha[0], alpha[1], v, r)
        t = matvec(s)
        om_den = torch.clamp(pk.norm2(t), min=1e-30)
        tsr, tsi = pk.cdot(t, s)
        omega = (tsr / om_den, tsi / om_den)
        x = pk.caxpy(alpha[0], alpha[1], p, x)
        x = pk.caxpy(omega[0], omega[1], s, x)
        r = pk.csub(omega[0], omega[1], t, s)
        rho = rho_new
    return x
