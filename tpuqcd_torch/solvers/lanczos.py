"""Lanczos low modes of a Hermitian positive operator on packed fields.

Counterpart of ``tpuqcd/solvers/lanczos.py:114-270`` (the packed-real
solver of the deflation basis; tpuqcd's complex-layout ``lanczos_lowest``
serves only its host path and is not ported).  A plain Lanczos with full
re-orthogonalisation (two passes a step); eigenvalues are the Rayleigh
quotients on A of the Ritz vectors.

Fields are packed ``v[0] = Re, v[1] = Im`` with any trailing layout.  The
basis is held zero-padded as one tensor [n_iter, 2, N] on the field's
device, so each re-orthogonalisation pass is two matrix products over it
(the complex coefficients <V_j, w> of every basis vector at once, then
the update), as in tpuqcd; the host reads alpha and beta once per step
and diagonalises the tridiagonal matrix in numpy float64.

On a mesh (``lmesh``) the fields are this rank's blocks and every sum over
a field is summed over the ranks (solvers/reductions.summed inside
``reductions.over(lmesh)``), so every rank sees the same alpha, beta and
Rayleigh quotients and keeps its blocks of the same basis; on one card
the sums are the float32 sums they were.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..utils import pkalg as pk
from .reductions import over, summed


#: re-orthogonalisation passes a step (tpuqcd's default)
REORTH_PASSES = 2


def _reorthogonalize(V: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """w - sum_j <V_j, w> V_j over the zero-padded basis V [m, 2, N] for w
    [2, N], as two products: C = V . [w, i w] gives Re and Im of every
    coefficient, then V^T C the update."""
    m, n = V.shape[0], w.shape[1]
    flat = V.reshape(m, 2 * n)
    c = summed(flat @ torch.stack([w.reshape(-1), torch.cat([w[1], -w[0]])], dim=1))  # [m, 2]
    p = (flat.T @ c).reshape(2, n, 2)               # [ri of V, N, (cr, ci)]
    return w - torch.stack([p[0, :, 0] - p[1, :, 1], p[1, :, 0] + p[0, :, 1]])


def lanczos_lowest_pk(apply_a: Callable, v0_pk: torch.Tensor, n_ev: int, *,
                      n_iter: int = 60, lmesh=None):
    """The lowest n_ev eigenpairs of a Hermitian positive definite A acting on
    packed fields of v0_pk's shape (``[2(ri), ...]``, any trailing layout;
    on a mesh this rank's block, and apply_a the sharded operator).

    The 2 n_ev lowest Ritz pairs are ranked by their Rayleigh quotient on
    A.  The returned vectors are orthonormalised (complex Gram-Schmidt,
    twice), so an exact deflation built on them stays unbiased though
    float32 limits their eigen-residuals.

    Returns (evals float64 [n_ev] ascending Rayleigh quotients, evecs
    float32 [n_ev, *v0_pk.shape])."""
    with over(lmesh):
        return _lanczos(apply_a, v0_pk, n_ev, n_iter)


def _lanczos(apply_a, v0_pk, n_ev, n_iter):
    shape, n_flat = v0_pk.shape, v0_pk.numel() // 2
    v = v0_pk.to(torch.float32).reshape(2, n_flat)
    v = v / torch.sqrt(summed(torch.sum(v * v)))
    V = torch.zeros((n_iter, 2, n_flat), dtype=torch.float32, device=v.device)
    alpha, beta, k = [], [], 0
    for j in range(n_iter):
        V[j] = v
        k = j + 1
        w = apply_a(v.reshape(shape)).reshape(2, n_flat)
        a = summed(torch.sum(v * w))               # Re <v, A v>, A Hermitian
        w = w - a * v
        for _ in range(REORTH_PASSES):
            w = _reorthogonalize(V, w)
        b = torch.sqrt(summed(torch.sum(w * w)))
        v = w / torch.clamp(b, min=1e-30)
        a_host, b_host = torch.stack([a, b]).tolist()
        alpha.append(a_host)
        if b_host < 1e-7:
            break
        beta.append(b_host)
    tmat = (np.diag(np.asarray(alpha[:k])) + np.diag(np.asarray(beta[:k - 1]), 1)
            + np.diag(np.asarray(beta[:k - 1]), -1))
    w_t, s_t = np.linalg.eigh(tmat)
    # Ritz vectors of the 2 n_ev lowest, ranked below by their Rayleigh
    # quotient on A
    n_take = min(k, 2 * n_ev)
    sel = torch.as_tensor(np.asarray(s_t[:, :n_take], np.float32), device=v.device)
    X = (sel.T @ V[:k].reshape(k, 2 * n_flat)).reshape(n_take, 2, n_flat)
    X = X / torch.clamp(torch.sqrt(summed(torch.sum(X * X, dim=(1, 2), keepdim=True))),
                        min=1e-30)
    rq = summed(torch.stack([torch.sum(X[i] * apply_a(X[i].reshape(shape)).reshape(2, n_flat))
                             for i in range(n_take)]))
    pairs = sorted(zip(rq.tolist(), range(n_take)))[:n_ev]
    evals = np.asarray([lam for lam, _ in pairs], np.float64)
    evecs = torch.stack([X[i].reshape(shape) for _, i in pairs])
    return evals, _orthonormalize_pk(evecs)


def _orthonormalize_pk(vs: torch.Tensor) -> torch.Tensor:
    """Complex modified Gram-Schmidt, two passes, on a stack of packed fields
    [n, 2(ri), ...] (float32): an orthonormal stack."""
    n = vs.shape[0]
    F = vs.reshape(n, 2, -1).clone()
    for i in range(n):
        v = F[i]
        for _ in range(2):
            for j in range(i):
                u = F[j]
                cr, ci = summed(torch.stack([torch.sum(u[0] * v[0] + u[1] * v[1]),
                                             torch.sum(u[0] * v[1] - u[1] * v[0])]))
                v = v - torch.stack([cr * u[0] - ci * u[1], cr * u[1] + ci * u[0]])
        F[i] = v / torch.clamp(torch.sqrt(summed(torch.sum(v * v))), min=1e-30)
    return F.reshape(vs.shape)


def deflated_initial_guess(evals, evecs, b: torch.Tensor) -> torch.Tensor:
    """x0 = sum_i v_i <v_i, b> / lambda_i on packed fields (exact on the
    deflated space); the coefficients in float64."""
    x0 = torch.zeros_like(b)
    for lam, v in zip(np.asarray(evals), evecs):
        cr, ci = pk.cdot(v, b, dtype=torch.float64)
        x0 = pk.caxpy(cr.item() / lam, ci.item() / lam, v, x0)
    return x0
