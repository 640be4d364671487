"""Incremental eigCG: deflated CG for sequences of right-hand sides.

Counterpart of ``tpuqcd/solvers/eigcg.py:70-244`` on packed fields
``[2(ri), ...]`` (Stathopoulos and Orginos, arXiv:0707.0131).  While CG
solves A x = b for a Hermitian positive definite A, its coefficients give
the Lanczos tridiagonal matrix of the normalised residuals; eigCG keeps a
window of m of them, restarts it from the nev lowest Ritz vectors of T_m
and of T_{m-1} (the two-basis restart), and at the end harvests nev
approximate low eigenpairs.  An ``EigCGSpace`` collects them over the
sequence and deflates the next right-hand side's initial guess, so the
iteration count falls along the sequence.

The window is one tensor [m, *field] on the field's device: a restart's
new basis and the final harvest are each one product of the coefficient
matrix with the stacked window (tpuqcd sums m x 2 nev axpys), equal up to
rounding.  The m x m matrices, the Rayleigh-Ritz step and the restart's
QR live on the host in numpy float64; every dot product sums in float64.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..utils import pkalg as pk


def _dot(a: torch.Tensor, b: torch.Tensor) -> complex:
    re, im = pk.cdot(a, b, dtype=torch.float64)
    re, im = torch.stack([re, im]).tolist()
    return complex(re, im)


def _redot(a: torch.Tensor, b: torch.Tensor) -> float:
    return pk.cdot(a, b, dtype=torch.float64)[0].item()


def _nrm2(a: torch.Tensor) -> float:
    return pk.norm2(a, dtype=torch.float64).item()


def _caxpy(alpha: complex, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y + alpha x for a complex alpha."""
    return pk.caxpy(alpha.real, alpha.imag, x, y)


def _combine(coef: np.ndarray, V: torch.Tensor) -> torch.Tensor:
    """The fields sum_l coef[l, i] V[l] for every column i of coef [k, n]
    (real), each normalised: one product over the stacked window V[:k]."""
    k, n = coef.shape
    c = torch.as_tensor(coef, dtype=V.dtype, device=V.device)
    Y = (c.T @ V[:k].reshape(k, -1)).reshape(n, *V.shape[1:])
    nrm = pk.norm2(Y, dtype=torch.float64, cols=True).sqrt()
    return Y / nrm.to(Y.dtype)


@dataclasses.dataclass
class EigCGSpace:
    """The deflation space harvested so far (it grows along the sequence)."""
    evecs: list
    evals: list

    @staticmethod
    def empty() -> "EigCGSpace":
        return EigCGSpace(evecs=[], evals=[])

    @property
    def k(self) -> int:
        return len(self.evecs)

    def deflate(self, b: torch.Tensor) -> torch.Tensor:
        """x0 = U diag(1/lambda) U^dag b, exact on the space."""
        x0 = torch.zeros_like(b)
        for lam, v in zip(self.evals, self.evecs):
            x0 = _caxpy(_dot(v, b) / lam, v, x0)
        return x0

    def absorb(self, apply_a: Callable, ritz_pairs, max_k: int = 256) -> None:
        """Orthogonalise each new Ritz vector against the space and append
        it with its Rayleigh quotient on A; a vector already in the space
        (|w| < 1e-4 after the projection) or with a quotient <= 0 is left
        out."""
        for _, v in ritz_pairs:
            if self.k >= max_k:
                break
            w = v
            for u in self.evecs:
                w = _caxpy(-_dot(u, w), u, w)
            nw = _nrm2(w) ** 0.5
            if nw < 1e-4:
                continue
            w = w / nw
            lam = _redot(w, apply_a(w))
            if lam <= 0:
                continue
            self.evecs.append(w)
            self.evals.append(lam)


@dataclasses.dataclass
class EigCGResult:
    x: torch.Tensor
    relres: float
    iters: int
    converged: bool
    #: [(lambda, field)] harvested by this solve, lowest first
    ritz: list


def eigcg(apply_a: Callable, b: torch.Tensor, *, nev: int = 4, m: int = 16,
          tol: float = 1e-8, maxiter: int = 1000,
          space: EigCGSpace | None = None) -> EigCGResult:
    """One eigCG solve of A x = b to |r| / |b| <= tol (the iterated
    residual), harvesting nev low Ritz pairs; ``space`` gives the deflated
    initial guess (absorb the harvest into it for the incremental scheme,
    or call solve_sequence)."""
    if not m > 2 * nev:
        raise ValueError(f"eigcg needs m > 2 nev, got m={m}, nev={nev}")
    if space is not None and space.k > 0:
        x = space.deflate(b)
        r = b - apply_a(x)
    else:
        x, r = torch.zeros_like(b), b
    bsq = _nrm2(b)
    tol2 = tol * tol * bsq
    p = r
    rsq = _nrm2(r)
    # the window: normalised residuals v_j = r_j / |r_j|, whose three-term
    # recurrence has the T entries built from CG's alpha and beta
    V = torch.empty((m, *b.shape), dtype=b.dtype, device=b.device)
    Tm = np.zeros((m, m))
    j = 0
    alpha_prev, beta_prev = None, 0.0

    def compress_so():
        """The two-basis restart: the nev lowest Ritz coefficient vectors of
        T_m and of T_{m-1}, orthonormalised, T_m projected onto them and
        rotated to its eigenbasis."""
        nonlocal Tm, j
        _, s_m = np.linalg.eigh(Tm[:m, :m])
        _, s_m1 = np.linalg.eigh(Tm[:m - 1, :m - 1])
        y2 = np.zeros((m, nev))
        y2[:m - 1] = s_m1[:, :nev]
        q, _ = np.linalg.qr(np.concatenate([s_m[:, :nev], y2], axis=1))
        w_h, s_h = np.linalg.eigh(q.T @ Tm[:m, :m] @ q)        # 2nev x 2nev
        keep = 2 * nev
        V[:keep] = _combine(q @ s_h, V)
        Tm = np.zeros((m, m))
        Tm[:keep, :keep] = np.diag(w_h)
        j = keep

    it = 0
    while it < maxiter and rsq > tol2:
        v = r / rsq ** 0.5
        if j == m:                  # window full: restart
            compress_so()
            # the restarted T couples to the incoming vector through its
            # projected residual row, read by dots with one extra apply
            av = apply_a(v)
            row = torch.stack([pk.cdot(V[i], av, dtype=torch.float64)[0]
                               for i in range(j)]).tolist()
            Tm[:j, j] = Tm[j, :j] = row
        V[j] = v
        ap = apply_a(p)
        pap = _redot(p, ap)
        alpha = rsq / pap
        # T from the CG recurrence (the Lanczos-CG relation)
        Tm[j, j] = 1.0 / alpha + (beta_prev / alpha_prev if alpha_prev is not None else 0.0)
        x.add_(p, alpha=alpha)
        r_new = r - alpha * ap
        rsq_new = _nrm2(r_new)
        beta = rsq_new / rsq
        if j + 1 < m:
            Tm[j, j + 1] = Tm[j + 1, j] = -np.sqrt(beta) / alpha
        alpha_prev, beta_prev = alpha, beta
        r, rsq = r_new, rsq_new
        p = r + beta * p
        j += 1
        it += 1

    ritz_pairs = []
    if j > nev:                       # the harvest: Ritz pairs of the last window
        w_t, s_t = np.linalg.eigh(Tm[:j, :j])
        Y = _combine(s_t[:, :nev], V)
        ritz_pairs = [(float(w_t[i]), Y[i]) for i in range(nev)]
    return EigCGResult(x=x, relres=(rsq / max(bsq, 1e-300)) ** 0.5, iters=it,
                       converged=rsq <= tol2, ritz=ritz_pairs)


def solve_sequence(apply_a: Callable, bs, *, nev: int = 4, m: int = 16, tol: float = 1e-8,
                   maxiter: int = 1000, max_space: int = 64):
    """Incremental eigCG over a sequence of right-hand sides: each solve is
    deflated by everything harvested before it and adds about nev pairs.
    Returns (results, the final EigCGSpace)."""
    space = EigCGSpace.empty()
    results = []
    for b in bs:
        res = eigcg(apply_a, b, nev=nev, m=m, tol=tol, maxiter=maxiter, space=space)
        space.absorb(apply_a, res.ritz, max_k=max_space)
        results.append(res)
    return results, space
