"""Complex linear algebra on packed-real fields with a leading re/im axis.

Counterpart of ``tpuqcd/utils/pkalg.py``.  Every MG field is packed with
``x[0] = Re, x[1] = Im`` leading and any trailing shape (fine fields
[2, 2(par), 4, 3, T, Z, S], coarse fields [2, N, Vc]).  Complex scalars
are (re, im) pairs of 0-d float32 tensors that stay on the field's
device: nothing here reads a value back to the host.

As in tpuqcd, reductions accumulate in float32 (bfloat16 fields are
upcast first) and ``caxpy``/``cscale`` cast their scalars to the
field's dtype, so a bfloat16 field is updated in bfloat16 arithmetic.
The epsilon floors (sdiv 1e-30, Cholesky 1e-12) are tpuqcd's; the MG
solve normalizes its right-hand side to them (mg/dsolve.DeviceMG.solve).

On a LatticeMesh the reductions sum over the ranks inside
``solvers.reductions.over(lmesh)``, as the float64 ones do.

A batch of N fields [N, 2(ri), ...] (tpuqcd vmaps this algebra over the
right-hand sides, mg/dsolve.py:316-347) goes through the same functions
with ``cols=True``: the re/im axis is then axis 1, the reductions return
one scalar per column, shaped [N, 1, ..., 1] so that it broadcasts over
the batch, and the updates take such scalars.  solvers/krylov_pk.py
passes ``cols`` on, so its loops run the N columns in lockstep.
"""
from __future__ import annotations

import torch

from ..solvers import reductions


def _ri(x: torch.Tensor, cols: bool):
    """The (re, im) views of a field, or of a batch with its unit re/im
    axis kept, so that per-column scalars broadcast over them."""
    return (x[:, 0:1], x[:, 1:2]) if cols else (x[0], x[1])


def _per_column(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return s.reshape(-1, *([1] * (like.ndim - 1)))


def cdot(x: torch.Tensor, y: torch.Tensor, dtype=torch.float32, cols: bool = False):
    """<x, y> = sum conj(x) y -> (re, im) 0-d tensors of ``dtype``
    (three dot products: the real part is the dot of the packed arrays);
    with ``cols`` per column of a batch, each shaped [N, 1, ..., 1]."""
    x, y = x.to(dtype), y.to(dtype)
    if cols:
        xf, yf = x.flatten(2), y.flatten(2)                       # [N, 2, M]
        re = torch.linalg.vecdot(xf, yf).sum(1)
        im = torch.linalg.vecdot(xf[:, 0], yf[:, 1]) - torch.linalg.vecdot(xf[:, 1], yf[:, 0])
        re, im = _summed_pair(re, im)
        return _per_column(re, x), _per_column(im, x)
    re = torch.dot(x.reshape(-1), y.reshape(-1))
    im = torch.dot(x[0].reshape(-1), y[1].reshape(-1)) - torch.dot(x[1].reshape(-1),
                                                                  y[0].reshape(-1))
    return _summed_pair(re, im)


def _summed_pair(re: torch.Tensor, im: torch.Tensor):
    """(re, im) summed over the mesh's ranks in one all-reduce."""
    if not reductions.active():
        return re, im
    s = reductions.summed(torch.stack([re, im]))
    return s[0], s[1]


def norm2(x: torch.Tensor, dtype=torch.float32, cols: bool = False) -> torch.Tensor:
    if cols:
        xf = x.to(dtype).flatten(2)
        return _per_column(reductions.summed(torch.linalg.vecdot(xf, xf).sum(1)), x)
    v = x.reshape(-1).to(dtype)
    return reductions.summed(torch.dot(v, v))


def _axpy_into(out, ar, ai, x, y, sign: float, cols: bool) -> torch.Tensor:
    """out = y + sign (ar + i ai) x.  Tensor scalars are cast to the
    field dtype and stay on the device; Python numbers go in as alpha."""
    (xr, xi), (yr, yi), (outr, outi) = _ri(x, cols), _ri(y, cols), _ri(out, cols)
    if isinstance(ar, torch.Tensor) or isinstance(ai, torch.Tensor):
        ar = torch.as_tensor(ar, device=x.device).to(x.dtype)
        ai = torch.as_tensor(ai, device=x.device).to(x.dtype)
        torch.addcmul(yr, xr, ar, value=sign, out=outr).addcmul_(xi, ai, value=-sign)
        torch.addcmul(yi, xi, ar, value=sign, out=outi).addcmul_(xr, ai, value=sign)
        return out
    torch.add(yr, xr, alpha=sign * ar, out=outr)
    torch.add(yi, xi, alpha=sign * ar, out=outi)
    if ai:
        outr.add_(xi, alpha=-sign * ai)
        outi.add_(xr, alpha=sign * ai)
    return out


def caxpy(ar, ai, x: torch.Tensor, y: torch.Tensor, cols: bool = False) -> torch.Tensor:
    """y + (ar + i ai) x as a new field; scalars cast to the field dtype."""
    return _axpy_into(torch.empty_like(y), ar, ai, x, y, 1.0, cols)


def csub(ar, ai, x: torch.Tensor, y: torch.Tensor, cols: bool = False) -> torch.Tensor:
    """y - (ar + i ai) x, the same as caxpy(-ar, -ai, x, y) without the
    negations."""
    return _axpy_into(torch.empty_like(y), ar, ai, x, y, -1.0, cols)


def cscale(ar, ai, x: torch.Tensor) -> torch.Tensor:
    ar = torch.as_tensor(ar, device=x.device).to(x.dtype)
    ai = torch.as_tensor(ai, device=x.device).to(x.dtype)
    out = torch.empty_like(x)
    torch.mul(x[0], ar, out=out[0]).addcmul_(x[1], ai, value=-1)
    torch.mul(x[1], ar, out=out[1]).addcmul_(x[0], ai)
    return out


# --- complex scalar helpers (pairs of 0-d tensors) ---------------------------

def smul(a, b):
    ar, ai = a
    br, bi = b
    return (ar * br - ai * bi, ar * bi + ai * br)


def sdiv(a, b, eps: float = 1e-30):
    ar, ai = a
    br, bi = b
    den = torch.clamp(br * br + bi * bi, min=eps)
    return ((ar * br + ai * bi) / den, (ai * br - ar * bi) / den)


def sconj(a):
    return (a[0], -a[1])


# --- small batched complex Cholesky (site axes trailing) ---------------------

def cholesky_pk(g: torch.Tensor, n: int, eps: float = 1e-12) -> torch.Tensor:
    """Cholesky L L^dag = G of Hermitian positive definite ``g``
    [2(ri), n, n, *sites]; L in the same layout (strictly lower part and
    a real diagonal).  The pivot is floored at ``eps`` as in tpuqcd.
    Left-looking, one column per step, vectorized over the rows and the
    sites."""
    gr, gi = g[0], g[1]
    L = torch.zeros_like(g)
    lr, li = L[0], L[1]
    for k in range(n):
        # s = G[k,k] - sum_j |L[k,j]|^2
        s = gr[k, k] - (lr[k, :k] ** 2 + li[k, :k] ** 2).sum(0)
        dkk = torch.sqrt(torch.clamp(s, min=eps))
        lr[k, k] = dkk
        if k + 1 == n:
            break
        # L[i,k] = (G[i,k] - sum_j L[i,j] conj(L[k,j])) / L[k,k],  i > k
        ar, ai = lr[k + 1:, :k], li[k + 1:, :k]
        br, bi = lr[k, :k][None], li[k, :k][None]
        sr = gr[k + 1:, k] - (ar * br + ai * bi).sum(1)
        si = gi[k + 1:, k] - (ai * br - ar * bi).sum(1)
        lr[k + 1:, k] = sr / dkk
        li[k + 1:, k] = si / dkk
    return L


def tril_inverse_pk(L: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of a lower-triangular complex ``L`` [2, n, n, *sites] by
    forward substitution, one row per step."""
    Lr, Li = L[0], L[1]
    M = torch.zeros_like(L)
    mr, mi = M[0], M[1]
    for i in range(n):
        # M[i,:] = (e_i - sum_{k<i} L[i,k] M[k,:]) / L[i,i]
        br, bi = Lr[i, :i, None], Li[i, :i, None]
        sr = (br * mr[:i] - bi * mi[:i]).sum(0)
        si = (br * mi[:i] + bi * mr[:i]).sum(0)
        sr[i] -= 1.0
        mr[i] = -sr / Lr[i, i]
        mi[i] = -si / Lr[i, i]
    return M
