"""3x3 color-matrix algebra for the gauge tools.

Counterpart of the parts of ``tpuqcd/ops/mat3.py`` the heatbath needs.
tpuqcd keeps the color indices leading ([3, 3, *sites]) and unrolls
every product, for the TPU's tiling; here they are the two trailing axes
([..., 3, 3]).  A product over all sites is a broadcast multiply and a
sum over k (two elementwise launches, bandwidth-bound): a batched 3x3
complex GEMM per site runs far below the card's bandwidth.
"""
from __future__ import annotations

import torch


def mul(a: torch.Tensor, b: torch.Tensor, adag: bool = False,
        bdag: bool = False) -> torch.Tensor:
    """a @ b with optional daggers."""
    a = a.mH if adag else a
    b = b.mH if bdag else b
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def dag(a: torch.Tensor) -> torch.Tensor:
    return a.mH


def trace(a: torch.Tensor) -> torch.Tensor:
    return a[..., 0, 0] + a[..., 1, 1] + a[..., 2, 2]


def det(a: torch.Tensor) -> torch.Tensor:
    """Determinant by cofactors along the first row."""
    return (a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
            - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
            + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]))


def project_su3(x: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Project [..., 3, 3] matrices onto SU(3): Newton iteration for
    unitarity, U <- U (3 I - U^dag U) / 2, after a Frobenius pre-scale,
    then a det^{-1/3} phase fix."""
    nrm = torch.sqrt(trace(mul(x, x, adag=True)).real / 3.0)
    u = x / nrm[..., None, None]
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    for _ in range(iters):
        u = mul(u, 1.5 * eye - 0.5 * mul(u, u, adag=True))
    phase = torch.exp((-1.0 / 3.0) * 1j * torch.angle(det(u))).to(u.dtype)
    return u * phase[..., None, None]
