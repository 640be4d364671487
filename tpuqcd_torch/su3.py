"""SU(3) utilities: random links, reunitarization, reconstruct-12.

Counterpart of ``tpuqcd/su3.py``.  Matrices sit on the two trailing axes
here ([..., 3, 3]); the device layout moves them forward
(ops/layout.py).
"""
from __future__ import annotations

import torch


def _cross_conj(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """conj(a x b) over the trailing color axis."""
    return torch.conj(torch.linalg.cross(a, b, dim=-1))


def random_su3(shape: tuple[int, ...], generator: torch.Generator,
               device=None, dtype=torch.complex64) -> torch.Tensor:
    """iid random SU(3) matrices of shape ``shape + (3, 3)``.

    Row-wise Gram-Schmidt plus reconstruct-12, as in tpuqcd.  The normal
    draws come from ``generator`` on its own device (the CPU for a
    default generator, so that one seed gives the same field on every
    device); the arithmetic runs on ``device``.
    """
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    g = torch.randn((4, *shape, 3), generator=generator, dtype=rdt,
                    device=generator.device).to(device)
    r0 = torch.complex(g[0], g[1])
    r1 = torch.complex(g[2], g[3])
    r0 = r0 / torch.linalg.vector_norm(r0, dim=-1, keepdim=True)
    r1 = r1 - torch.sum(r0.conj() * r1, dim=-1, keepdim=True) * r0
    r1 = r1 / torch.linalg.vector_norm(r1, dim=-1, keepdim=True)
    return torch.stack([r0, r1, _cross_conj(r0, r1)], dim=-2)


def unit_gauge(lat, device=None, dtype=torch.complex64) -> torch.Tensor:
    """Free-field (identity) gauge in the device layout [4, 2, 3, 3, T, Z, S]
    (tpuqcd/su3.py unit_gauge_dev), the heatbath's cold start."""
    eye = torch.eye(3, dtype=dtype, device=device).reshape(1, 1, 3, 3, 1, 1, 1)
    return eye.expand(4, 2, 3, 3, *lat.site_shape).contiguous()


def random_gauge(lat, generator: torch.Generator, device=None,
                 dtype=torch.complex64) -> torch.Tensor:
    """Random full-layout gauge field [4, T, Z, Y, X, 3, 3]."""
    return random_su3(lat.gauge_shape()[:-2], generator, device, dtype)


def reunitarize(u: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Project [..., 3, 3] matrices onto SU(3): Newton iteration for
    unitarity, U <- U (3 I - U^dag U) / 2 after a Frobenius pre-scale,
    then a det^{-1/3} phase fix (tpuqcd/ops/mat3.project_su3)."""
    nrm = torch.sqrt(torch.sum(u.abs() ** 2, dim=(-2, -1), keepdim=True) / 3.0)
    w = u / nrm
    eye = torch.eye(3, dtype=u.dtype, device=u.device)
    for _ in range(iters):
        w = w @ (1.5 * eye - 0.5 * (w.mH @ w))
    phase = torch.exp((-1.0 / 3.0) * 1j * torch.angle(torch.linalg.det(w)))
    return w * phase[..., None, None].to(u.dtype)


def compress12(u: torch.Tensor) -> torch.Tensor:
    """SU(3) [..., 3, 3] -> first two rows [..., 2, 3] (12 reals)."""
    return u[..., :2, :]


def reconstruct12(u12: torch.Tensor) -> torch.Tensor:
    """Rebuild the third row: row2 = conj(row0 x row1)."""
    r2 = _cross_conj(u12[..., 0, :], u12[..., 1, :])
    return torch.cat([u12, r2[..., None, :]], dim=-2)
