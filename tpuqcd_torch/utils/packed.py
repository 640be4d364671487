"""Packed real (split re/im) fields, the layout the kernel reads.

Counterpart of ``tpuqcd/utils/packed.py``:

    spinor: [2(ri), 4(spin), 3(color), T, Z, S]   (S = Y * X//2)
    gauge : [4(mu), 2(parity), 3, 3, 2(ri), T, Z, S]
    clover: [2(ri), 2(chir), 6, 6, T, Z, S]       (one parity's blocks)

Complex axpy with real scalars, norms and Re<x, y> are the plain real
operations on the packed array; complex-scalar helpers for BiCGStab are
here too.  bf16 has no complex form, which is why the solver path
stores every field packed.
"""
from __future__ import annotations

import torch


def pack_spinor(psi_dev: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """complex [..., 4, 3, T, Z, S] -> packed [..., 2, 4, 3, T, Z, S]."""
    nb = psi_dev.ndim - 5
    return torch.stack([psi_dev.real, psi_dev.imag], dim=nb).to(dtype)


def unpack_spinor(psi_pk: torch.Tensor) -> torch.Tensor:
    """packed [..., 2, 4, 3, T, Z, S] -> complex (complex128 for f64 input,
    complex64 otherwise)."""
    nb = psi_pk.ndim - 6
    rdt = torch.float64 if psi_pk.dtype == torch.float64 else torch.float32
    return torch.complex(psi_pk.select(nb, 0).to(rdt), psi_pk.select(nb, 1).to(rdt))


def pack_gauge(u_dev: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """complex [4, 2, 3, 3, T, Z, S] -> packed [4, 2, 3, 3, 2, T, Z, S]."""
    return torch.stack([u_dev.real, u_dev.imag], dim=4).to(dtype)


def pack_gauge12(u_dev: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Reconstruct-12 packed gauge, rows 0 and 1 only, as a contiguous
    [4, 2, 2, 3, 2, T, Z, S] copy (the kernel rebuilds row 2)."""
    return pack_gauge(u_dev[:, :, :2], dtype).contiguous()


def unpack_gauge(u_pk: torch.Tensor) -> torch.Tensor:
    """packed [4, 2, R, 3, 2, T, Z, S] -> complex [4, 2, R, 3, T, Z, S]."""
    rdt = torch.float64 if u_pk.dtype == torch.float64 else torch.float32
    return torch.complex(u_pk[:, :, :, :, 0].to(rdt), u_pk[:, :, :, :, 1].to(rdt))


def pack_clover(blocks: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """chiral clover blocks [2(chir), 6, 6, T, Z, S] complex -> packed
    contiguous [2(ri), 2, 6, 6, T, Z, S] (the kernel's clover operand)."""
    return torch.stack([blocks.real, blocks.imag]).to(dtype).contiguous()


def caxpy(ar: torch.Tensor, ai: torch.Tensor, x_pk: torch.Tensor,
          y_pk: torch.Tensor) -> torch.Tensor:
    """(ar + i ai) * x + y on packed spinors; the f64 scalars are cast to
    the field dtype first, as in tpuqcd."""
    nb = x_pk.ndim - 6
    xr, xi = x_pk.select(nb, 0), x_pk.select(nb, 1)
    a_r, a_i = ar.to(x_pk.dtype), ai.to(x_pk.dtype)
    return y_pk + torch.stack([a_r * xr - a_i * xi, a_r * xi + a_i * xr], dim=nb)


def cdot_packed(x_pk: torch.Tensor, y_pk: torch.Tensor):
    """<x, y> = sum conj(x) y on packed spinors -> (re, im) f64 0-d tensors."""
    nb = x_pk.ndim - 6
    xr, xi = x_pk.select(nb, 0).double(), x_pk.select(nb, 1).double()
    yr, yi = y_pk.select(nb, 0).double(), y_pk.select(nb, 1).double()
    re = torch.sum(xr * yr) + torch.sum(xi * yi)
    im = torch.sum(xr * yi) - torch.sum(xi * yr)
    return re, im
