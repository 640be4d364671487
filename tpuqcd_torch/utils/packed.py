"""Packed real (split re/im) fields, the layout the kernel reads.

Counterpart of ``tpuqcd/utils/packed.py``:

    spinor: [2(ri), 4(spin), 3(color), T, Z, S]   (S = Y * X//2)
    gauge : [4(mu), 2(parity), 3, 3, 2(ri), T, Z, S]
            reconstruct-12 [4, 2, 2, 3, 2, T, Z, S] (rows 0 and 1)
            reconstruct-8  [4, 2, 4(pair), 1, 2, T, Z, S] (pack_gauge8)
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


def _rdt(dtype: torch.dtype) -> torch.dtype:
    """The reconstruction precision of a storage dtype."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def recon8_rows(x8: torch.Tensor) -> torch.Tensor:
    """Rows 0 and 1 of reconstruct-8 links: the 8 stored reals [..., 8, n]
    (u01 re, im, u02 re, im, theta00, alpha, beta, gamma; float32 or
    float64) -> complex [..., 2, 3, n].  The same steps as the kernel's
    recon8_rows; the pivot compares |u01|^2 and |u02|^2 of the stored
    values, each product and sum rounded on its own."""
    x = x8.unbind(-2)
    m1 = x[0] * x[0] + x[1] * x[1]
    m2 = x[2] * x[2] + x[3] * x[3]
    a00sq = torch.clamp(1.0 - (m1 + m2), min=0.0)
    a00 = torch.sqrt(a00sq)
    u00 = torch.complex(a00 * torch.cos(x[4]), a00 * torch.sin(x[4]))
    u01, u02 = torch.complex(x[0], x[1]), torch.complex(x[2], x[3])
    use1 = m1 >= m2
    inv = 1.0 / torch.sqrt(torch.clamp(a00sq + torch.where(use1, m1, m2), min=1e-30))
    zero = torch.zeros_like(u00)
    v1 = torch.stack([torch.where(use1, -u01.conj(), u02.conj()),
                      torch.where(use1, u00.conj(), zero),
                      torch.where(use1, zero, -u00.conj())], dim=-2) * inv.unsqueeze(-2)
    r0 = torch.stack([u00, u01, u02], dim=-2)
    v2 = torch.linalg.cross(r0, v1, dim=-2).conj()
    ca, sa = torch.cos(x[5]), torch.sin(x[5])
    c1 = torch.complex(ca * torch.cos(x[6]), ca * torch.sin(x[6]))
    c2 = torch.complex(sa * torch.cos(x[7]), sa * torch.sin(x[7]))
    r1 = c1.unsqueeze(-2) * v1 + c2.unsqueeze(-2) * v2
    return torch.stack([r0, r1], dim=-3)


def pack_gauge8(u_dev: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Reconstruct-8 packed gauge (tpuqcd/utils/packed.py:49-97): complex
    [4, 2, 3, 3, T, Z, S] -> contiguous [4, 2, 4(pair), 1, 2(ri), T, Z, S],
    8 reals a link.

    pairs: (u01, u02, (theta00, alpha), (beta, gamma)) where row0 =
    (|u00| e^{i theta00}, u01, u02) with |u00| from the unit norm, and
    row1 = cos(a) e^{i b} v1 + sin(a) e^{i g} v2 in an orthonormal basis
    {v1, v2} of row0's complement; row2 = conj(row0 x row1), with the
    boundary phase on the rebuilt row as for reconstruct-12.  v1 pivots
    on the larger of |u01|, |u02|.  The branch is taken from the values
    as they are stored (rounded to ``dtype``) by recon8_rows' own
    comparison, so the kernel and the plain version, which see only the
    stored values, take the same branch bit for bit; tpuqcd compares the
    unrounded n1 >= n2, which is the same branch away from a tie."""
    rdt = _rdt(dtype)
    u00, u01, u02 = u_dev[:, :, 0, 0], u_dev[:, :, 0, 1], u_dev[:, :, 0, 2]
    r0, r1 = u_dev[:, :, 0], u_dev[:, :, 1]              # [4, 2, 3, T, Z, S]
    st = [t.to(dtype).to(rdt) for t in (u01.real, u01.imag, u02.real, u02.imag)]
    use1 = st[0] * st[0] + st[1] * st[1] >= st[2] * st[2] + st[3] * st[3]
    a00sq = u00.real ** 2 + u00.imag ** 2
    n1 = torch.sqrt(torch.clamp(a00sq + u01.real ** 2 + u01.imag ** 2, min=1e-30))
    n2 = torch.sqrt(torch.clamp(a00sq + u02.real ** 2 + u02.imag ** 2, min=1e-30))
    inv = torch.where(use1, 1.0 / n1, 1.0 / n2)
    zero = torch.zeros_like(u00)
    v1 = torch.stack([torch.where(use1, -u01.conj(), u02.conj()),
                      torch.where(use1, u00.conj(), zero),
                      torch.where(use1, zero, -u00.conj())], dim=2) * inv[:, :, None]
    v2 = torch.linalg.cross(r0, v1, dim=2).conj()
    c1 = torch.sum(v1.conj() * r1, dim=2)                # <v1, row1>
    c2 = torch.sum(v2.conj() * r1, dim=2)
    pairs = torch.stack([
        torch.stack([u01.real, u01.imag], dim=2),
        torch.stack([u02.real, u02.imag], dim=2),
        torch.stack([torch.angle(u00), torch.atan2(c2.abs(), c1.abs())], dim=2),
        torch.stack([torch.angle(c1), torch.angle(c2)], dim=2),
    ], dim=2)                                            # [4, 2, 4, 2(ri), T, Z, S]
    return pairs[:, :, :, None].to(dtype).contiguous()


def unpack_gauge8(u8: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_gauge8 -> complex [4, 2, 3, 3, T, Z, S], without the
    boundary phase on the rebuilt row 2 (tpuqcd/utils/packed.py:100)."""
    sites = u8.shape[5:]
    rows = recon8_rows(u8.to(_rdt(u8.dtype)).reshape(4, 2, 8, -1))
    r2 = torch.linalg.cross(rows[:, :, 0], rows[:, :, 1], dim=-2).conj()
    return torch.cat([rows, r2[:, :, None]], dim=2).reshape(4, 2, 3, 3, *sites)


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
