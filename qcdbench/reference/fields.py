"""Full-layout fields and the port's packed even-odd layout (the interface
the judged outputs arrive in).

Full layout: complex [..., T, Z, Y, X, 4(spin), 3(colour)], dims = (Lx, Ly,
Lz, Lt).  Packed: real [..., 2(par), 2(re, im), 4, 3, T, Z, S], S = Y * X/2,
parity(x) = (t + z + y + x) % 2, and the site of parity p at (t, z, y, xh)
has x = 2 xh + (t + z + y + p) % 2.
"""
from __future__ import annotations

import torch


def parity(dims, device=None) -> torch.Tensor:
    """int64 [T, Z, Y, X]: (t + z + y + x) % 2."""
    lx, ly, lz, lt = dims
    t, z, y, x = (torch.arange(n, device=device) for n in (lt, lz, ly, lx))
    return (t[:, None, None, None] + z[None, :, None, None] + y[None, None, :, None]
            + x[None, None, None, :]) % 2


def packed_to_full(x_pk: torch.Tensor, dims, dtype=torch.complex128) -> torch.Tensor:
    """[..., 2(par), 2(ri), 4, 3, T, Z, S] -> complex [..., T, Z, Y, X, 4, 3]."""
    lx, ly, lz, lt = dims
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    c = torch.complex(x_pk.select(-6, 0).to(rdt), x_pk.select(-6, 1).to(rdt))
    c = c.unflatten(-1, (ly, lx // 2))                      # [..., 2, 4, 3, T, Z, Y, Xh]
    xh = torch.arange(lx, device=x_pk.device) // 2
    g = c[..., xh]                                          # [..., 2, 4, 3, T, Z, Y, X]
    full = torch.where(parity(dims, x_pk.device) == 0, g.select(-7, 0), g.select(-7, 1))
    return full.movedim((-6, -5), (-2, -1))


def full_to_packed(f: torch.Tensor, dims, dtype=torch.float32) -> torch.Tensor:
    """complex [..., T, Z, Y, X, 4, 3] -> [..., 2(par), 2(ri), 4, 3, T, Z, S]."""
    lx, ly, lz, lt = dims
    dev = f.device
    t, z, y, xh = (torch.arange(n, device=dev) for n in (lt, lz, ly, lx // 2))
    s = (t[:, None, None, None] + z[None, :, None, None] + y[None, None, :, None]) % 2
    sp = f.movedim((-2, -1), (-6, -5))                     # [..., 4, 3, T, Z, Y, X]
    pars = []
    for p in (0, 1):
        xi = (2 * xh[None, None, None, :] + (s + p) % 2).expand(lt, lz, ly, lx // 2)
        g = torch.gather(sp, -1, xi.expand(*sp.shape[:-1], lx // 2))
        pars.append(g.flatten(-2))
    c = torch.stack(pars, dim=-6)                           # [..., 2, 4, 3, T, Z, S]
    return torch.stack([c.real, c.imag], dim=-6).to(dtype)
