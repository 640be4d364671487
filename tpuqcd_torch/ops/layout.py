"""Device field layout: small tensor axes leading, sites last.

Counterpart of ``tpuqcd/ops/layout.py``:

    spinor (one parity): [4(spin), 3(color), T, Z, S],  S = Y * X//2
    gauge  (eo)        : [4(mu), 2(parity), 3, 3, T, Z, S]

With S minor, consecutive CUDA threads (consecutive sites) read
consecutive addresses, so every component access of the Dslash kernel
is coalesced.  On the flattened S axis (y major, xh minor) a y shift is
a shift by Xh; an x shift moves xh by 0 or 1 depending on the site's
checkerboard, wrapping within its y row (ops/dslash_cuda.py).
"""
from __future__ import annotations

import torch

from ..lattice import Lattice


def spinor_to_device(psi_eo: torch.Tensor, lat: Lattice) -> torch.Tensor:
    """[..., T, Z, Y, Xh, 4, 3] -> [..., 4, 3, T, Z, S]."""
    *b, T, Z, Y, Xh, s, c = psi_eo.shape
    nb = len(b)
    out = torch.movedim(psi_eo, (nb + 4, nb + 5), (nb, nb + 1))
    return out.reshape(*b, s, c, T, Z, Y * Xh)


def spinor_from_device(psi_dev: torch.Tensor, lat: Lattice) -> torch.Tensor:
    """[..., 4, 3, T, Z, S] -> [..., T, Z, Y, Xh, 4, 3]."""
    *b, s, c, T, Z, S = psi_dev.shape
    nb = len(b)
    out = psi_dev.reshape(*b, s, c, T, Z, lat.Ly, lat.Lx // 2)
    return torch.movedim(out, (nb, nb + 1), (nb + 4, nb + 5))


def gauge_to_device(u_eo: torch.Tensor, lat: Lattice) -> torch.Tensor:
    """[4, 2, T, Z, Y, Xh, 3, 3] -> [4, 2, 3, 3, T, Z, S]."""
    mu, p, T, Z, Y, Xh, i, j = u_eo.shape
    out = torch.movedim(u_eo, (6, 7), (2, 3))
    return out.reshape(mu, p, i, j, T, Z, Y * Xh)


def gauge_from_device(u_dev: torch.Tensor, lat: Lattice) -> torch.Tensor:
    """[4, 2, 3, 3, T, Z, S] -> [4, 2, T, Z, Y, Xh, 3, 3]."""
    mu, p, i, j, T, Z, S = u_dev.shape
    out = u_dev.reshape(mu, p, i, j, T, Z, lat.Ly, lat.Lx // 2)
    return torch.movedim(out, (2, 3), (6, 7))
