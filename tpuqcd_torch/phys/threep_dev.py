"""Momentum projection of packed site densities.

Counterpart of ``tpuqcd/phys/threep_dev.py:50-159``, the part the two-point
run needs: a packed density [2(ri), 2(par), T, Z, S] -> complex [n_mom, T]
with the phases e^{-i p.(x - x0)}, by a phase-list sum for a few momenta
and by one spatial ``torch.fft.fftn`` and a gather for momentum lists of
FFT_MOM_THRESHOLD or more.  The chosen path runs or raises; there is no
fall back from one to the other.  The sums run in complex128: the density
of one timeslice is small next to a propagator.  The three-point
bilinears of the same tpuqcd module are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..fields import eo_to_full
from ..lattice import Lattice

#: momentum-list length from which one spatial FFT + gather beats the
#: n x V phase sum (tpuqcd's value)
FFT_MOM_THRESHOLD = 32


def momentum_phases(lat: Lattice, momenta, src_pos=(0, 0, 0), device=None) -> torch.Tensor:
    """e^{-i p.(x - x0)} for integer momenta [n, 3] (units 2 pi / L):
    complex128 [n, Z, Y, X]; src_pos = (x0, y0, z0)."""
    m = torch.as_tensor(np.asarray(momenta), dtype=torch.float64, device=device).reshape(-1, 3)
    x0, y0, z0 = src_pos
    ar = lambda n_, o: (torch.arange(n_, dtype=torch.float64, device=device) - o) / n_  # noqa: E731
    arg = (m[:, 0, None, None, None] * ar(lat.Lx, x0)[None, None, None, :]
           + m[:, 1, None, None, None] * ar(lat.Ly, y0)[None, None, :, None]
           + m[:, 2, None, None, None] * ar(lat.Lz, z0)[None, :, None, None])
    return torch.polar(torch.ones_like(arg), -2.0 * torch.pi * arg)


def momentum_phases_pk(lat: Lattice, momenta, src_pos=(0, 0, 0), device=None) -> torch.Tensor:
    """The phases in the parity-split device layout: float64
    [2(ri), n, 2(par), T, Z, S], S = Y * X//2."""
    ph = momentum_phases(lat, momenta, src_pos, device)           # [n, Z, Y, X]
    s = lat.eo_sub_parity(device)[None, :, :, :, None]            # [1, T, Z, Y, 1]
    ph0, ph1 = ph[:, None, :, :, 0::2], ph[:, None, :, :, 1::2]   # [n, 1, Z, Y, Xh]
    pk = torch.stack([torch.where(s, ph1, ph0), torch.where(s, ph0, ph1)], dim=1)
    pk = pk.reshape(pk.shape[0], 2, *lat.site_shape)
    return torch.stack([pk.real, pk.imag])


def _mom_indices(lat: Lattice, momenta, device):
    m = torch.as_tensor(np.asarray(momenta), dtype=torch.int64, device=device).reshape(-1, 3)
    return m[:, 2] % lat.Lz, m[:, 1] % lat.Ly, m[:, 0] % lat.Lx


def _density_fft_full(dens_pk: torch.Tensor, lat: Lattice, src_pos) -> torch.Tensor:
    """Packed density -> the complex momentum grid [T, Z, Y, X] (one FFT
    over the spatial volume of every timeslice, the source rolled to 0)."""
    c = torch.complex(dens_pk[0].double(), dens_pk[1].double())
    full = eo_to_full(c.reshape(2, lat.Lt, lat.Lz, lat.Ly, lat.Lx // 2), lat)
    x0, y0, z0 = (int(v) for v in src_pos)
    if x0 or y0 or z0:   # e^{-ip.(x-x0)}: roll so the source sits at 0
        full = torch.roll(full, (-z0, -y0, -x0), dims=(1, 2, 3))
    return torch.fft.fftn(full, dim=(1, 2, 3))


def project_momenta_pk(dens_pk: torch.Tensor, lat: Lattice, momenta,
                       src_pos=(0, 0, 0), fft: bool | None = None) -> torch.Tensor:
    """Packed density [2(ri), 2(par), T, Z, S] -> complex128 [n_mom, T] on
    the density's device; src_pos = (x0, y0, z0).  ``fft`` picks the FFT +
    gather (default: for FFT_MOM_THRESHOLD momenta or more) or the phase
    sum."""
    if fft is None:
        fft = len(momenta) >= FFT_MOM_THRESHOLD
    if fft:
        iz, iy, ix = _mom_indices(lat, momenta, dens_pk.device)
        return _density_fft_full(dens_pk, lat, src_pos)[:, iz, iy, ix].transpose(0, 1)
    ph = momentum_phases_pk(lat, momenta, src_pos, dens_pk.device)
    phc = torch.complex(ph[0], ph[1])
    dens = torch.complex(dens_pk[0].double(), dens_pk[1].double())
    return torch.einsum("nptzs,ptzs->nt", phc, dens)


def project_all_momenta_fft_pk(dens_pk: torch.Tensor, lat: Lattice,
                               src_pos=(0, 0, 0)) -> torch.Tensor:
    """The full momentum grid from one spatial FFT: complex128 [T, Lz, Ly,
    Lx] with out[t, nz % Lz, ny % Ly, nx % Lx] the phase-sum projection at
    integer momentum (nx, ny, nz)."""
    return _density_fft_full(dens_pk, lat, src_pos)
