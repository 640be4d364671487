"""Lattice geometry and the even-odd parity convention.

Counterpart of ``tpuqcd/lattice.py``.  Direction index mu = 0..3 =
(x, y, z, t); the full site layout is [T, Z, Y, X] (t slowest).

Even-odd convention: parity(x) = (t+z+y+x) % 2, parity 0 ("even") first.
In eo layout the site with full coordinate x lives at xh = x // 2; for
fixed (t, z, y) and parity p the stored x coordinate is
x = 2*xh + ((t + z + y + p) % 2).
"""
from __future__ import annotations

import dataclasses

import torch

#: direction mu -> site-axis position in the full layout [T, Z, Y, X]
AXIS_OF_MU = (3, 2, 1, 0)


@dataclasses.dataclass(frozen=True)
class Lattice:
    """Global lattice geometry, dims = (Lx, Ly, Lz, Lt); Lx must be even."""
    dims: tuple[int, int, int, int]

    def __post_init__(self):
        if len(self.dims) != 4:
            raise ValueError(f"dims must be (Lx, Ly, Lz, Lt), got {self.dims}")
        if self.dims[0] % 2:
            raise ValueError(f"Lx must be even for the eo layout, got {self.dims}")
        object.__setattr__(self, "dims", tuple(int(d) for d in self.dims))

    @property
    def Lx(self) -> int:
        return self.dims[0]

    @property
    def Ly(self) -> int:
        return self.dims[1]

    @property
    def Lz(self) -> int:
        return self.dims[2]

    @property
    def Lt(self) -> int:
        return self.dims[3]

    @property
    def volume(self) -> int:
        return self.Lx * self.Ly * self.Lz * self.Lt

    @property
    def half_volume(self) -> int:
        return self.volume // 2

    @property
    def full_shape(self) -> tuple[int, int, int, int]:
        """Site shape of the full layout: (T, Z, Y, X)."""
        return (self.Lt, self.Lz, self.Ly, self.Lx)

    @property
    def site_shape(self) -> tuple[int, int, int]:
        """Site shape of one parity in the device layout: (T, Z, S)."""
        return (self.Lt, self.Lz, self.Ly * self.Lx // 2)

    def gauge_shape(self) -> tuple[int, ...]:
        """Full-layout gauge [4, T, Z, Y, X, 3, 3]."""
        return (4, *self.full_shape, 3, 3)

    def eo_sub_parity(self, device=None) -> torch.Tensor:
        """bool [T, Z, Y]: (t + z + y) % 2 == 1."""
        t, z, y = (torch.arange(n, device=device) for n in self.full_shape[:3])
        return ((t[:, None, None] + z[None, :, None] + y[None, None, :]) % 2) == 1
