"""Lattice mesh over the torch.distributed process group.

Counterpart of ``tpuqcd/parallel/mesh.py``.  The ranks form a (t, z, y)
grid over the device-layout site axes [T, Z, S] (S = Y * X/2 is y-major,
so a y-chunk of S is a y-decomposition), in tpuqcd's device order: rank =
(it * nz + iz) * ny + iy.  Each rank holds the local block of extent
(Lt/nt, Lz/nz, Ly/ny); every local extent that is split is even, so the
even-odd checkerboard in local coordinates is the global one.  Face
exchange is in parallel/sharded.py (split from the compute in
parallel/overlap.py; the ghost layer of the smearing and the covariant
derivative there too); reductions over the mesh in solvers/reductions.py.

    lmesh = LatticeMesh.make(lat, nt=2, nz=2)     # needs a group of 4 ranks
    psi_loc = lmesh.shard(psi)                    # [..., T, Z, S] -> local block
    psi = lmesh.gather(psi_loc)                   # rank 0: the whole field
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..lattice import Lattice
from . import dist as tdist


@dataclasses.dataclass(frozen=True)
class LatticeMesh:
    """A (t, z, y) grid of ranks bound to a lattice geometry; ``rank`` is
    this process's place in it (ny = 1 gives the (t, z) decomposition).
    Build it with make(), which checks the grid against the process group;
    a mesh built directly with another rank describes that rank's shard
    (the one-process emulation of chip_smoke.py and the tests)."""
    lat: Lattice
    nt: int
    nz: int = 1
    ny: int = 1
    rank: int = 0

    def __post_init__(self):
        lat, nt, nz, ny = self.lat, self.nt, self.nz, self.ny
        if min(nt, nz, ny) < 1 or lat.Lt % nt or lat.Lz % nz or lat.Ly % ny:
            raise ValueError(f"mesh ({nt}, {nz}, {ny}) must divide (Lt, Lz, Ly) = "
                             f"{(lat.Lt, lat.Lz, lat.Ly)}")
        # even local extents keep the eo checkerboard identical on every shard
        if (lat.Lt // nt) % 2:
            raise ValueError(f"local T = {lat.Lt // nt} must be even")
        if nz > 1 and (lat.Lz // nz) % 2:
            raise ValueError(f"local Z = {lat.Lz // nz} must be even")
        if ny > 1 and (lat.Ly // ny) % 2:
            raise ValueError(f"local Y = {lat.Ly // ny} must be even")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside the mesh of {self.size}")

    @staticmethod
    def make(lat: Lattice, nt: int, nz: int = 1, ny: int = 1) -> "LatticeMesh":
        """The mesh of this process; nt * nz * ny must equal the world size
        (1 without a process group)."""
        n = tdist.world_size()
        if nt * nz * ny != n:
            raise ValueError(f"mesh {nt} x {nz} x {ny} needs {nt * nz * ny} ranks, the "
                             f"process group has {n}")
        return LatticeMesh(lat, nt, nz, ny, tdist.rank())

    @property
    def size(self) -> int:
        return self.nt * self.nz * self.ny

    @property
    def coords(self) -> tuple[int, int, int]:
        """(it, iz, iy) of this rank."""
        r = self.rank
        return r // (self.nz * self.ny), (r // self.ny) % self.nz, r % self.ny

    def rank_of(self, it: int, iz: int, iy: int = 0) -> int:
        return ((it % self.nt) * self.nz + iz % self.nz) * self.ny + iy % self.ny

    def neighbour(self, axis: str, step: int) -> int:
        """The rank ``step`` places along ``axis`` ("t", "z" or "y"), periodic."""
        it, iz, iy = self.coords
        d = {"t": (step, 0, 0), "z": (0, step, 0), "y": (0, 0, step)}[axis]
        return self.rank_of(it + d[0], iz + d[1], iy + d[2])

    def axis_size(self, axis: str) -> int:
        return {"t": self.nt, "z": self.nz, "y": self.ny}[axis]

    @property
    def local_dims(self) -> tuple[int, int]:
        return self.lat.Lt // self.nt, self.lat.Lz // self.nz

    @property
    def local_y(self) -> int:
        return self.lat.Ly // self.ny

    @property
    def local_lat(self) -> Lattice:
        """The shard's own lattice (Lx, Ly/ny, Lz/nz, Lt/nt)."""
        Tl, Zl = self.local_dims
        return Lattice((self.lat.Lx, self.local_y, Zl, Tl))

    @property
    def t_offset(self) -> int:
        """The shard's global t."""
        return self.coords[0] * self.local_dims[0]

    @property
    def z_offset(self) -> int:
        """The shard's global z."""
        return self.coords[1] * self.local_dims[1]

    @property
    def y_offset(self) -> int:
        """The shard's global y."""
        return self.coords[2] * self.local_y

    def holds_t(self, t: int) -> bool:
        """Whether timeslice t lies in this rank's block; all ranks of one
        t-block (every z and y of it) hold the same timeslices."""
        return 0 <= int(t) - self.t_offset < self.local_dims[0]

    def _block(self, it: int, iz: int, iy: int):
        Tl, Zl = self.local_dims
        Sl = self.local_y * self.lat.Lx // 2
        return (slice(it * Tl, (it + 1) * Tl), slice(iz * Zl, (iz + 1) * Zl),
                slice(iy * Sl, (iy + 1) * Sl))

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a field whose last axes are [T, Z, S] (a view)."""
        return x[(..., *self._block(*self.coords))]

    def _assemble(self, parts) -> torch.Tensor:
        """The whole field from every rank's block, in rank order."""
        T, Z, S = self.lat.Lt, self.lat.Lz, self.lat.Ly * self.lat.Lx // 2
        out = parts[0].new_empty((*parts[0].shape[:-3], T, Z, S))
        for r, part in enumerate(parts):
            blk = LatticeMesh(self.lat, self.nt, self.nz, self.ny, r)
            out[(..., *blk._block(*blk.coords))] = part
        return out

    def all_gather(self, x_loc: torch.Tensor) -> torch.Tensor:
        """The whole field on every rank from every rank's block."""
        if self.size == 1:
            return x_loc
        x_loc = x_loc.contiguous()
        parts = [torch.empty_like(x_loc) for _ in range(self.size)]
        dist.all_gather(parts, x_loc)
        return self._assemble(parts)

    def gather(self, x_loc: torch.Tensor) -> torch.Tensor | None:
        """The whole field on rank 0 from every rank's block (None on the
        other ranks); a mesh of one rank returns its block."""
        if self.size == 1:
            return x_loc
        x_loc = x_loc.contiguous()
        parts = [torch.empty_like(x_loc) for _ in range(self.size)] if self.rank == 0 else None
        dist.gather(x_loc, parts, dst=0)
        if self.rank != 0:
            return None
        return self._assemble(parts)
