"""Adaptive multigrid on a LatticeMesh: the sharded fine level and its
transfer.

Counterpart of ``tpuqcd/mg/shard.py``.  The fine level holds the
shard's fields [2(ri), 2(par), 4, 3, T, Z, S] of the local lattice and
runs its hops through parallel/sharded.sharded_hop under the run's
communication policy (fused K6 launches, or the overlap engine); its
reductions sum over the ranks (mg/dsolve.DeviceMG._scope).  The coarse
levels are replicated, as in tpuqcd: each rank restricts its own
aggregates (a block never straddles a shard, utils/config checks it),
one all-gather assembles the global coarse vector, every rank runs the
same coarse solve on it, and the prolongation takes the rank's own
aggregates back.  Random fields (the null vectors' starts) are drawn
whole from the generator on every rank, which keeps its shard, so that a
mesh of any shape draws what one card draws.

    lv = ShardedFineLevel.build(lmesh, u_loc, kappa, mu, flavor=+1)
    mg = DeviceMG(lv, params)          # setup, V-cycle, certified solve
    x_loc = mg.solve_certified(b_loc).x
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..lattice import Lattice
from ..ops.dslash_cuda import LEG_ORDER
from ..parallel.mesh import LatticeMesh
from ..parallel.sharded import HaloGauge, check_policy, extend_gauge, sharded_hop
from .device import DeviceFineTransfer, _par


class ShardedFineTransfer(DeviceFineTransfer):
    """DeviceFineTransfer of the shard's aggregates (from_pk builds it);
    restrict returns and prolong takes the GLOBAL coarse field [(B,) 2, N,
    Vc] (dims_c and Vc are the global coarse lattice's)."""

    @classmethod
    def from_pk(cls, lmesh: LatticeMesh, block, v_pk: torch.Tensor) -> "ShardedFineTransfer":
        """From the rank's null vectors [n, 2, 2, 4, 3, T, Z, S] of the local
        lattice, float32 or (a bfloat16 bank) bfloat16."""
        tr = cls.__new__(cls)
        tr.lmesh, tr.lat, tr.block = lmesh, lmesh.local_lat, tuple(int(b) for b in block)
        DeviceFineTransfer.__init__(tr, lmesh.local_lat, block, tr._bank_from_pk(v_pk))
        return tr

    @property
    def local_dims_c(self):
        return super().dims_c

    @property
    def dims_c(self):
        bt, bz, by, bx = self.block
        lat = self.lmesh.lat
        return (lat.Lt // bt, lat.Lz // bz, lat.Ly // by, lat.Lx // bx)

    def _geom(self):
        bt, bz, by, bx = self.block
        Tc, Zc, Yc, Xc = self.local_dims_c
        return Tc, bt, Zc, bz, Yc, by, Xc, bx // 2

    def _own(self, coords):
        """The slices of a rank's aggregates in a global coarse field
        [..., Tc, Zc, Yc, Xc]."""
        it, iz, iy = coords
        tc, zc, yc, _ = self.local_dims_c
        return (..., slice(it * tc, (it + 1) * tc), slice(iz * zc, (iz + 1) * zc),
                slice(iy * yc, (iy + 1) * yc), slice(None))

    def restrict(self, r: torch.Tensor) -> torch.Tensor:
        local = super().restrict(r)                       # [(B,) 2, N, Vc_local]
        m = self.lmesh
        if m.size == 1:
            return local
        local = local.contiguous()
        parts = [torch.empty_like(local) for _ in range(m.size)]
        dist.all_gather(parts, local)
        out = local.new_empty((*local.shape[:-1], self.Vc))
        out4 = out.unflatten(-1, self.dims_c)
        for rank, part in enumerate(parts):
            coords = LatticeMesh(m.lat, m.nt, m.nz, m.ny, rank).coords
            out4[self._own(coords)] = part.unflatten(-1, self.local_dims_c)
        return out

    def prolong(self, xc: torch.Tensor) -> torch.Tensor:
        own = xc.unflatten(-1, self.dims_c)[self._own(self.lmesh.coords)]
        return super().prolong(own.flatten(-4))


@dataclasses.dataclass(frozen=True)
class ShardedFineLevel:
    """The twisted-mass or, with ``clover_pk``, twisted-clover fine level
    M = (A + 2 i kappa mu f g5) - kappa D on a shard (tpuqcd/mg/shard.py:43-232),
    a drop-in for mg/device.DeviceFineLevel under mg/dsolve.DeviceMG.

    ``lat`` is the shard's local lattice; ``ug`` the HaloGauge of the
    18-real gauge (float32; float64 in the ``as_hp`` twin), whose
    reconstruct-12 copy ``ug12`` the float32 and bfloat16 applies read;
    clover_pk the shard's A blocks [2(par), 2(ri), 2(chir), 6, 6, T, Z, S]
    in the dtype of the links the apply reads.  The Galerkin probing takes
    the 8 legs one dirs launch each (K4 legs_out does not compose with halo
    mode), restricted together as on one card."""
    lat: Lattice
    lmesh: LatticeMesh
    ug: HaloGauge
    kappa: float
    mu: float = 0.0
    flavor: int = +1
    t_boundary: int = -1
    comm_policy: str = "fused"
    clover_pk: torch.Tensor | None = None
    ug12: HaloGauge | None = None

    def __post_init__(self):
        check_policy(self.lmesh, self.comm_policy)
        if self.ug12 is None and self.ug.u.dtype != torch.float64:
            object.__setattr__(self, "ug12", self.ug.to(torch.float32, rows=2))

    @staticmethod
    def build(lmesh: LatticeMesh, u_loc: torch.Tensor, kappa: float, mu: float = 0.0,
              flavor: int = +1, t_boundary: int = -1, comm_policy: str = "fused",
              clover_pk: torch.Tensor | None = None) -> "ShardedFineLevel":
        """The level from this rank's float32 gauge shard [4, 2, 3, 3, 2, T,
        Z, S] (its faces exchanged once here) and clover shard."""
        ug = extend_gauge(lmesh, u_loc.to(torch.float32))
        cl = None if clover_pk is None else clover_pk.to(torch.float32).contiguous()
        return ShardedFineLevel(lmesh.local_lat, lmesh, ug, kappa, mu, flavor, t_boundary,
                                comm_policy, cl)

    @property
    def n(self) -> int:
        return 12

    @property
    def device(self) -> torch.device:
        return self.ug.u.device

    def _dslash(self, v, p, out, **kw):
        """The hop into parity p of ``out`` from parity 1 - p of v."""
        return sharded_hop(self.lmesh, self.ug if self.ug12 is None else self.ug12,
                           _par(v, 1 - p), 1 - p, False, self.comm_policy, kappa=self.kappa,
                           mu=self.mu, flavor=self.flavor, t_boundary=self.t_boundary, out=out,
                           **kw)

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        """M v, one xpay (clover_xpay) hop per parity."""
        out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
        for p in (0, 1):
            if self.clover_pk is None:
                self._dslash(v, p, _par(out, p), epilogue="xpay", psi0=_par(v, p),
                             xpay_scale=self.kappa)
            else:
                self._dslash(v, p, _par(out, p), epilogue="clover_xpay", psi0=_par(v, p),
                             xpay_scale=self.kappa, clover=self.clover_pk[p])
        return out

    def apply_hop(self, v: torch.Tensor, mu: int, sign: int) -> torch.Tensor:
        """One hop term of M (including the -kappa), both parities."""
        out = torch.empty_like(v)
        for p in (0, 1):
            self._dslash(v, p, _par(out, p), dirs=((mu, sign),))
        return out.mul_(-self.kappa)

    def apply_hop_all(self, v: torch.Tensor) -> torch.Tensor:
        """All 8 hop terms of M in LEG_ORDER -> [8, 2(ri), 2(par), ...]:
        one dirs launch per leg and parity."""
        out = torch.empty((8, *v.shape), dtype=v.dtype, device=v.device)
        for i, (mu, sign) in enumerate(LEG_ORDER):
            for p in (0, 1):
                self._dslash(v, p, _par(out[i], p), dirs=((mu, sign),))
        return out.mul_(-self.kappa)

    def as_hp(self) -> "ShardedFineLevel":
        """The float64 twin on the 18-real gauge and the promoted blocks."""
        cl = None if self.clover_pk is None else self.clover_pk.to(torch.float64)
        return dataclasses.replace(self, ug=self.ug.to(torch.float64), ug12=None, clover_pk=cl)

    def sloppy(self, dtype: torch.dtype = torch.bfloat16) -> "ShardedFineLevel":
        """The smoother's twin: reconstruct-12 links and clover blocks in dtype."""
        cl = None if self.clover_pk is None else self.clover_pk.to(dtype)
        return dataclasses.replace(self, ug12=self.ug12.to(dtype, rows=2), clover_pk=cl)

    def random_field(self, generator: torch.Generator) -> torch.Tensor:
        """The global Gaussian field of a one-card level's random_field,
        drawn whole on every rank; this rank's shard of it."""
        shape = (2, 2, 4, 3, *self.lmesh.lat.site_shape)
        v = torch.randn(shape, generator=generator, dtype=torch.float32, device=self.device)
        return self.lmesh.shard(v).contiguous()

    def transfer(self, block, v_pk: torch.Tensor) -> ShardedFineTransfer:
        return ShardedFineTransfer.from_pk(self.lmesh, block, v_pk)
