"""Sharded Dslash and operators: face exchange over torch.distributed and
one halo-mode kernel launch per hop.

Counterpart of ``tpuqcd/parallel/sharded.py`` under the fused
communication policy: each hop exchanges the spinor's t and z faces with
the neighbour ranks (``dist.batch_isend_irecv`` on contiguous buffers;
on an axis of one rank the faces are the shard's own boundary slices)
and launches the Dslash kernel in halo mode (ops/dslash_cuda, K6), which
reads them where a leg steps past the local edge.  The gauge faces are
exchanged once per gauge (extend_gauge).

Faces travel as half-spinors (tpuqcd's default): only
(1 -+ gamma_mu) psi enters a leg and the projector has rank 2, so a face
site is 12 reals instead of 24, projected with the tables the launch
uses (swapped under dagger).  The kernel takes the projected spins as
they are, so the hop equals the one on full faces: the projection is
exact in float32 and float64.  bfloat16 faces travel as full spinors: a
projected bfloat16 face would need one more rounding, and its 24 bf16
reals are the 48 B a float32 half-spinor would take.  The operators always
ship half-spinor faces; exchange_faces and cut_halo take ``half=False``
for the tests of the kernel's full-face mode.

Not ported yet (ROADMAP Queue 1 item 13): the interior/exterior overlap
engine (parallel/overlap.py), a y-sharded mesh, ShardedTMCloverOperatorPC.

    lmesh = LatticeMesh.make(lat, nt=2)
    op = ShardedTMOperatorPC(lat, kappa=0.115, mu=0.05, lmesh=lmesh)
    ug = op.extend_gauge(lmesh.shard(u_pk).contiguous())
    y_loc = op.apply(ug, lmesh.shard(psi).contiguous())
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..gammas import HALF_PROJ_MINUS, HALF_PROJ_PLUS
from ..operators import PackedNdegTMOperatorPC, PackedTMOperatorPC
from ..ops.dslash_cuda import Halo, dslash_eo
from .mesh import LatticeMesh


def half_tables(dagger: bool):
    """(forward, backward) projection tables of a launch: the kernel's
    forward legs take (1 - gamma), backward (1 + gamma); dagger swaps."""
    if dagger:
        return HALF_PROJ_PLUS, HALF_PROJ_MINUS
    return HALF_PROJ_MINUS, HALF_PROJ_PLUS


def hproj_pk(psi: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """A 2x4 half-projector (entries 0, +-1, +-i) on a packed spinor
    [2(ri), 4, 3, ...] -> [2(ri), 2, 3, ...], by adds and sign flips."""
    re, im = psi[0], psi[1]
    rows_r, rows_i = [], []
    for s in range(2):
        r = i_ = None
        for k in range(4):
            c = complex(tab[s, k])
            if c == 0:
                continue
            if c.imag == 0:          # +-1
                tr, ti = (re[k], im[k]) if c.real > 0 else (-re[k], -im[k])
            else:                    # +-i: (i b z).re = -b z.im, .im = b z.re
                tr, ti = (-im[k], re[k]) if c.imag > 0 else (im[k], -re[k])
            r = tr if r is None else r + tr
            i_ = ti if i_ is None else i_ + ti
        rows_r.append(r)
        rows_i.append(i_)
    return torch.stack([torch.stack(rows_r), torch.stack(rows_i)])


def _ships_half(half: bool, dtype: torch.dtype) -> bool:
    """Whether faces of ``dtype`` travel as half-spinors (module docstring)."""
    return half and dtype != torch.bfloat16


def _pack_faces(lo: torch.Tensor, hi: torch.Tensor, mu: int, dagger: bool, half: bool):
    """The slices a shard sends: its last slice (the t-1 or z-1 face of
    the rank above, read by backward legs) and its first (the t+1 or z+1
    face of the rank below, read by forward legs), contiguous, projected
    when ``half``."""
    if not _ships_half(half, lo.dtype):
        return lo.contiguous(), hi.contiguous()
    fwd, bwd = half_tables(dagger)
    return hproj_pk(lo, bwd[mu]), hproj_pk(hi, fwd[mu])


def _ring(lmesh: LatticeMesh, axis: str, up: torch.Tensor, down: torch.Tensor | None):
    """Send ``up`` to the next rank along ``axis`` and ``down`` to the
    previous one; returns (what the previous rank sent up, what the next
    rank sent down).  The receive from below is this shard's -1 face.  On
    an axis of one rank the shard is its own neighbour."""
    n = lmesh.nt if axis == "t" else lmesh.nz
    if n == 1:
        return up, down
    nxt, prv = lmesh.neighbour(axis, +1), lmesh.neighbour(axis, -1)
    from_below = torch.empty_like(up)
    ops = [dist.P2POp(dist.isend, up, nxt, tag=0), dist.P2POp(dist.irecv, from_below, prv, tag=0)]
    from_above = None
    if down is not None:
        from_above = torch.empty_like(down)
        ops += [dist.P2POp(dist.isend, down, prv, tag=1),
                dist.P2POp(dist.irecv, from_above, nxt, tag=1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_below, from_above


def exchange_faces(lmesh: LatticeMesh, psi: torch.Tensor, dagger: bool, half: bool = True):
    """The four spinor faces of a local spinor [2(ri), 4, 3, T, Z, S]:
    (t-1, t+1, z-1, z+1), each [2(ri), ns, 3, Z or T, S]; ns = 2 with
    ``half``, but for bfloat16."""
    t_m, t_p = _ring(lmesh, "t", *_pack_faces(psi[:, :, :, -1], psi[:, :, :, 0], 3, dagger, half))
    z_m, z_p = _ring(lmesh, "z", *_pack_faces(psi[..., -1, :], psi[..., 0, :], 2, dagger, half))
    return t_m, t_p, z_m, z_p


@dataclasses.dataclass(frozen=True)
class HaloGauge:
    """A shard's gauge with the links its backward legs read across an
    edge: u [4, 2, R, 3, 2, T, Z, S] local; u_t [2(par), R, 3, 2, Z, S]
    the mu=3 links of the t-1 face; u_z [2(par), R, 3, 2, T, S] the mu=2
    links of the z-1 face."""
    u: torch.Tensor
    u_t: torch.Tensor
    u_z: torch.Tensor

    def to(self, dtype: torch.dtype, rows: int = 3) -> "HaloGauge":
        """The same gauge in ``dtype``; rows=2 keeps the reconstruct-12 rows."""
        return HaloGauge(self.u[:, :, :rows].to(dtype).contiguous(),
                         self.u_t[:, :rows].to(dtype).contiguous(),
                         self.u_z[:, :rows].to(dtype).contiguous())


def extend_gauge(lmesh: LatticeMesh, u_loc: torch.Tensor) -> HaloGauge:
    """The one-time gauge exchange: the mu=3 links of the rank below's
    last t slice and the mu=2 links of its last z slice, both parities."""
    u_t, _ = _ring(lmesh, "t", u_loc[3, :, :, :, :, -1].contiguous(), None)
    u_z, _ = _ring(lmesh, "z", u_loc[2, :, :, :, :, :, -1].contiguous(), None)
    return HaloGauge(u_loc.contiguous(), u_t, u_z)


def cut_halo(lmesh: LatticeMesh, u: torch.Tensor, psi: torch.Tensor, src_parity: int,
             dagger: bool = False, half: bool = True):
    """One-process emulation of a shard's exchange: its local gauge and
    spinor and the Halo it would receive, cut from the global gauge
    [4, 2, R, 3, 2, Lt, Lz, S] and spinor [2(ri), 4, 3, Lt, Lz, S] (what
    chip_smoke.py and the tests hold the kernel's halo mode with)."""
    if lmesh.ny != 1:
        raise NotImplementedError("a y-sharded mesh (ROADMAP Queue 1 item 13)")
    it, iz, _ = lmesh.coords
    (Tl, Zl), T, Z = lmesh.local_dims, lmesh.lat.Lt, lmesh.lat.Lz
    ts, zs = slice(it * Tl, (it + 1) * Tl), slice(iz * Zl, (iz + 1) * Zl)
    tm, tp, zm, zp = (it * Tl - 1) % T, (it + 1) * Tl % T, (iz * Zl - 1) % Z, (iz + 1) * Zl % Z
    fwd, bwd = half_tables(dagger)

    def face(x, mu, table):
        return hproj_pk(x, table[mu]) if _ships_half(half, x.dtype) else x.contiguous()

    halo = Halo(face(psi[:, :, :, tm, zs], 3, bwd), face(psi[:, :, :, tp, zs], 3, fwd),
                face(psi[:, :, :, ts, zm], 2, bwd), face(psi[:, :, :, ts, zp], 2, fwd),
                u[3, src_parity, :, :, :, tm, zs].contiguous(),
                u[2, src_parity, :, :, :, ts, zm].contiguous(), lmesh.t_offset, T)
    return u[..., ts, zs, :].contiguous(), psi[..., ts, zs, :].contiguous(), halo


def _check_mesh(lmesh: LatticeMesh | None):
    if lmesh is None:
        raise ValueError("a sharded operator needs lmesh")
    if lmesh.ny != 1:
        raise NotImplementedError("a y-sharded mesh needs the overlap engine, which is not "
                                  "ported yet (ROADMAP Queue 1 item 13)")


def sharded_hop(lmesh: LatticeMesh, ug: HaloGauge, psi: torch.Tensor, parity: int,
                dagger: bool = False, **kw) -> torch.Tensor:
    """One face exchange (half-spinor faces) and one halo-mode launch on a
    shard; ``kw`` are dslash_eo's epilogue arguments."""
    t_m, t_p, z_m, z_p = exchange_faces(lmesh, psi, dagger)
    halo = Halo(t_m, t_p, z_m, z_p, ug.u_t[parity], ug.u_z[parity], lmesh.t_offset,
                lmesh.lat.Lt)
    return dslash_eo(ug.u, psi, parity, lmesh.local_lat, dagger=dagger, halo=halo, **kw)


@dataclasses.dataclass(frozen=True)
class ShardedTMOperatorPC(PackedTMOperatorPC):
    """PackedTMOperatorPC on a shard of a LatticeMesh: the same Schur
    operator (apply, apply_dagger, normal, prepare, reconstruct,
    apply_full) on local fields, every hop through sharded_hop.  ``u`` is
    a HaloGauge (extend_gauge); the same class serves the sloppy operator
    (reconstruct-12 rows, float32) and the float64 certification one."""
    lmesh: LatticeMesh | None = None

    def __post_init__(self):
        _check_mesh(self.lmesh)

    def extend_gauge(self, u_loc: torch.Tensor) -> HaloGauge:
        return extend_gauge(self.lmesh, u_loc)

    def _hop(self, u, psi, parity, dagger=False, epilogue="none", flavor=None, psi0=None,
             xpay_scale=None):
        return sharded_hop(self.lmesh, u, psi, parity, dagger, epilogue=epilogue,
                           kappa=self.kappa, mu=self.mu,
                           flavor=self.flavor if flavor is None else flavor, psi0=psi0,
                           t_boundary=self.t_boundary, xpay_scale=xpay_scale)


@dataclasses.dataclass(frozen=True)
class ShardedNdegTMOperatorPC(PackedNdegTMOperatorPC):
    """PackedNdegTMOperatorPC on a shard of a LatticeMesh: the
    flavor-diagonal hop goes through sharded_hop, one launch per flavor;
    the flavor-mixing site terms are site-local and need no exchange."""
    lmesh: LatticeMesh | None = None

    def __post_init__(self):
        _check_mesh(self.lmesh)

    def extend_gauge(self, u_loc: torch.Tensor) -> HaloGauge:
        return extend_gauge(self.lmesh, u_loc)

    def _hop(self, u, chi, parity, dagger):
        return torch.stack([sharded_hop(self.lmesh, u, chi[f], parity, dagger,
                                        t_boundary=self.t_boundary) for f in (0, 1)])
