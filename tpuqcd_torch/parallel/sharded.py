"""Sharded Dslash and operators: face exchange over torch.distributed and
one halo-mode kernel launch per hop, or the interior/exterior split.

Counterpart of ``tpuqcd/parallel/sharded.py``.  Under the ``fused``
communication policy each hop exchanges the spinor's t and z faces with
the neighbour ranks (``dist.batch_isend_irecv`` on contiguous buffers;
on an axis of one rank the faces are the shard's own boundary slices)
and launches the Dslash kernel in halo mode (ops/dslash_cuda, K6), which
reads them where a leg steps past the local edge.  Under ``overlap`` the
hop goes through parallel/overlap.py: the faces are posted first, the
kernel runs on the local lattice with local-periodic wraps while they
travel, and the boundary slabs are repaired once they arrive.  A
y-sharded mesh takes ``overlap``: K6 has no y faces.  The gauge faces
are exchanged once per gauge (extend_gauge).

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

The physics programs' spatial hops (the Gaussian smearing) and covariant
derivatives read their neighbours from a ghost layer instead: a block
extended by one site on both sides of chosen axes, filled with the
neighbours' unprojected boundary slices (exchange_ghosts) or, for the
gauge that every rank holds whole, cut from it (ghost_block), and read
through ghost_tables.

    lmesh = LatticeMesh.make(lat, nt=2)
    op = ShardedTMOperatorPC(lat, kappa=0.115, mu=0.05, lmesh=lmesh)
    ug = op.extend_gauge(lmesh.shard(u_pk).contiguous())
    y_loc = op.apply(ug, lmesh.shard(psi).contiguous())
    op = ShardedTMCloverOperatorPC(lat, kappa=0.115, mu=0.05, lmesh=lmesh,
                                   comm_policy="overlap")
    fields = op.extend_fields(u_loc, cl_loc, clinv_plus_loc, clinv_minus_loc)
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist

from ..gammas import HALF_PROJ_MINUS, HALF_PROJ_PLUS
from ..operators import PackedNdegTMOperatorPC, PackedTMCloverOperatorPC, PackedTMOperatorPC
from ..ops.dslash_cuda import Halo, dslash_eo
from .mesh import LatticeMesh

#: the communication policies: the K6 halo launch, or the interior/exterior split
COMM_POLICIES = ("fused", "overlap")
#: the axes of the spinor faces, their direction mu and site dim of [T, Z, S]
FACE_AXES = (("t", 3), ("z", 2), ("y", 1))


def half_tables(dagger: bool):
    """(forward, backward) projection tables of a launch: the kernel's
    forward legs take (1 - gamma), backward (1 + gamma); dagger swaps."""
    if dagger:
        return HALF_PROJ_PLUS, HALF_PROJ_MINUS
    return HALF_PROJ_MINUS, HALF_PROJ_PLUS


@functools.lru_cache(maxsize=None)
def _projector_terms(entries: tuple, device: torch.device, dtype: torch.dtype):
    """A 2x4 complex half-projector (``entries`` row-major; 0, +-1, +-i, two
    of them not 0 in each row) acting on a packed spinor, as the two terms
    of each of its 4 real outputs (re and im of 2 spins): the packed input
    rows (ri, spin) of the first terms, then of the second [8], and their
    signs [2, 4, 1] on ``device``."""
    c = torch.tensor(entries, dtype=torch.complex128).reshape(2, 4)
    m = torch.stack([torch.cat([c.real, -c.imag], 1),
                     torch.cat([c.imag, c.real], 1)]).reshape(4, 8)
    rows = torch.stack([torch.nonzero(r).flatten() for r in m])        # [4, 2]
    sign = torch.gather(m, 1, rows)
    return (rows.T.reshape(8).to(device),
            sign.T.reshape(2, 4, 1).to(device=device, dtype=dtype))


def hproj_pk(psi: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """A 2x4 half-projector (entries 0, +-1, +-i) on a packed spinor
    [2(ri), 4, 3, ...] -> [2(ri), 2, 3, ...]: each output is a sum of two
    input rows with signs, exact.  One gather of the 8 terms, one product
    with the signs and one sum of the pairs (a boundary slice's (ri, spin)
    rows merge into one axis without a copy)."""
    rows, sign = _projector_terms(tuple(tab.flatten().tolist()), psi.device, psi.dtype)
    terms = psi.flatten(0, 1).index_select(0, rows)
    return (terms.view(2, 4, -1) * sign).sum(0).view(2, 2, *psi.shape[2:])


def _ships_half(half: bool, dtype: torch.dtype) -> bool:
    """Whether faces of ``dtype`` travel as half-spinors (module docstring)."""
    return half and dtype != torch.bfloat16


def boundary_slice(x: torch.Tensor, axis: str, first: bool, xh: int) -> torch.Tensor:
    """The first or last slice of a field [..., T, Z, S] along ``axis``,
    the slice dim kept; a y slice is the Xh-wide row at the start or the
    end of the y-major S axis."""
    if axis == "t":
        return x[..., :1, :, :] if first else x[..., -1:, :, :]
    if axis == "z":
        return x[..., :1, :] if first else x[..., -1:, :]
    return x[..., :xh] if first else x[..., -xh:]


def _face(x: torch.Tensor, axis: str, mu: int, table, half: bool) -> torch.Tensor:
    """A face slab as it travels: t and z faces without their unit dim
    ([2(ri), ns, 3, Z, S] or [.., T, S]), y faces [2(ri), ns, 3, T, Z, Xh];
    projected with ``table`` when half-spinors ship."""
    if axis == "t":
        x = x[..., 0, :, :]
    elif axis == "z":
        x = x[..., 0, :]
    return hproj_pk(x, table[mu]) if _ships_half(half, x.dtype) else x.contiguous()


def pack_faces(lmesh: LatticeMesh, psi: torch.Tensor, dagger: bool, half: bool = True,
               axes=("t", "z", "y")):
    """The faces a shard sends along ``axes``, by axis: (its last slice,
    read by the backward legs of the rank above; its first slice, read by
    the forward legs of the rank below), projected when ``half``."""
    fwd, bwd = half_tables(dagger)
    xh = lmesh.lat.Lx // 2
    return {axis: (_face(boundary_slice(psi, axis, False, xh), axis, mu, bwd, half),
                   _face(boundary_slice(psi, axis, True, xh), axis, mu, fwd, half))
            for axis, mu in FACE_AXES if axis in axes}


def _p2p_ops(lmesh: LatticeMesh, axis: str, up: torch.Tensor, down: torch.Tensor | None,
             tag: int):
    """The sends and receives of one axis' ring; returns (ops, the buffer
    for what the previous rank sent up, the buffer for what the next rank
    sent down)."""
    nxt, prv = lmesh.neighbour(axis, +1), lmesh.neighbour(axis, -1)
    from_below = torch.empty_like(up)
    ops = [dist.P2POp(dist.isend, up, nxt, tag=tag),
           dist.P2POp(dist.irecv, from_below, prv, tag=tag)]
    from_above = None
    if down is not None:
        from_above = torch.empty_like(down)
        ops += [dist.P2POp(dist.isend, down, prv, tag=tag + 1),
                dist.P2POp(dist.irecv, from_above, nxt, tag=tag + 1)]
    return ops, from_below, from_above


def _ring(lmesh: LatticeMesh, axis: str, up: torch.Tensor, down: torch.Tensor | None):
    """Send ``up`` to the next rank along ``axis`` and ``down`` to the
    previous one; returns (what the previous rank sent up, what the next
    rank sent down).  The receive from below is this shard's -1 face.  On
    an axis of one rank the shard is its own neighbour."""
    if lmesh.axis_size(axis) == 1:
        return up, down
    ops, from_below, from_above = _p2p_ops(lmesh, axis, up, down, 0)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_below, from_above


def exchange_faces(lmesh: LatticeMesh, psi: torch.Tensor, dagger: bool, half: bool = True):
    """The spinor faces of a local spinor [2(ri), 4, 3, T, Z, S]: (t-1,
    t+1, z-1, z+1), each [2(ri), ns, 3, Z or T, S], and on a y-sharded
    mesh y-1, y+1 [2(ri), ns, 3, T, Z, Xh] after them; ns = 2 with
    ``half``, but for bfloat16."""
    axes = ("t", "z", "y") if lmesh.ny > 1 else ("t", "z")
    sent = pack_faces(lmesh, psi, dagger, half, axes)
    return tuple(f for axis in axes for f in _ring(lmesh, axis, *sent[axis]))


@dataclasses.dataclass(frozen=True)
class HaloGauge:
    """A shard's gauge with the links its backward legs read across an
    edge: u [4, 2, R, 3, 2, T, Z, S] local; u_t [2(par), R, 3, 2, Z, S]
    the mu=3 links of the t-1 face; u_z [2(par), R, 3, 2, T, S] the mu=2
    links of the z-1 face; on a y-sharded mesh u_y [2(par), R, 3, 2, T, Z,
    Xh] the mu=1 links of the y-1 face."""
    u: torch.Tensor
    u_t: torch.Tensor
    u_z: torch.Tensor
    u_y: torch.Tensor | None = None

    def to(self, dtype: torch.dtype, rows: int = 3) -> "HaloGauge":
        """The same gauge in ``dtype``; rows=2 keeps the reconstruct-12 rows."""
        def cast(x, lead):
            if x is None:
                return None
            return x[(slice(None),) * lead + (slice(0, rows),)].to(dtype).contiguous()
        return HaloGauge(cast(self.u, 2), cast(self.u_t, 1), cast(self.u_z, 1),
                         cast(self.u_y, 1))

    def halo(self, lmesh: LatticeMesh, faces, parity: int) -> Halo:
        """The Halo of a hop from source parity ``parity`` with the spinor
        faces of exchange_faces (or overlap.PendingFaces.wait)."""
        y = (*faces[4:6], self.u_y[parity]) if lmesh.ny > 1 else ()
        return Halo(*faces[:4], self.u_t[parity], self.u_z[parity], lmesh.t_offset,
                    lmesh.lat.Lt, *y)


def extend_gauge(lmesh: LatticeMesh, u_loc: torch.Tensor) -> HaloGauge:
    """The one-time gauge exchange: the mu=3 links of the rank below's
    last t slice, the mu=2 links of its last z slice and, on a y-sharded
    mesh, the mu=1 links of its last y row, both parities."""
    u_t, _ = _ring(lmesh, "t", u_loc[3, :, :, :, :, -1].contiguous(), None)
    u_z, _ = _ring(lmesh, "z", u_loc[2, :, :, :, :, :, -1].contiguous(), None)
    u_y = None
    if lmesh.ny > 1:
        u_y, _ = _ring(lmesh, "y", u_loc[1, ..., -(lmesh.lat.Lx // 2):].contiguous(), None)
    return HaloGauge(u_loc.contiguous(), u_t, u_z, u_y)


#: the site dim of each mesh axis in a field [..., T, Z, S]
_SITE_DIM = {"t": -3, "z": -2, "y": -1}


def exchange_ghosts(lmesh: LatticeMesh, x: torch.Tensor, axes=("t", "z", "y")) -> torch.Tensor:
    """A local field [..., T, Z, S] (real or complex, any leading dims) with
    a ghost layer one site deep on both sides of each of ``axes``: the
    neighbours' boundary slices, unprojected, one _ring a axis.  The axes
    go in t, z, y order, so a later axis' slices carry the earlier ghosts
    and the layer's edges are filled too.  Returns [..., T + 2, Z + 2,
    (Y + 2) Xh] on the padded axes, in the global even-odd packing; on an
    axis of one rank the ghosts are the block's own far slices."""
    xh = lmesh.lat.Lx // 2
    for axis in ("t", "z", "y"):
        if axis not in axes:
            continue
        last, first = (boundary_slice(x, axis, f, xh).contiguous() for f in (False, True))
        if x.is_complex():
            below, above = _ring(lmesh, axis, torch.view_as_real(last), torch.view_as_real(first))
            below, above = torch.view_as_complex(below), torch.view_as_complex(above)
        else:
            below, above = _ring(lmesh, axis, last, first)
        x = torch.cat([below, x, above], dim=_SITE_DIM[axis])
    return x


def ghost_block(lmesh: LatticeMesh, x: torch.Tensor, axes=("t", "z", "y")) -> torch.Tensor:
    """This rank's block of a whole field [..., Lt, Lz, S] with the ghost
    layer of exchange_ghosts, cut without communication: the gauge, which
    every rank holds whole."""
    lat, xh, dev = lmesh.lat, lmesh.lat.Lx // 2, x.device
    (Tl, Zl), Yl = lmesh.local_dims, lmesh.local_y

    def span(axis, lo, n, total):
        pad = int(axis in axes)
        return torch.arange(lo - pad, lo + n + pad, device=dev) % total
    t = span("t", lmesh.t_offset, Tl, lat.Lt)
    z = span("z", lmesh.z_offset, Zl, lat.Lz)
    y = span("y", lmesh.y_offset, Yl, lat.Ly)
    s = (y[:, None] * xh + torch.arange(xh, device=dev)).reshape(-1)
    return x.index_select(-3, t).index_select(-2, z).index_select(-1, s)


def ghost_tables(site_shape, lx: int, axes=("t", "z", "y"), device=None):
    """ops/gauge_tools.neighbour_tables of a block [T, Z, S] inside its
    ghost layer along ``axes``: tables[sp][mu, 0 | 1] gathers f(x + mu) |
    f(x - mu) of the extended field (exchange_ghosts, ghost_block) on
    parity sp, flattened over its sites, onto the block's sites of parity
    1 - sp.  A leg along an axis without ghosts wraps within the block,
    which must then hold that axis whole (x always)."""
    T, Z, S = (int(v) for v in site_shape)
    xh_n = lx // 2
    Y = S // xh_n
    pt, pz, py = (int(a in axes) for a in ("t", "z", "y"))
    Ze, Ye = Z + 2 * pz, Y + 2 * py
    ar = lambda n: torch.arange(n, device=device)  # noqa: E731
    t, z = ar(T)[:, None, None, None], ar(Z)[None, :, None, None]
    y, xh = ar(Y)[None, None, :, None], ar(xh_n)[None, None, None, :]

    def flat(t_, z_, y_, x_):
        return (((t_ * Ze + z_) * Ye + y_) * xh_n + x_).expand(T, Z, Y, xh_n).reshape(-1)

    def step(c, n, pad, d):
        return c + pad + d if pad else (c + d) % n

    tables = []
    for sp in (0, 1):
        o_p = (t + z + y + sp) % 2 == 1
        tc, zc, yc = t + pt, z + pz, y + py
        legs = [(flat(tc, zc, yc, torch.where(o_p, xh, (xh + 1) % xh_n)),
                 flat(tc, zc, yc, torch.where(o_p, (xh - 1) % xh_n, xh))),
                (flat(tc, zc, step(y, Y, py, 1), xh), flat(tc, zc, step(y, Y, py, -1), xh)),
                (flat(tc, step(z, Z, pz, 1), yc, xh), flat(tc, step(z, Z, pz, -1), yc, xh)),
                (flat(step(t, T, pt, 1), zc, yc, xh), flat(step(t, T, pt, -1), zc, yc, xh))]
        tables.append(torch.stack([torch.stack(pair) for pair in legs]))
    return tuple(tables)


def cut_halo(lmesh: LatticeMesh, u: torch.Tensor, psi: torch.Tensor, src_parity: int,
             dagger: bool = False, half: bool = True):
    """One-process emulation of a shard's exchange: its local gauge and
    spinor and the Halo it would receive, cut from the global gauge
    [4, 2, R, 3, 2, Lt, Lz, S] and spinor [2(ri), 4, 3, Lt, Lz, S] (what
    chip_smoke.py and the tests hold the kernel's halo mode and the
    overlap engine with).  On a y-sharded mesh the Halo carries the y
    faces and face links too (the overlap engine's; K6 refuses them)."""
    it, iz, iy = lmesh.coords
    (Tl, Zl), T, Z = lmesh.local_dims, lmesh.lat.Lt, lmesh.lat.Lz
    Yl, Y, xh = lmesh.local_y, lmesh.lat.Ly, lmesh.lat.Lx // 2
    ts, zs = slice(it * Tl, (it + 1) * Tl), slice(iz * Zl, (iz + 1) * Zl)
    ys = slice(iy * Yl * xh, (iy + 1) * Yl * xh)
    tm, tp, zm, zp = (it * Tl - 1) % T, (it + 1) * Tl % T, (iz * Zl - 1) % Z, (iz + 1) * Zl % Z
    ym, yp = (iy * Yl - 1) % Y, (iy + 1) * Yl % Y
    fwd, bwd = half_tables(dagger)

    def face(x, mu, table):
        return hproj_pk(x, table[mu]) if _ships_half(half, x.dtype) else x.contiguous()

    def row(y):
        return slice(y * xh, (y + 1) * xh)

    y = ()
    if lmesh.ny > 1:
        y = (face(psi[..., ts, zs, row(ym)], 1, bwd), face(psi[..., ts, zs, row(yp)], 1, fwd),
             u[1, src_parity, ..., ts, zs, row(ym)].contiguous())
    halo = Halo(face(psi[:, :, :, tm, zs, ys], 3, bwd), face(psi[:, :, :, tp, zs, ys], 3, fwd),
                face(psi[:, :, :, ts, zm, ys], 2, bwd), face(psi[:, :, :, ts, zp, ys], 2, fwd),
                u[3, src_parity, :, :, :, tm, zs, ys].contiguous(),
                u[2, src_parity, :, :, :, ts, zm, ys].contiguous(), lmesh.t_offset, T, *y)
    return u[..., ts, zs, ys].contiguous(), psi[..., ts, zs, ys].contiguous(), halo


def check_policy(lmesh: LatticeMesh | None, comm_policy: str) -> None:
    if lmesh is None:
        raise ValueError("a sharded operator needs lmesh")
    if comm_policy not in COMM_POLICIES:
        raise ValueError(f"comm_policy must be one of {COMM_POLICIES}, got {comm_policy!r}")
    if lmesh.ny > 1 and comm_policy != "overlap":
        raise ValueError("a y-sharded mesh needs comm_policy 'overlap': the kernel's halo "
                         "mode reads t and z faces only")


def sharded_hop(lmesh: LatticeMesh, ug: HaloGauge, psi: torch.Tensor, parity: int,
                dagger: bool = False, comm_policy: str = "fused", **kw) -> torch.Tensor:
    """One hop on a shard: under ``fused`` one face exchange (half-spinor
    faces) and one halo-mode launch, under ``overlap`` the interior/exterior
    split (parallel/overlap.overlap_hop); ``kw`` are dslash_eo's epilogue,
    dirs and out arguments."""
    if comm_policy == "overlap":
        from .overlap import overlap_hop
        return overlap_hop(lmesh, ug, psi, parity, dagger, **kw)
    halo = ug.halo(lmesh, exchange_faces(lmesh, psi, dagger), parity)
    return dslash_eo(ug.u, psi, parity, lmesh.local_lat, dagger=dagger, halo=halo, **kw)


@dataclasses.dataclass(frozen=True)
class ShardedTMOperatorPC(PackedTMOperatorPC):
    """PackedTMOperatorPC on a shard of a LatticeMesh: the same Schur
    operator (apply, apply_dagger, normal, prepare, reconstruct,
    apply_full) on local fields, every hop through sharded_hop under
    ``comm_policy``.  ``u`` is a HaloGauge (extend_gauge); the same class
    serves the sloppy operator (reconstruct-12 rows, float32 or bfloat16)
    and the float64 certification one."""
    lmesh: LatticeMesh | None = None
    comm_policy: str = "fused"

    def __post_init__(self):
        check_policy(self.lmesh, self.comm_policy)

    def extend_gauge(self, u_loc: torch.Tensor) -> HaloGauge:
        return extend_gauge(self.lmesh, u_loc)

    def _hop(self, u, psi, parity, dagger=False, epilogue="none", flavor=None, psi0=None,
             xpay_scale=None):
        return sharded_hop(self.lmesh, u, psi, parity, dagger, self.comm_policy,
                           epilogue=epilogue, kappa=self.kappa, mu=self.mu,
                           flavor=self.flavor if flavor is None else flavor, psi0=psi0,
                           t_boundary=self.t_boundary, xpay_scale=xpay_scale)


@dataclasses.dataclass(frozen=True)
class ShardedTMCloverOperatorPC(PackedTMCloverOperatorPC):
    """PackedTMCloverOperatorPC on a shard of a LatticeMesh
    (tpuqcd/parallel/sharded.py:334-534): the clover blocks are site-local,
    so the operand tuple's clover arrays are the shard's slices and need no
    exchange; every hop, with its fused clover_inv or clover_xpay epilogue,
    goes through sharded_hop under ``comm_policy``.  Operand tuple
    (extend_fields): (HaloGauge, cl_pk, clinv_plus, clinv_minus)."""
    lmesh: LatticeMesh | None = None
    comm_policy: str = "fused"

    def __post_init__(self):
        check_policy(self.lmesh, self.comm_policy)

    def extend_fields(self, u_loc, cl_loc, clinv_plus_loc, clinv_minus_loc):
        """The gauge's one-time face exchange beside the shard's clover arrays."""
        return (extend_gauge(self.lmesh, u_loc), cl_loc.contiguous(),
                clinv_plus_loc.contiguous(), clinv_minus_loc.contiguous())

    def _hop(self, u, psi, parity, dagger=False, epilogue="none", flavor=None, psi0=None,
             clover=None):
        return sharded_hop(self.lmesh, u, psi, parity, dagger, self.comm_policy,
                           epilogue=epilogue, kappa=self.kappa, mu=self.mu,
                           flavor=self.flavor if flavor is None else flavor, psi0=psi0,
                           t_boundary=self.t_boundary, clover=clover)


def clover_fields_to(fields, dtype: torch.dtype, rows: int = 3):
    """A sharded clover operand tuple with the gauge in ``dtype`` (rows=2:
    reconstruct-12) and the clover arrays in ``dtype``."""
    return (fields[0].to(dtype, rows), *(c.to(dtype).contiguous() for c in fields[1:]))


@dataclasses.dataclass(frozen=True)
class ShardedNdegTMOperatorPC(PackedNdegTMOperatorPC):
    """PackedNdegTMOperatorPC on a shard of a LatticeMesh: the
    flavor-diagonal hop goes through sharded_hop, one launch per flavor;
    the flavor-mixing site terms are site-local and need no exchange."""
    lmesh: LatticeMesh | None = None
    comm_policy: str = "fused"

    def __post_init__(self):
        check_policy(self.lmesh, self.comm_policy)

    def extend_gauge(self, u_loc: torch.Tensor) -> HaloGauge:
        return extend_gauge(self.lmesh, u_loc)

    def _hop(self, u, chi, parity, dagger):
        return torch.stack([sharded_hop(self.lmesh, u, chi[f], parity, dagger,
                                        self.comm_policy, t_boundary=self.t_boundary)
                            for f in (0, 1)])
