"""The interior/exterior split of a sharded hop: communication beside
compute.

Counterpart of ``tpuqcd/parallel/overlap.py``.  A hop on a shard posts
its face sends and receives first (``dist.batch_isend_irecv``, not
waited on), then launches the Dslash kernel on the shard's own lattice
with local-periodic wraps, which needs no face, while the faces travel;
once they arrive, the boundary slabs that the local wraps got wrong are
repaired, O(surface) elementwise work:

    forward leg, last slice:   += R^- U_mu[q][last] (h_next - P^- psi[first])
    backward leg, first slice: += R^+ (U_face^dag h_prev - U_mu[p][last]^dag P^+ psi[last])

(P, R the half-spinor projection and reconstruction of the leg, h the
projected face a neighbour sent; dagger swaps the tables), for t, z and
y: a y row is an Xh-wide slice of the y-major packed S axis.  An axis of
one rank needs no repair: its local wrap is the global one.

Epilogues stay fused: each is affine in the hop d, E(d) = a + L d with a
site-local linear part L, so the interior runs with the epilogue in the
kernel and a repair delta goes through L before it is added,
E(d + delta) = E(d) + L delta, exactly:

    none, dirs           L = 1
    twist_inv            L = (1 - i tw g5) / (1 + tw^2)
    clover_inv           L = the twisted-clover inverse blocks of the
                         repaired slab's own sites (a slice of ``clover``)
    xpay, clover_xpay    L = -k2 (the psi0 term needs no repair)

The repairs run in float64 for float64 storage and in float32 otherwise:
a bfloat16 result is read into float32, every repair of the site added,
and the sum rounded to bfloat16 once (a site on the edge of two sharded
axes takes both axes' repairs before its one rounding), so a repaired
site carries two roundings, the interior's and this one.

The reconstruct-12 phase: the interior rebuilds U_t at the shard's last
t slice, and the T-boundary phase belongs there only on the shard that
holds global t = Lt - 1 (t_offset + Tl = Lt); every other shard launches
with t_boundary = +1, and the repair slabs rebuild their links by the
same rule (the t-1 face link carries the phase on the shard at t_offset
0), so the wrap term the repair subtracts is the one the interior added.

    out = overlap_hop(lmesh, ug, psi, parity, dagger, epilogue="twist_inv", ...)
    out = dslash_overlap(u_loc, psi_loc, parity, lmesh, halo)   # faces given (emulation)
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from ..gammas import HALF_PROJ_MINUS, HALF_PROJ_PLUS, HALF_RECON_MINUS, HALF_RECON_PLUS
from ..operators import twist_inv_apply_pk
from ..ops.clover import clover_apply_pk
from ..ops.dslash_cuda import Halo, _rebuild_row2, dslash_eo
from .mesh import LatticeMesh
from .sharded import FACE_AXES, HaloGauge, _p2p_ops, boundary_slice, pack_faces


class PendingFaces:
    """The face exchange of one hop, posted and not waited on; ``wait``
    returns the spinor faces in exchange_faces's order, None for an axis
    of one rank (its local wrap needs no repair, so its faces are neither
    projected nor sent)."""

    def __init__(self, lmesh: LatticeMesh, psi: torch.Tensor, dagger: bool):
        self.lmesh = lmesh
        axes = tuple(axis for axis, _ in FACE_AXES if lmesh.axis_size(axis) > 1)
        sent = pack_faces(lmesh, psi, dagger, axes=axes)
        ops, self.bufs = [], {}
        for i, (axis, _) in enumerate(FACE_AXES):
            if axis in sent:
                o, lo, hi = _p2p_ops(lmesh, axis, *sent[axis], 2 * i)
                ops += o
                self.bufs[axis] = (lo, hi)
        self.reqs = dist.batch_isend_irecv(ops) if ops else []

    def wait(self) -> tuple:
        for req in self.reqs:
            req.wait()
        return tuple(f for axis, _ in FACE_AXES for f in self.bufs.get(axis, (None, None)))


@functools.lru_cache(maxsize=None)
def _tables(dagger: bool, cdt, device):
    """(forward projection, forward reconstruction, backward ...) of a
    launch as complex tensors [4(mu), ...] on ``device``, copied there once."""
    tabs = [t.to(device=device, dtype=cdt) for t in
            (HALF_PROJ_MINUS, HALF_RECON_MINUS, HALF_PROJ_PLUS, HALF_RECON_PLUS)]
    return tabs[2:] + tabs[:2] if dagger else tabs


def _cplx(x: torch.Tensor, rdt) -> torch.Tensor:
    return torch.complex(x[0].to(rdt), x[1].to(rdt))


def _links(u_slab: torch.Tensor, phase: int, rdt) -> torch.Tensor:
    """Packed links [R, 3, 2(ri), *sites] -> complex [3, 3, *sites]; the
    reconstruct-12 row 2 rebuilt with ``phase``."""
    uc = torch.complex(u_slab[:, :, 0].to(rdt), u_slab[:, :, 1].to(rdt))
    if uc.shape[0] == 3:
        return uc
    sites = uc.shape[2:]
    r2 = _rebuild_row2(uc.reshape(2, 3, -1)).reshape(3, *sites)
    return torch.cat([uc, (phase * r2)[None]])


def _spinor_face(f: torch.Tensor, proj: torch.Tensor, rdt) -> torch.Tensor:
    """A face as it arrived (half-spinor [2(ri), 2, 3, ...] or a full
    bfloat16 one) -> the projected complex half-spinor [2, 3, ...]."""
    c = _cplx(f, rdt)
    return c if c.shape[0] == 2 else torch.einsum("hs,sc...->hc...", proj, c)


def _interior_phase(lmesh: LatticeMesh, t_boundary: int) -> int:
    """The reconstruct-12 phase of the interior launch (module docstring)."""
    Tl = lmesh.local_dims[0]
    return t_boundary if lmesh.t_offset + Tl == lmesh.lat.Lt else 1


def _interior(u: torch.Tensor, psi: torch.Tensor, parity: int, lmesh: LatticeMesh, dagger,
              t_boundary: int, **kw) -> torch.Tensor:
    """The kernel on the shard's lattice with local-periodic wraps."""
    return dslash_eo(u, psi, parity, lmesh.local_lat, dagger=dagger,
                     t_boundary=_interior_phase(lmesh, t_boundary), **kw)


def _repair(res, u, psi, parity, lmesh: LatticeMesh, halo: Halo, dagger, *, epilogue="none",
            kappa=0.0, mu=0.0, flavor=1, t_boundary=-1, xpay_scale=None, dirs=None,
            clover=None, **_):
    """Add the boundary slabs' repairs to the interior's result ``res`` in
    place (module docstring); halo's faces of an axis of one rank are not
    read."""
    if psi.ndim != 6:
        raise ValueError("the overlap engine takes one spinor [2(ri), 4, 3, T, Z, S], "
                         "not a batch")
    out, p, q = res, parity, 1 - parity
    rdt = torch.float64 if out.dtype == torch.float64 else torch.float32
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    pf, rf, pb, rb = _tables(dagger, cdt, out.device)
    xh = lmesh.lat.Lx // 2
    k2 = kappa * kappa if xpay_scale is None else xpay_scale
    last_t = lmesh.t_offset + lmesh.local_dims[0] == lmesh.lat.Lt
    faces = {"t": (halo.t_m, halo.t_p, halo.u_t), "z": (halo.z_m, halo.z_p, halo.u_z),
             "y": (halo.y_m, halo.y_p, halo.u_y)}

    def epi(delta, axis, first):
        """L delta for the slab: packed [2(ri), 4, 3, *slab]."""
        d = torch.stack([delta.real, delta.imag])
        if epilogue == "twist_inv":
            return twist_inv_apply_pk(d, kappa, mu, flavor)
        if epilogue == "clover_inv":
            return clover_apply_pk(boundary_slice(clover, axis, first, xh).to(rdt), d)
        if epilogue in ("xpay", "clover_xpay"):
            return -k2 * d
        return d

    deltas = {}

    def add(axis, first, delta):
        deltas[(axis, first)] = epi(delta, axis, first)

    def has(m, sign):
        return dirs is None or (m, sign) in dirs

    for axis, m in FACE_AXES:
        if lmesh.axis_size(axis) == 1 or not (has(m, +1) or has(m, -1)):
            continue
        f_m, f_p, u_face = faces[axis]
        if axis != "y":                     # t and z faces travel without their unit dim
            dim = -3 if axis == "t" else -2
            f_m, f_p, u_face = f_m.unsqueeze(dim), f_p.unsqueeze(dim), u_face.unsqueeze(dim)
        # the phase of t links at the shard's last slice and at its t-1 face
        ph_last = t_boundary if (m == 3 and last_t) else 1
        ph_face = t_boundary if (m == 3 and lmesh.t_offset == 0) else 1
        first_psi = _cplx(boundary_slice(psi, axis, True, xh), rdt)
        last_psi = _cplx(boundary_slice(psi, axis, False, xh), rdt)
        if has(m, +1):
            # forward leg at the last slice: the local wrap read psi[first]
            h = _spinor_face(f_p, pf[m], rdt) - torch.einsum("hs,sc...->hc...", pf[m], first_psi)
            ul = _links(boundary_slice(u[m, q], axis, False, xh), ph_last, rdt)
            w = torch.einsum("ij...,hj...->hi...", ul, h)
            add(axis, False, torch.einsum("ah,hc...->ac...", rf[m], w))
        if has(m, -1):
            # backward leg at the first slice: the local wrap read psi[last]
            uf = _links(u_face, ph_face, rdt)
            ul = _links(boundary_slice(u[m, p], axis, False, xh), ph_last, rdt)
            h_face = _spinor_face(f_m, pb[m], rdt)
            h_wrap = torch.einsum("hs,sc...->hc...", pb[m], last_psi)
            w = (torch.einsum("ji...,hj...->hi...", uf.conj(), h_face)
                 - torch.einsum("ji...,hj...->hi...", ul.conj(), h_wrap))
            add(axis, True, torch.einsum("ah,hc...->ac...", rb[m], w))
    _add_once(out, deltas, lmesh, rdt)
    return out


def _add_once(out: torch.Tensor, deltas: dict, lmesh: LatticeMesh, rdt) -> None:
    """out += each slab's delta {(axis, first): [2(ri), 4, 3, *slab]}, in
    ``rdt`` and rounded to out's dtype once a site: a site where slabs
    meet (an edge of two sharded axes) takes all their deltas at the slab
    that comes first, and the later slabs skip it."""
    (Tl, Zl), Yl, xh = lmesh.local_dims, lmesh.local_y, lmesh.lat.Lx // 2
    ext = {"t": Tl, "z": Zl, "y": Yl}

    def box(axis, first):
        r = {a: (0, e) for a, e in ext.items()}
        r[axis] = (0, 1) if first else (ext[axis] - 1, ext[axis])
        return r

    def index(r, base):
        """r's sites in a tensor [..., T, Z, Y, Xh] that covers ``base``."""
        return (..., *(slice(r[a][0] - base[a][0], r[a][1] - base[a][0]) for a in ext),
                slice(None))

    def view4(x):
        return x.unflatten(-1, (x.shape[-1] // xh, xh))

    slabs = list(deltas)
    out4 = view4(out)
    for k, key in enumerate(slabs):
        region = box(*key)
        for axis, first in slabs[:k]:          # the sites of earlier slabs are done
            lo, hi = region[axis]
            region[axis] = (max(lo, 1), hi) if first else (lo, min(hi, ext[axis] - 1))
        if any(lo >= hi for lo, hi in region.values()):
            continue
        full = {a: (0, e) for a, e in ext.items()}
        acc = out4[index(region, full)].to(rdt)
        for other in slabs[k:]:
            b = box(*other)
            part = {a: (max(region[a][0], b[a][0]), min(region[a][1], b[a][1])) for a in ext}
            if all(lo < hi for lo, hi in part.values()):
                acc[index(part, region)] += view4(deltas[other])[index(part, b)]
        out4[index(region, full)] = acc.to(out.dtype)


def dslash_overlap(u: torch.Tensor, psi: torch.Tensor, parity: int, lmesh: LatticeMesh,
                   halo: Halo, *, dagger: bool = False, t_boundary: int = -1,
                   **kw) -> torch.Tensor:
    """The interior launch and the repairs with given faces (cut_halo's
    Halo: the one-process emulation of chip_smoke.py and the tests): u
    [4, 2, R, 3, 2, T, Z, S] and psi [2(ri), 4, 3, T, Z, S] the shard's,
    ``kw`` dslash_eo's epilogue, dirs and out arguments."""
    res = _interior(u, psi, parity, lmesh, dagger, t_boundary, **kw)
    return _repair(res, u, psi, parity, lmesh, halo, dagger, t_boundary=t_boundary, **kw)


def overlap_hop(lmesh: LatticeMesh, ug: HaloGauge, psi: torch.Tensor, parity: int,
                dagger: bool = False, t_boundary: int = -1, **kw) -> torch.Tensor:
    """One hop on a shard with the exchange beside the interior launch:
    faces posted, kernel launched, faces waited for, slabs repaired."""
    pending = PendingFaces(lmesh, psi, dagger)
    res = _interior(ug.u, psi, parity, lmesh, dagger, t_boundary, **kw)
    halo = ug.halo(lmesh, pending.wait(), parity)
    return _repair(res, ug.u, psi, parity, lmesh, halo, dagger, t_boundary=t_boundary, **kw)
