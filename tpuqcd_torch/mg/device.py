"""Adaptive-multigrid levels, transfers and Galerkin probing on the device.

Counterpart of ``tpuqcd/mg/device.py`` (the twisted-mass and the
twisted-clover fine level).  Fields are packed real with the re/im axis
leading, as there:

    fine field      [2(ri), 2(par), 4, 3, T, Z, S]
    coarse field    [2(ri), N, Vc]      Vc = Tc*Zc*Yc*Xc flat (t slowest)

The fine level runs every apply through the Dslash kernel
(ops/dslash_cuda.dslash_eo, or its plain version on the CPU): one
``xpay`` launch per parity for M (``clover_xpay`` for twisted clover),
the ``dirs`` leg filter for a single hop, and the ``legs_out`` mode for
all 8 hops of Galerkin probing; the hops are clover-free, so the clover
term reaches the coarse operator through the probes of M alone.  The
kernel reads and writes the parity halves of a fine field in place.

The coarse operator and the transfers were XLA in tpuqcd and are plain
PyTorch here, laid out for batched complex products on the card:

  - coarse links are complex [Vc, N, 9N] (per site, the 4 forward, 4
    backward and the diagonal N x N blocks side by side) with a
    neighbour index [Vc, 9] built once per level, so an apply is one
    gather and one batched mat-vec;
  - a transfer keeps its raw null vectors V aggregate-major, complex
    [2(chir), Nagg, K, n] (K = the fine dofs of one aggregate and
    chirality), and the inverse Cholesky factor Linv of their Gram
    matrix per (chirality, aggregate), [2, Nagg, n, n]; restrict is
    Linv (V^dag r) and prolong V (Linv^dag x), each two batched
    products, and R P = I;
  - with mg.vec_dtype bfloat16 the bank is bfloat16 (re, im) pairs
    [2(chir), Nagg, K, n, 2] (PyTorch has no complex bfloat16), widened
    to complex64 a chunk of aggregates at a time (BANK_CHUNK_FIELDS) for
    every product: the arithmetic is float32, as tpuqcd's bfloat16
    vectors times float32 fields (tpuqcd/mg/device.py:451-470), and no
    whole float32 copy of the bank is ever formed.

The JAX layouts (null vectors [n, 2, 2, 4, 3, T, Z, S], Linv
[2, 2, n, n, Tc, Zc, Sc], links [2, 9, N, N, Vc]) are what
``from_pk``/``from_links_pk`` take and ``v_pk``/``linv_pk``/``links_pk``
give back, so state moves between the two packages unchanged
(utils/checkpoint.py).
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from ..gammas import G5_DIAG
from ..lattice import Lattice
from ..ops.dslash_cuda import LEG_ORDER, dslash_eo

# chirality of each spin: g5 = diag(+1, +1, -1, -1), so the spin axis
# splits as (2 chiralities, 2 spins) by a reshape
if tuple(G5_DIAG) != (1.0, 1.0, -1.0, -1.0):
    raise ImportError(f"the transfers assume g5 = diag(1, 1, -1, -1), got {G5_DIAG}")


def _par(v: torch.Tensor, p: int) -> torch.Tensor:
    """Parity p of a fine field [..., 2(ri), 2(par), 4, 3, T, Z, S] as a view."""
    return v.select(-6, p)


# --------------------------------------------------------------------------
# fine level

class _FineHops:
    """What the twisted-mass and twisted-clover fine levels share: the
    gauge (u_pk, its reconstruct-12 copy u12), the clover-free hops and
    the field shape.  Subclasses are frozen dataclasses with the fields
    lat, u_pk, kappa, mu, flavor, t_boundary and u12."""

    def __post_init__(self):
        if self.u12 is None and self.u_pk.dtype != torch.float64:
            object.__setattr__(self, "u12",
                               self.u_pk[:, :, :2].to(torch.float32).contiguous())

    @property
    def n(self) -> int:
        return 12

    @property
    def device(self) -> torch.device:
        return self.u_pk.device

    @property
    def _u(self) -> torch.Tensor:
        return self.u_pk if self.u12 is None else self.u12

    def _dslash(self, v, p, out, **kw):
        """The hop into parity p of ``out`` from parity 1 - p of v (a fine
        field, or a batch [N, 2(ri), 2(par), ...] in one launch)."""
        return dslash_eo(self._u, _par(v, 1 - p), 1 - p, self.lat, kappa=self.kappa,
                         mu=self.mu, flavor=self.flavor, t_boundary=self.t_boundary,
                         out=out, **kw)

    def apply_hop(self, v: torch.Tensor, mu: int, sign: int) -> torch.Tensor:
        """One hop term of M (including the -kappa), both parities."""
        return _hop_full(self, v, mu, sign)

    def apply_hop_all(self, v: torch.Tensor) -> torch.Tensor:
        """All 8 hop terms of M (including -kappa), both parities, in
        LEG_ORDER -> [8, 2(ri), 2(par), 4, 3, T, Z, S]: one legs_out
        launch per parity reads the gauge and the spinor once for all 8."""
        out = torch.empty((8, *v.shape), dtype=v.dtype, device=v.device)
        for p in (0, 1):
            self._dslash(v, p, out[:, :, p], legs_out=True)
        return out.mul_(-self.kappa)

    def random_field(self, generator: torch.Generator) -> torch.Tensor:
        shape = (2, 2, 4, 3, *self.lat.site_shape)
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=self.device)

    def transfer(self, block, v_pk: torch.Tensor) -> "DeviceFineTransfer":
        """The fine transfer of null vectors v_pk [n, *field shape]."""
        return DeviceFineTransfer.from_pk(self.lat, block, v_pk)


@dataclasses.dataclass(frozen=True)
class DeviceFineLevel(_FineHops):
    """The two-parity twisted-mass operator M = (1 + 2 i kappa mu f g5)
    - kappa D on fine fields.

    u_pk: the 18-real gauge [4, 2, 3, 3, 2, T, Z, S] with the boundary
    phase folded in (float32; float64 in the ``as_hp`` twin).  The
    float32 and bfloat16 applies read the reconstruct-12 copy u12; the
    float64 twin reads the 18 reals.  A field has the dtype of the links
    its apply reads.
    """
    lat: Lattice
    u_pk: torch.Tensor
    kappa: float
    mu: float = 0.0
    flavor: int = +1
    t_boundary: int = -1
    u12: torch.Tensor | None = None

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        """M v: one xpay launch per parity, (1 + i tw g5) v_p - kappa D v_{1-p};
        v a fine field or a batch [N, 2(ri), 2(par), ...]."""
        out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
        for p in (0, 1):
            self._dslash(v, p, _par(out, p), epilogue="xpay", psi0=_par(v, p),
                         xpay_scale=self.kappa)
        return out

    def as_hp(self) -> "DeviceFineLevel":
        """The float64 twin on the 18-real gauge, for the certified
        residuals (float32 links are exact in float64)."""
        return dataclasses.replace(self, u_pk=self.u_pk.to(torch.float64), u12=None)

    def sloppy(self, dtype: torch.dtype = torch.bfloat16) -> "DeviceFineLevel":
        """The smoother's twin with reconstruct-12 links stored in dtype."""
        return dataclasses.replace(self, u12=self.u12.to(dtype))


@dataclasses.dataclass(frozen=True)
class DeviceFineCloverLevel(_FineHops):
    """The two-parity twisted-clover operator M = (A + 2 i kappa mu f g5)
    - kappa D on fine fields (tpuqcd/mg/device.py:226).

    clover_pk: the packed A blocks of both parities [2(par), 2(ri),
    2(chir), 6, 6, T, Z, S] (solve.clover_pk_from_gauge), float32 from
    the float32 gauge; the float64 twin (``as_hp``) promotes them
    exactly, the bfloat16 smoother twin (``sloppy``) rounds them with
    the links.  The blocks have the dtype of the links the apply reads.
    """
    lat: Lattice
    u_pk: torch.Tensor
    clover_pk: torch.Tensor
    kappa: float
    mu: float = 0.0
    flavor: int = +1
    t_boundary: int = -1
    u12: torch.Tensor | None = None

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        """M v: one clover_xpay launch per parity,
        (A + i tw g5) v_p - kappa D v_{1-p}; v a fine field or a batch."""
        out = torch.empty(v.shape, dtype=v.dtype, device=v.device)
        for p in (0, 1):
            self._dslash(v, p, _par(out, p), epilogue="clover_xpay", psi0=_par(v, p),
                         xpay_scale=self.kappa, clover=self.clover_pk[p])
        return out

    def as_hp(self) -> "DeviceFineCloverLevel":
        """The float64 twin on the 18-real gauge and the promoted blocks."""
        return dataclasses.replace(self, u_pk=self.u_pk.to(torch.float64),
                                   clover_pk=self.clover_pk.to(torch.float64), u12=None)

    def sloppy(self, dtype: torch.dtype = torch.bfloat16) -> "DeviceFineCloverLevel":
        """The smoother's twin: reconstruct-12 links and clover blocks in dtype."""
        return dataclasses.replace(self, u12=self.u12.to(dtype),
                                   clover_pk=self.clover_pk.to(dtype))


def _hop_full(level: _FineHops, v: torch.Tensor, mu: int, sign: int) -> torch.Tensor:
    """Single hop term of the full operator, both parities, through the
    kernel's dirs leg filter."""
    out = torch.empty_like(v)
    for p in (0, 1):
        level._dslash(v, p, out[:, p], dirs=((mu, sign),))
    return out.mul_(-level.kappa)


def g5_fine(v: torch.Tensor) -> torch.Tensor:
    """g5 v on a fine field [2, 2, 4, 3, T, Z, S]."""
    g5 = torch.tensor(G5_DIAG, dtype=v.dtype, device=v.device)
    return v * g5.reshape(1, 1, 4, 1, 1, 1, 1)


# --------------------------------------------------------------------------
# coarse level

def _coarse_neighbours(dims, device) -> torch.Tensor:
    """int64 [Vc, 9]: flat index of the +mu (slots 0-3), -mu (4-7)
    neighbour and the site itself (8), periodic; mu = 0..3 = x, y, z, t."""
    Tc, Zc, Yc, Xc = dims
    t, z, y, x = torch.meshgrid(*(torch.arange(d, device=device) for d in dims),
                                indexing="ij")
    coord = [x, y, z, t]
    ext = (Xc, Yc, Zc, Tc)

    def flat(c):
        return (((c[3] * Zc + c[2]) * Yc + c[1]) * Xc + c[0]).reshape(-1)

    cols = []
    for sign in (+1, -1):
        for mu in range(4):
            c = list(coord)
            c[mu] = (c[mu] + sign) % ext[mu]
            cols.append(flat(c))
    cols.append(flat(coord))
    return torch.stack(cols, dim=1)


class DeviceCoarseLevel:
    """Nearest-neighbour coarse operator on fields [2, N, Vc]:

        (A v)(y) = X[y] v(y) + sum_mu Y+_mu[y] v(y+mu) + Y-_mu[y] v(y-mu)

    links_c: complex64 [Vc, N, 9N], column block 0-3 forward mu, 4-7
    backward mu, 8 the diagonal X.
    """

    def __init__(self, dims, n: int, links_c: torch.Tensor):
        self.dims = tuple(int(d) for d in dims)
        self.n = int(n)
        Vc = int(np.prod(self.dims))
        if tuple(links_c.shape) != (Vc, self.n, 9 * self.n):
            raise ValueError(f"coarse links must be [{Vc}, {self.n}, {9 * self.n}], got "
                             f"{tuple(links_c.shape)}")
        self.links_c = links_c
        self.nbr = _coarse_neighbours(self.dims, links_c.device)

    @classmethod
    def from_links_pk(cls, dims, n: int, links: torch.Tensor) -> "DeviceCoarseLevel":
        """From tpuqcd's packed links [2(ri), 9, N, N, Vc] (any float dtype)."""
        lc = torch.complex(links[0].float(), links[1].float())      # [9, N, N, Vc]
        Vc = lc.shape[-1]
        return cls(dims, n, lc.permute(3, 1, 0, 2).reshape(Vc, n, 9 * n).contiguous())

    def links_pk(self) -> torch.Tensor:
        """tpuqcd's packed layout [2(ri), 9, N, N, Vc], float32."""
        lc = self.links_c.reshape(self.Vc, self.n, 9, self.n).permute(2, 1, 3, 0)
        return torch.stack([lc.real, lc.imag]).contiguous()

    @property
    def Vc(self) -> int:
        return int(np.prod(self.dims))

    @property
    def device(self) -> torch.device:
        return self.links_c.device

    def _sites(self, v: torch.Tensor) -> torch.Tensor:
        """packed [2, N, Vc] -> complex [Vc, N]."""
        return torch.complex(v[0], v[1]).T

    def _packed(self, c: torch.Tensor) -> torch.Tensor:
        """complex [Vc, N] -> packed [2, N, Vc]."""
        c = c.T
        return torch.stack([c.real, c.imag])

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        """A v on a coarse field [2, N, Vc], or on a batch [B, 2, N, Vc] as
        one batched product with B columns."""
        if v.ndim == 4:
            B = v.shape[0]
            g = torch.complex(v[:, 0], v[:, 1]).permute(2, 1, 0)[self.nbr]   # [Vc, 9, N, B]
            out = torch.bmm(self.links_c, g.reshape(self.Vc, 9 * self.n, B)).permute(2, 1, 0)
            return torch.stack([out.real, out.imag], dim=1)
        g = self._sites(v)[self.nbr]                        # [Vc, 9, N]
        out = torch.bmm(self.links_c, g.reshape(self.Vc, 9 * self.n, 1))
        return self._packed(out[..., 0])

    def apply_hop(self, v: torch.Tensor, mu: int, sign: int) -> torch.Tensor:
        slot = mu if sign == +1 else 4 + mu
        n = self.n
        g = self._sites(v)[self.nbr[:, slot]]               # [Vc, N]
        out = torch.bmm(self.links_c[:, :, slot * n:(slot + 1) * n], g[..., None])
        return self._packed(out[..., 0])

    def boosted(self, delta: float) -> "DeviceCoarseLevel":
        """Twisted-mass coarse-grid mu boost: X += i delta g5_c (g5_c = +1
        on the first N/2 dofs, -1 on the rest; arXiv:1710.06198)."""
        h = self.n // 2
        g5 = torch.cat([torch.ones(h), -torch.ones(self.n - h)]).to(self.device)
        lc = self.links_c.clone()
        idx = torch.arange(self.n, device=self.device)
        lc[:, idx, 8 * self.n + idx] += 1j * delta * g5
        return DeviceCoarseLevel(self.dims, self.n, lc)

    def rounded(self, dtype: torch.dtype) -> "DeviceCoarseLevel":
        """The links rounded to ``dtype`` (bfloat16 coarse links).  The
        rounded values stay in complex64, since PyTorch has no complex
        bfloat16: the arithmetic is the same as tpuqcd's bfloat16 links
        times float32 fields, the storage is not halved."""
        lc = self.links_c
        re, im = (x.to(dtype).to(torch.float32) for x in (lc.real, lc.imag))
        return DeviceCoarseLevel(self.dims, self.n, torch.complex(re, im))

    def random_field(self, generator: torch.Generator) -> torch.Tensor:
        return torch.randn((2, self.n, self.Vc), generator=generator, dtype=torch.float32,
                           device=self.device)


# --------------------------------------------------------------------------
# transfers

#: A bfloat16 bank is widened to complex64 a chunk of aggregates at a time,
#: never whole (a whole copy is the memory the bfloat16 bank saves: n_vec
#: fields of the level, 16 GB at 48^3x96).  A chunk holds the n_vec
#: vectors of n_agg * BANK_CHUNK_FIELDS // n_vec aggregates: at most this
#: many fields of the level in complex64, which bounds what restrict,
#: prolong and gram_linv add to the peak.
BANK_CHUNK_FIELDS = 1


class _Transfer:
    """restrict/prolong from the aggregate-major null vectors ``v`` and
    Linv [2, Nagg, n, n] (complex64).  ``v`` is complex64 [2(chir), Nagg,
    K, n] or, a bfloat16 bank, bfloat16 (re, im) pairs [2(chir), Nagg, K,
    n, 2].  Subclasses map their fields to and from [2(chir), Nagg, K, B]
    (``_to_agg``/``_from_agg``, through the permutations ``_agg_perm``/
    ``_agg_unperm`` of a batch of complex or real fields)."""

    field_ndim: int

    def __init__(self, v: torch.Tensor, linv: torch.Tensor | None = None):
        self.v = v
        self.linv = self.gram_linv() if linv is None else linv

    @property
    def n_vec(self) -> int:
        return self.v.shape[3]

    @property
    def vec_dtype(self) -> torch.dtype:
        """The bank's storage: torch.float32 (complex64) or torch.bfloat16."""
        return torch.bfloat16 if self.v.dtype == torch.bfloat16 else torch.float32

    @property
    def n_c(self) -> int:
        return 2 * self.n_vec

    @property
    def Vc(self) -> int:
        return int(np.prod(self.dims_c))

    @property
    def n_agg(self) -> int:
        """The aggregates this transfer holds (Vc, or a shard's share)."""
        return self.v.shape[1]

    def _chunks(self) -> list:
        """The aggregate slices the bank is widened by (BANK_CHUNK_FIELDS)."""
        step = max(1, self.n_agg * BANK_CHUNK_FIELDS // self.n_vec)
        return [slice(a, a + step) for a in range(0, self.n_agg, step)]

    def _bank(self, s: slice) -> torch.Tensor:
        """The bfloat16 bank's aggregates s, widened exactly to complex64."""
        return torch.view_as_complex(self.v[:, s].float().contiguous())

    def _wdag(self, a: torch.Tensor) -> torch.Tensor:
        """V^dag a per aggregate: [2, Nagg, K, B] -> [2, Nagg, n, B]."""
        if self.v.dtype != torch.bfloat16:
            return self.v.mH @ a
        out = a.new_empty((2, self.n_agg, self.n_vec, a.shape[-1]))
        for s in self._chunks():
            out[:, s] = self._bank(s).mH @ a[:, s]
        return out

    def _vmul(self, tmp: torch.Tensor) -> torch.Tensor:
        """V tmp per aggregate: [2, Nagg, n, B] -> [2, Nagg, K, B]."""
        if self.v.dtype != torch.bfloat16:
            return self.v @ tmp
        out = tmp.new_empty((2, self.n_agg, self.v.shape[2], tmp.shape[-1]))
        for s in self._chunks():
            out[:, s] = self._bank(s) @ tmp[:, s]
        return out

    def _gram(self) -> torch.Tensor:
        """V^dag V per (chirality, aggregate), [2, Nagg, n, n]."""
        if self.v.dtype != torch.bfloat16:
            return self.v.mH @ self.v
        out = torch.empty((2, self.n_agg, self.n_vec, self.n_vec), dtype=torch.complex64,
                          device=self.v.device)
        for s in self._chunks():
            w = self._bank(s)
            out[:, s] = w.mH @ w
        return out

    def gram_linv(self) -> torch.Tensor:
        """Linv from the raw vectors: the Gram matrix of each (chirality,
        aggregate), Cholesky and triangular inverse (utils/pkalg)."""
        from ..utils import pkalg as pk
        n = self.n_vec
        G = self._gram()                                      # [2, Nagg, n, n]
        g = torch.stack([G.real, G.imag]).permute(0, 3, 4, 1, 2)
        M = pk.tril_inverse_pk(pk.cholesky_pk(g, n), n)        # [2ri, n, n, 2, Nagg]
        return torch.complex(M[0], M[1]).permute(2, 3, 0, 1).contiguous()

    def restrict(self, r: torch.Tensor) -> torch.Tensor:
        """fine field (or a batch [B, ...] of them) -> [(B,) 2, N, Vc]."""
        single = r.ndim == self.field_ndim
        rb = r[None] if single else r
        B = rb.shape[0]
        rc = self.linv @ self._wdag(self._to_agg(rb))         # [2, Nagg, n, B]
        c = rc.permute(3, 0, 2, 1).reshape(B, self.n_c, self.n_agg)
        out = torch.stack([c.real, c.imag], dim=1)
        return out[0] if single else out

    def prolong(self, xc: torch.Tensor) -> torch.Tensor:
        """[(B,) 2, N, Vc] -> fine field (or the batch [B, ...] of them)."""
        single = xc.ndim == 3
        xb = xc[None] if single else xc
        c = torch.complex(xb[:, 0], xb[:, 1]).reshape(-1, 2, self.n_vec, self.n_agg)
        tmp = self.linv.mH @ c.permute(1, 3, 2, 0)             # [2, Nagg, n, B]
        out = self._from_agg(self._vmul(tmp))
        return out[0] if single else out

    def linv_pk(self) -> torch.Tensor:
        """tpuqcd's packed Linv [2(ri), 2(chir), n, n, Tc, Zc, Yc*Xc]."""
        Tc, Zc, Yc, Xc = self.dims_c
        lc = self.linv.permute(0, 2, 3, 1).reshape(2, self.n_vec, self.n_vec, Tc, Zc, Yc * Xc)
        return torch.stack([lc.real, lc.imag]).contiguous()

    def v_pk(self) -> torch.Tensor:
        """tpuqcd's null-vector bank [n, *field shape], float32 (a bfloat16
        bank widened exactly, a vector at a time)."""
        if self.v.dtype != torch.bfloat16:
            return self._from_agg(self.v)
        out = None
        for i in range(self.n_vec):
            c = self._agg_unperm(self.v[:, :, :, i])           # [2(ri), *field], bfloat16
            if out is None:
                out = torch.empty((self.n_vec, *c.shape), dtype=torch.float32, device=c.device)
            out[i] = c
        return out

    def _to_agg(self, r: torch.Tensor) -> torch.Tensor:
        """real [B, 2(ri), *field] -> complex [2(chir), Nagg, K, B]."""
        return self._agg_perm(torch.complex(r[:, 0], r[:, 1]))

    def _from_agg(self, a: torch.Tensor) -> torch.Tensor:
        """complex [2(chir), Nagg, K, B] -> real [B, 2(ri), *field]."""
        c = self._agg_unperm(a)
        return torch.stack([c.real, c.imag], dim=1)

    def _bank_from_pk(self, v_pk: torch.Tensor) -> torch.Tensor:
        """tpuqcd's null vectors [n, 2(ri), *field] -> the bank: complex64
        from float32, and from bfloat16 the (re, im) pairs, permuted a
        vector at a time (the re/im axis of one vector is the batch axis
        of _agg_perm), so that no float32 copy of the bank is made."""
        if v_pk.dtype != torch.bfloat16:
            return self._to_agg(v_pk.float())
        bank = None
        for i in range(v_pk.shape[0]):
            a = self._agg_perm(v_pk[i])                        # [2(chir), Nagg, K, 2(ri)]
            if bank is None:
                bank = a.new_empty((*a.shape[:3], v_pk.shape[0], 2))
            bank[:, :, :, i] = a
        return bank

    def stored(self, dtype: torch.dtype) -> "_Transfer":
        """This transfer with its bank stored in ``dtype`` (torch.float32 or
        torch.bfloat16, rounded to nearest even) and the same Linv, as
        tpuqcd casts v_pk after setup (tpuqcd/mg/dsolve.py:171-175)."""
        if dtype == self.vec_dtype:
            return self
        tr = copy.copy(self)
        tr.v = (torch.view_as_real(self.v).to(torch.bfloat16) if dtype == torch.bfloat16
                else torch.view_as_complex(self.v.float()))
        return tr

    @staticmethod
    def _linv_from_pk(linv_pk: torch.Tensor) -> torch.Tensor:
        n = linv_pk.shape[2]
        lc = torch.complex(linv_pk[0].float(), linv_pk[1].float())
        return lc.reshape(2, n, n, -1).permute(0, 3, 1, 2).contiguous()


class DeviceFineTransfer(_Transfer):
    """fine [2, 2(par), 4, 3, T, Z, S] <-> coarse [2, 2 n_vec, Vc].

    Chirality is the g5 spin split.  With block (bt, bz, by, bx), bx
    even, the aggregate x index of a packed site is xh // (bx/2) for both
    parities (x = 2 xh + parity offset stays inside the block).
    """
    field_ndim = 7

    def __init__(self, lat: Lattice, block, v: torch.Tensor,
                 linv: torch.Tensor | None = None):
        bt, bz, by, bx = self.block = tuple(int(b) for b in block)
        self.lat = lat
        if bx % 2:
            raise ValueError(f"the x block must be even (eo packing), got {block}")
        if lat.Lt % bt or lat.Lz % bz or lat.Ly % by or lat.Lx % bx:
            raise ValueError(f"block {block} does not divide the lattice {lat.dims}")
        super().__init__(v, linv)

    @classmethod
    def from_pk(cls, lat: Lattice, block, v_pk: torch.Tensor,
                linv_pk: torch.Tensor | None = None) -> "DeviceFineTransfer":
        """From tpuqcd's layouts: null vectors [n, 2, 2, 4, 3, T, Z, S]
        (float32, or bfloat16 for a bfloat16 bank) and, optionally, Linv
        [2, 2, n, n, Tc, Zc, Sc]."""
        tr = cls.__new__(cls)
        tr.lat, tr.block = lat, tuple(int(b) for b in block)
        linv = None if linv_pk is None else cls._linv_from_pk(linv_pk)
        cls.__init__(tr, lat, block, tr._bank_from_pk(v_pk), linv)
        return tr

    @property
    def dims_c(self):
        bt, bz, by, bx = self.block
        lat = self.lat
        return (lat.Lt // bt, lat.Lz // bz, lat.Ly // by, lat.Lx // bx)

    def _geom(self):
        bt, bz, by, bx = self.block
        Tc, Zc, Yc, Xc = self.dims_c
        return Tc, bt, Zc, bz, Yc, by, Xc, bx // 2

    def _agg_perm(self, c: torch.Tensor) -> torch.Tensor:
        """[B, 2(par), 4, 3, T, Z, S] -> [2(chir), Nagg, K, B]."""
        B = c.shape[0]
        Tc, bt, Zc, bz, Yc, by, Xc, bxh = g = self._geom()
        c = c.reshape(B, 2, 2, 2, 3, *g)
        # B par chir s col | Tc bt Zc bz Yc by Xc bxh
        c = c.permute(2, 5, 7, 9, 11, 1, 3, 4, 6, 8, 10, 12, 0)
        return c.reshape(2, Tc * Zc * Yc * Xc, -1, B)

    def _agg_unperm(self, a: torch.Tensor) -> torch.Tensor:
        """[2(chir), Nagg, K, B] -> [B, 2(par), 4, 3, T, Z, S]."""
        B = a.shape[-1]
        Tc, bt, Zc, bz, Yc, by, Xc, bxh = self._geom()
        c = a.reshape(2, Tc, Zc, Yc, Xc, 2, 2, 3, bt, bz, by, bxh, B)
        c = c.permute(12, 5, 0, 6, 7, 1, 8, 2, 9, 3, 10, 4, 11)
        return c.reshape(B, 2, 4, 3, *self.lat.site_shape)


class DeviceCoarseTransfer(_Transfer):
    """coarse [2, N, Vf] <-> coarser [2, 2 n_vec, Vc]; chirality is the
    exact N/2 dof split."""
    field_ndim = 3

    def __init__(self, dims, n_f: int, block, v: torch.Tensor,
                 linv: torch.Tensor | None = None):
        self.dims, self.n_f = tuple(int(d) for d in dims), int(n_f)
        self.block = tuple(int(b) for b in block)
        if any(d % b for d, b in zip(self.dims, self.block)):
            raise ValueError(f"block {block} does not divide the coarse dims {dims}")
        super().__init__(v, linv)

    @classmethod
    def from_pk(cls, dims, n_f: int, block, v_pk: torch.Tensor,
                linv_pk: torch.Tensor | None = None) -> "DeviceCoarseTransfer":
        """From tpuqcd's layouts: null vectors [n, 2, N, Vf] (float32 or
        bfloat16) and Linv."""
        tr = cls.__new__(cls)
        tr.dims, tr.n_f, tr.block = tuple(dims), int(n_f), tuple(block)
        linv = None if linv_pk is None else cls._linv_from_pk(linv_pk)
        cls.__init__(tr, dims, n_f, block, tr._bank_from_pk(v_pk), linv)
        return tr

    @property
    def dims_c(self):
        return tuple(d // b for d, b in zip(self.dims, self.block))

    def _geom(self):
        Tc, Zc, Yc, Xc = self.dims_c
        bt, bz, by, bx = self.block
        return Tc, bt, Zc, bz, Yc, by, Xc, bx

    def _agg_perm(self, c: torch.Tensor) -> torch.Tensor:
        """[B, N, Vf] -> [2(chir), Nagg, K, B]."""
        B = c.shape[0]
        Tc, bt, Zc, bz, Yc, by, Xc, bx = g = self._geom()
        c = c.reshape(B, 2, self.n_f // 2, *g)
        # B chir h | Tc bt Zc bz Yc by Xc bx
        c = c.permute(1, 3, 5, 7, 9, 2, 4, 6, 8, 10, 0)
        return c.reshape(2, Tc * Zc * Yc * Xc, -1, B)

    def _agg_unperm(self, a: torch.Tensor) -> torch.Tensor:
        """[2(chir), Nagg, K, B] -> [B, N, Vf]."""
        B = a.shape[-1]
        Tc, bt, Zc, bz, Yc, by, Xc, bx = self._geom()
        c = a.reshape(2, Tc, Zc, Yc, Xc, self.n_f // 2, bt, bz, by, bx, B)
        return c.permute(10, 0, 5, 1, 6, 2, 7, 3, 8, 4, 9).reshape(B, self.n_f, -1)


# --------------------------------------------------------------------------
# Galerkin coarse construction by colored probing

def _coarse_colors(dims_c):
    """Distance-1 coloring of the periodic coarse grid.

    Per-dim colors alternate 0/1, with the last site of an odd extent
    (> 1) recolored 2 (coordinate parity is not a valid coloring across
    the periodic wrap at odd extents).  The global color is the per-dim
    sum mod 3 when any dim needs three colors, else mod 2; extent-1 dims
    contribute 0 (their self-wrap hop folds into the diagonal).

    -> (colors [Tc, Zc, Yc*Xc] int32 numpy, n_colors).
    """
    Tc, Zc, Yc, Xc = dims_c

    def dim_color(n):
        c = np.arange(n) % 2
        if n % 2 and n > 1:
            c[n - 1] = 2
        return c

    n_col = 3 if any(n % 2 and n > 1 for n in (Tc, Zc, Yc, Xc)) else 2
    s = np.arange(Yc * Xc)
    col = (dim_color(Tc)[:, None, None]
           + dim_color(Zc)[None, :, None]
           + (dim_color(Yc)[s // Xc] + dim_color(Xc)[s % Xc])[None, None, :]) % n_col
    return col.astype(np.int32), n_col


def _probe_color(level, transfer, k: int, fused_legs: bool = True):
    """Coarse dof k -> (fwd [4], bwd [4], full) columns, each [2, n_c, Vc].

    One masked source per color class feeds all 8 hop legs at once; the
    fused path runs them through one legs_out launch per parity and one
    batched restrict, the per-leg path through 8 dirs launches and 8
    restricts (about 2 fine fields live instead of 8)."""
    n_c, Vc, dev = transfer.n_c, transfer.Vc, level.device
    colors_np, n_col = _coarse_colors(transfer.dims_c)
    colors = torch.as_tensor(colors_np.reshape(-1), device=dev)
    base = torch.zeros((2, n_c, Vc), dtype=torch.float32, device=dev)
    base[0, k] = 1.0
    fused = fused_legs and hasattr(level, "apply_hop_all")
    acc = torch.zeros((8, 2, n_c, Vc), dtype=torch.float32, device=dev)
    for c in range(n_col):
        mask = colors == c
        vf = transfer.prolong(base * mask)
        if fused:
            w = transfer.restrict(level.apply_hop_all(vf))
        else:
            w = torch.stack([transfer.restrict(level.apply_hop(vf, m, s))
                             for m, s in LEG_ORDER])
        acc += w * ~mask
    full = transfer.restrict(level.apply(transfer.prolong(base)))
    return acc[0::2], acc[1::2], full


def _fused_legs_fit(level) -> bool:
    """Whether the fused probing pass fits: the 8 stacked legs and the
    two copies the batched restrict makes of them, within half the free
    device memory (torch.cuda.mem_get_info).  Always on the CPU."""
    if not hasattr(level, "lat") or level.device.type != "cuda":
        return True
    field_bytes = 96 * level.lat.volume          # float32 [2, 2, 4, 3, T, Z, S]
    free, _ = torch.cuda.mem_get_info(level.device)
    return 3 * 8 * field_bytes < free // 2


def build_coarse_device(level, transfer, fused_legs: bool | None = None
                        ) -> DeviceCoarseLevel:
    """A_c = R A P as explicit nearest-neighbour links, by colored
    probing (tpuqcd's algorithm).  fused_legs=None picks the fused 8-leg
    pass when it fits in the free device memory (_fused_legs_fit)."""
    if fused_legs is None:
        fused_legs = _fused_legs_fit(level)
    cols = [_probe_color(level, transfer, k, fused_legs) for k in range(transfer.n_c)]
    fwd = torch.stack([c[0] for c in cols], dim=3)     # [4, 2, n_row, n_col, Vc]
    bwd = torch.stack([c[1] for c in cols], dim=3)
    diag = torch.stack([c[2] for c in cols], dim=2)    # [2, n_row, n_col, Vc]
    # the full probe holds X and every link; subtract the links
    diag = diag - fwd.sum(0) - bwd.sum(0)
    links = torch.cat([fwd.movedim(0, 1), bwd.movedim(0, 1), diag[:, None]], dim=1)
    return DeviceCoarseLevel.from_links_pk(transfer.dims_c, transfer.n_c, links)
