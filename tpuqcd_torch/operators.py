"""Twisted-mass and twisted-clover operators on packed fields, even-odd
preconditioned.

Counterpart of ``tpuqcd/operators.py:341-681``.  Asymmetric Schur
complement on the even parity, with A = 1 + 2 i kappa mu g5 flavor
(twisted mass) or A = A_clover + 2 i kappa mu g5 flavor (twisted clover):

    M           = [[A, -k D_eo], [-k D_oe, A]]
    Mhat x_e    = A x_e - k^2 D_eo A^{-1} D_oe x_e
    prepare:      bhat_e = b_e + k D_eo A^{-1} b_o
    reconstruct:  x_o    = A^{-1} (b_o + k D_oe x_e)

One Mhat apply is two Dslash launches with fused epilogues
(twist_inv, then xpay; clover_inv, then clover_xpay for twisted
clover).  The non-degenerate doublet (PackedNdegTMOperatorPC) has a
flavor-mixing site term and a flavor-diagonal hop: one plain launch per
flavor.  Every hop goes through ops.dslash_cuda.dslash_eo,
so the tensor's device picks the kernel or the plain version; the same
class serves the float32/bfloat16 iteration operator and the float64
certification operator.
"""
from __future__ import annotations

import dataclasses

import torch

from .fields import EVEN, ODD
from .gammas import G5_DIAG
from .lattice import Lattice
from .ops.clover import clover_apply_pk
from .ops.dslash_cuda import dslash_eo


def _g5(x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(G5_DIAG, dtype=x.dtype, device=x.device).reshape(4, 1, 1, 1, 1)


def _ri(psi_pk: torch.Tensor):
    """(re, im, the ri axis) of a packed spinor or a batch [N, 2(ri), ...]."""
    nb = psi_pk.ndim - 6
    return psi_pk.select(nb, 0), psi_pk.select(nb, 1), nb


def _parity(b_pk: torch.Tensor, par: int) -> torch.Tensor:
    """One parity of a two-parity field [2(par), 2(ri), ...] or a batch
    [N, 2(par), 2(ri), ...], contiguous within each field."""
    return b_pk.select(b_pk.ndim - 7, par)


def twist_apply_pk(psi_pk: torch.Tensor, kappa: float, mu: float,
                   flavor: int = 1) -> torch.Tensor:
    """(1 + 2 i kappa mu g5 flavor) psi on a packed spinor (or a batch)."""
    tg = 2.0 * kappa * mu * flavor * _g5(psi_pk)
    re, im, nb = _ri(psi_pk)
    return torch.stack([re - tg * im, im + tg * re], dim=nb)


def twist_inv_apply_pk(psi_pk: torch.Tensor, kappa: float, mu: float,
                       flavor: int = 1) -> torch.Tensor:
    """(1 - 2 i kappa mu g5 flavor) psi / (1 + (2 kappa mu)^2)."""
    t = 2.0 * kappa * mu * flavor
    den = 1.0 / (1.0 + t * t)
    tg = t * _g5(psi_pk)
    re, im, nb = _ri(psi_pk)
    return torch.stack([den * (re + tg * im), den * (im - tg * re)], dim=nb)


def gamma5_apply_pk(psi_pk: torch.Tensor) -> torch.Tensor:
    return psi_pk * _g5(psi_pk)


@dataclasses.dataclass(frozen=True)
class PackedTMOperatorPC:
    """Even-odd twisted-mass operator on packed fields.

    Spinors [2(ri), 4, 3, T, Z, S], or a batch [N, 2(ri), ...] of them
    through every method (one batched launch per hop; two-parity fields
    [N, 2(par), 2(ri), ...]); gauge [4, 2, 3, 3, 2, T, Z, S] or its
    reconstruct-12 copy, of the spinor's dtype.  The dagger uses
        Mhat^dag = A(-mu) - k^2 Ddag_eo A(-mu)^{-1} Ddag_oe
    (daggered hop and flipped flavor), so it costs no gamma5 passes.
    """
    lat: Lattice
    kappa: float
    mu: float = 0.0
    flavor: int = 1
    #: fermion T-boundary phase folded into the links (-1 antiperiodic,
    #: +1 periodic); the reconstruct-12 row rebuild restores exactly it
    t_boundary: int = -1

    def _hop(self, u, psi, parity, dagger=False, epilogue="none", flavor=None,
             psi0=None, xpay_scale=None):
        return dslash_eo(u, psi, parity, self.lat, dagger=dagger, epilogue=epilogue,
                         kappa=self.kappa, mu=self.mu,
                         flavor=self.flavor if flavor is None else flavor,
                         psi0=psi0, t_boundary=self.t_boundary, xpay_scale=xpay_scale)

    def _apply(self, u, psi, dagger: bool):
        f = -self.flavor if dagger else self.flavor
        t1 = self._hop(u, psi, EVEN, dagger, "twist_inv", f)
        return self._hop(u, t1, ODD, dagger, "xpay", f, psi0=psi)

    def apply(self, u: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
        return self._apply(u, psi, dagger=False)

    def apply_dagger(self, u: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
        return self._apply(u, psi, dagger=True)

    def normal(self, u: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
        return self.apply_dagger(u, self.apply(u, psi))

    def prepare(self, u: torch.Tensor, b_pk: torch.Tensor) -> torch.Tensor:
        """b [2(par), 2(ri), 4, 3, T, Z, S] -> bhat_e = b_e + k D_eo A^{-1} b_o."""
        t = twist_inv_apply_pk(_parity(b_pk, 1), self.kappa, self.mu, self.flavor)
        return _parity(b_pk, 0) + self.kappa * self._hop(u, t.contiguous(), ODD)

    def reconstruct(self, u: torch.Tensor, x_e: torch.Tensor,
                    b_pk: torch.Tensor) -> torch.Tensor:
        """x_o = A^{-1} (b_o + k D_oe x_e); returns [2(par), ...]."""
        t = _parity(b_pk, 1) + self.kappa * self._hop(u, x_e, EVEN)
        x_o = twist_inv_apply_pk(t, self.kappa, self.mu, self.flavor)
        return torch.stack([x_e, x_o], dim=x_e.ndim - 6)

    def apply_full(self, u: torch.Tensor, x_pk: torch.Tensor) -> torch.Tensor:
        """The unpreconditioned two-parity M x on [2(par), 2(ri), ...]:
        (A x_e - k D_eo x_o, A x_o - k D_oe x_e), two xpay launches with
        the k2 = kappa scale."""
        x_e, x_o = _parity(x_pk, 0), _parity(x_pk, 1)
        return torch.stack([
            self._hop(u, x_o, ODD, epilogue="xpay", psi0=x_e, xpay_scale=self.kappa),
            self._hop(u, x_e, EVEN, epilogue="xpay", psi0=x_o, xpay_scale=self.kappa)],
            dim=x_pk.ndim - 7)


@dataclasses.dataclass(frozen=True)
class PackedTMCloverOperatorPC:
    """Even-odd twisted-clover operator on packed fields (BASELINE config 2):

        Mhat = Atw_ee - k^2 D_eo Atw_oo^{-1} D_oe,  Atw = A + 2 i kappa mu f g5.

    The clover data travel with the gauge as one operand tuple

        fields = (u,            gauge [4, 2, R, 3, 2, T, Z, S]
                  cl_pk,        A blocks [2(par), 2(ri), 2(chir), 6, 6, T, Z, S]
                  clinv_plus,   odd twisted inverses [2(ri), 2(chir), 6, 6, T, Z, S]
                  clinv_minus)  of flavor +1 and -1

    all of one dtype (solve.make_clover_fields builds them); spinors may
    be a batch as in PackedTMOperatorPC.  An apply is
    two launches, clover_inv with the inverse of flavor f, then
    clover_xpay with A_ee; the dagger takes daggered hops and f flipped,
    since (A + i t g5)^dag = A - i t g5.
    """
    lat: Lattice
    kappa: float
    mu: float = 0.0
    flavor: int = 1
    t_boundary: int = -1

    def _hop(self, u, psi, parity, dagger=False, epilogue="none", flavor=None, psi0=None,
             clover=None):
        return dslash_eo(u, psi, parity, self.lat, dagger=dagger, epilogue=epilogue,
                         kappa=self.kappa, mu=self.mu,
                         flavor=self.flavor if flavor is None else flavor,
                         psi0=psi0, t_boundary=self.t_boundary, clover=clover)

    @staticmethod
    def _clinv(fields, f: int) -> torch.Tensor:
        return fields[2] if f == +1 else fields[3]

    def _apply(self, fields, psi, dagger: bool):
        u, cl = fields[0], fields[1]
        f = -self.flavor if dagger else self.flavor
        t1 = self._hop(u, psi, EVEN, dagger, "clover_inv", f, clover=self._clinv(fields, f))
        return self._hop(u, t1, ODD, dagger, "clover_xpay", f, psi0=psi, clover=cl[EVEN])

    def apply(self, fields, psi: torch.Tensor) -> torch.Tensor:
        return self._apply(fields, psi, dagger=False)

    def apply_dagger(self, fields, psi: torch.Tensor) -> torch.Tensor:
        return self._apply(fields, psi, dagger=True)

    def normal(self, fields, psi: torch.Tensor) -> torch.Tensor:
        return self.apply_dagger(fields, self.apply(fields, psi))

    def prepare(self, fields, b_pk: torch.Tensor) -> torch.Tensor:
        """bhat_e = b_e + k D_eo Atw_oo^{-1} b_o."""
        t = clover_apply_pk(self._clinv(fields, self.flavor), _parity(b_pk, 1))
        return _parity(b_pk, 0) + self.kappa * self._hop(fields[0], t, ODD)

    def reconstruct(self, fields, x_e: torch.Tensor, b_pk: torch.Tensor) -> torch.Tensor:
        """x_o = Atw_oo^{-1} (b_o + k D_oe x_e); returns [2(par), ...]."""
        t = _parity(b_pk, 1) + self.kappa * self._hop(fields[0], x_e, EVEN)
        return torch.stack([x_e, clover_apply_pk(self._clinv(fields, self.flavor), t)],
                           dim=x_e.ndim - 6)


@dataclasses.dataclass(frozen=True)
class PackedNdegTMOperatorPC:
    """Even-odd non-degenerate twisted-mass doublet (the heavy s/c pair)
    on packed fields; counterpart of tpuqcd/operators.py:585-681.

    Doublets chi [2(flavor), 2(ri), 4, 3, T, Z, S].  Site term

        A = 1 + i t g5 tau3 + e tau1,  t = 2 kappa mubar, e = 2 kappa epsbar,

    with the closed-form inverse (g5 is diagonal, det_flavor A = 1 + t^2 -
    e^2 is a scalar, which must be > 0)

        A^{-1} = [(1 - i t g5) chi_0 - e chi_1, (1 + i t g5) chi_1 - e chi_0]
                 / (1 + t^2 - e^2),

    Mhat = A_ee - k^2 D_eo A_oo^{-1} D_oe with D flavor-diagonal: one
    plain hop (epilogue none) per flavor, with ``dagger`` for Mhat^dag
    (daggered hops and mubar flipped).  The site terms are plain torch,
    as they are XLA in tpuqcd.
    """
    lat: Lattice
    kappa: float
    mubar: float
    epsbar: float
    #: see PackedTMOperatorPC
    t_boundary: int = -1

    def site(self, chi: torch.Tensor, flip: bool = False) -> torch.Tensor:
        """A chi (A^dag chi with ``flip``)."""
        f, e = -1 if flip else 1, 2.0 * self.kappa * self.epsbar
        return torch.stack([twist_apply_pk(chi[0], self.kappa, self.mubar, f) + e * chi[1],
                            twist_apply_pk(chi[1], self.kappa, self.mubar, -f) + e * chi[0]])

    def site_inv(self, chi: torch.Tensor, flip: bool = False) -> torch.Tensor:
        f, e = -1 if flip else 1, 2.0 * self.kappa * self.epsbar
        t = 2.0 * self.kappa * self.mubar
        den = 1.0 / (1.0 + t * t - e * e)
        return den * torch.stack([
            twist_apply_pk(chi[0], self.kappa, self.mubar, -f) - e * chi[1],
            twist_apply_pk(chi[1], self.kappa, self.mubar, f) - e * chi[0]])

    def _hop(self, u, chi, parity, dagger):
        """The flavor-diagonal hop, one launch per flavor."""
        return torch.stack([dslash_eo(u, chi[f], parity, self.lat, dagger=dagger,
                                      t_boundary=self.t_boundary) for f in (0, 1)])

    def _apply(self, u, chi_e, dagger: bool):
        w = self.site_inv(self._hop(u, chi_e, EVEN, dagger), dagger)
        return self.site(chi_e, dagger) - (self.kappa * self.kappa) * self._hop(u, w, ODD, dagger)

    def apply(self, u, chi_e: torch.Tensor) -> torch.Tensor:
        return self._apply(u, chi_e, dagger=False)

    def apply_dagger(self, u, chi_e: torch.Tensor) -> torch.Tensor:
        return self._apply(u, chi_e, dagger=True)

    def normal(self, u, chi_e: torch.Tensor) -> torch.Tensor:
        return self.apply_dagger(u, self.apply(u, chi_e))

    def prepare(self, u, b_pk: torch.Tensor) -> torch.Tensor:
        """b [2(fl), 2(par), 2(ri), 4, 3, T, Z, S] -> bhat_e = b_e + k D_eo A^{-1} b_o."""
        return b_pk[:, 0] + self.kappa * self._hop(u, self.site_inv(b_pk[:, 1]), ODD, False)

    def reconstruct(self, u, x_e: torch.Tensor, b_pk: torch.Tensor) -> torch.Tensor:
        """x_o = A^{-1} (b_o + k D_oe x_e); returns [2(fl), 2(par), ...]."""
        x_o = self.site_inv(b_pk[:, 1] + self.kappa * self._hop(u, x_e, EVEN, False))
        return torch.stack([x_e, x_o], dim=1)

    def apply_full(self, u, x_pk: torch.Tensor) -> torch.Tensor:
        """The unpreconditioned two-parity M_nd x on [2(fl), 2(par), 2(ri), ...]:
        A x_par - k D x_(1-par), per parity."""
        return torch.stack([self.site(x_pk[:, par]) - self.kappa * self._hop(
            u, x_pk[:, 1 - par], 1 - par, False) for par in (0, 1)], dim=1)
