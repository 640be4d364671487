"""Quenched SU(3) gauge generation: Cabibbo-Marinari pseudo-heatbath with
overrelaxation.

Counterpart of ``tpuqcd/ops/heatbath.py``: Wilson plaquette action
S = beta sum_p (1 - Re tr U_p / 3), the three SU(2) subgroups of each
link updated by Kennedy-Pendleton sampling (Creutz below xi = 1) or by
microcanonical overrelaxation, one (direction mu, parity p) class of
links at a time (their staples touch only other classes, so the update
is a valid heatbath).  Boundary conditions are periodic; the fermion
t-phase is folded in later (fields.apply_boundary_phase).

The public functions take and return the complex device layout
[4, 2, 3, 3, T, Z, S].  Inside, the gauge is site-major
([4, 2, T*Z*S, 3, 3], ops/gauge_tools.gauge_sites) and updated in place
class by class.  Every random draw comes from the ``torch.Generator``
passed in, which must live on the gauge's device; torch and jax.random
streams differ, so a chain matches tpuqcd's in distribution, not
bitwise.
"""
from __future__ import annotations

import math

import torch

from ..lattice import Lattice
from .gauge_tools import _staple_sum, gauge_from_sites, gauge_sites, neighbour_tables
from .mat3 import mul, project_su3

#: SU(2) subgroup index pairs of SU(3) (Cabibbo-Marinari set).
_SUBGROUPS = ((0, 1), (0, 2), (1, 2))


def _quat_of_block(w00, w01, w10, w11):
    """Real quaternion components (a0, a1, a2, a3) and norm k of the
    SU(2)-covariant part of a complex 2x2 block w: for any g in SU(2),
    Re tr(g w) = k Re tr(g V) with V = quat_matrix(a) / k in SU(2)."""
    a0 = 0.5 * (w00.real + w11.real)
    a1 = 0.5 * (w01.imag + w10.imag)
    a2 = 0.5 * (w01.real - w10.real)
    a3 = 0.5 * (w00.imag - w11.imag)
    k = torch.sqrt(a0 * a0 + a1 * a1 + a2 * a2 + a3 * a3)
    return (a0, a1, a2, a3), k


def _quat_matrix(q0, q1, q2, q3):
    """Entries of q0 I + i (q1 s1 + q2 s2 + q3 s3):
    [[q0 + i q3, q2 + i q1], [-q2 + i q1, q0 - i q3]]."""
    return (torch.complex(q0, q3), torch.complex(q2, q1), torch.complex(-q2, q1),
            torch.complex(q0, -q3))


def _mul2(a, b):
    """(2x2) @ (2x2) on entry tuples."""
    a00, a01, a10, a11 = a
    b00, b01, b10, b11 = b
    return (a00 * b00 + a01 * b10, a00 * b01 + a01 * b11,
            a10 * b00 + a11 * b10, a10 * b01 + a11 * b11)


def _sample_h0(generator: torch.Generator, xi: torch.Tensor, n_rounds: int = 30):
    """Sample h0 in [-1, 1] with density ~ sqrt(1 - h0^2) exp(xi h0),
    elementwise over xi > 0 -> (h0, accepted).

    Hybrid rejection: Kennedy-Pendleton where xi > 1, Creutz where
    xi <= 1, a fixed n_rounds of candidates, the first accepted one
    kept.  The rounds are drawn at once ([n_rounds, 5, *xi.shape]).
    An element no round accepted (rare, near xi ~ 1) reports False, and
    the caller keeps the old link rather than bias the measure."""
    dt = xi.dtype
    xi = torch.clamp(xi, min=1e-12)
    use_kp = xi > 1.0
    zmin = torch.exp(-2.0 * xi)
    r = torch.rand((n_rounds, 5, *xi.shape), generator=generator, dtype=dt,
                   device=xi.device)
    r = 1e-10 + (1.0 - 1e-10) * r
    # Kennedy-Pendleton
    lam2 = -(torch.log(r[:, 0]) + torch.cos(2.0 * math.pi * r[:, 1]) ** 2
             * torch.log(r[:, 2])) / (2.0 * xi)
    kp_ok = r[:, 3] * r[:, 3] <= 1.0 - lam2
    kp_h0 = 1.0 - 2.0 * lam2
    # Creutz
    z = zmin + (1.0 - zmin) * r[:, 0]
    cr_h0 = 1.0 + torch.log(z) / xi
    cr_ok = r[:, 4] * r[:, 4] <= 1.0 - cr_h0 * cr_h0
    cand = torch.where(use_kp, kp_h0, cr_h0)
    ok = torch.where(use_kp, kp_ok, cr_ok)
    acc = ok.any(0)
    first = torch.argmax(ok.to(torch.uint8), dim=0)
    h0 = torch.where(acc, cand.gather(0, first[None])[0], torch.ones_like(xi))
    return torch.clamp(h0, -1.0, 1.0), acc


def _su2_heatbath(generator: torch.Generator, w_block, beta_eff: float):
    """Heatbath sample g in SU(2) (2x2 entry tuple) for the weight
    exp(beta_eff Re tr(g w))."""
    (a0, a1, a2, a3), k = _quat_of_block(*w_block)
    k = torch.clamp(k, min=1e-12)
    h0, acc = _sample_h0(generator, (2.0 * beta_eff) * k)
    # uniform direction on S^2, radius sqrt(1 - h0^2)
    n = torch.randn((3, *h0.shape), generator=generator, dtype=h0.dtype, device=h0.device)
    nn = torch.clamp(torch.sqrt(n[0] ** 2 + n[1] ** 2 + n[2] ** 2), min=1e-12)
    hr = torch.sqrt(torch.clamp(1.0 - h0 * h0, min=0.0)) / nn
    h = _quat_matrix(h0, n[0] * hr, n[1] * hr, n[2] * hr)
    g = _mul2(h, _quat_matrix(a0 / k, -a1 / k, -a2 / k, -a3 / k))     # h V^dag
    # a rejection miss keeps the link (the identity), the unbiased outcome
    one, zero = torch.ones_like(g[0]), torch.zeros_like(g[0])
    return tuple(torch.where(acc, gi, fi) for gi, fi in zip(g, (one, zero, zero, one)))


def _su2_overrelax(w_block):
    """Microcanonical overrelaxation g = (V^dag)^2, which preserves
    Re tr(g w) exactly."""
    (a0, a1, a2, a3), k = _quat_of_block(*w_block)
    k = torch.clamp(k, min=1e-12)
    vdag = _quat_matrix(a0 / k, -a1 / k, -a2 / k, -a3 / k)
    return _mul2(vdag, vdag)


def _apply_subgroup(m: torch.Tensor, g, i: int, j: int) -> torch.Tensor:
    """Left-multiply rows (i, j) of the [N, 3, 3] matrices m by the 2x2 g."""
    g00, g01, g10, g11 = (x[:, None] for x in g)
    out = m.clone()
    out[:, i] = g00 * m[:, i] + g01 * m[:, j]
    out[:, j] = g10 * m[:, i] + g11 * m[:, j]
    return out


def _update_class(u_sm: torch.Tensor, mu: int, p: int, generator, beta: float, tables,
                  overrelax: bool) -> None:
    """Update, in place, all links of direction mu at parity-p sites (one
    Cabibbo-Marinari visit of the three SU(2) subgroups)."""
    st = _staple_sum(u_sm, mu, p, (0, 1, 2, 3), tables)
    link = u_sm[mu, p]
    w = mul(link, st, bdag=True)              # W = U A, A = staple^dag
    for i, j in _SUBGROUPS:
        block = (w[:, i, i], w[:, i, j], w[:, j, i], w[:, j, j])
        g = (_su2_overrelax(block) if overrelax
             else _su2_heatbath(generator, block, beta / 3.0))
        link = _apply_subgroup(link, g, i, j)
        w = _apply_subgroup(w, g, i, j)
    u_sm[mu, p] = link


def _sweep(u_sm, generator, beta, tables, overrelax: bool) -> None:
    for p in (0, 1):
        for mu in range(4):
            _update_class(u_sm, mu, p, generator, beta, tables, overrelax)


def heatbath_sweep(u_dev: torch.Tensor, generator: torch.Generator, beta: float,
                   lat: Lattice) -> torch.Tensor:
    """One full pseudo-heatbath sweep (8 link classes x 3 subgroups)."""
    u_sm = gauge_sites(u_dev)
    _sweep(u_sm, generator, beta, neighbour_tables(lat, u_dev.device), overrelax=False)
    return gauge_from_sites(u_sm, lat)


def overrelax_sweep(u_dev: torch.Tensor, lat: Lattice) -> torch.Tensor:
    """One microcanonical overrelaxation sweep (no randomness)."""
    u_sm = gauge_sites(u_dev)
    _sweep(u_sm, None, 0.0, neighbour_tables(lat, u_dev.device), overrelax=True)
    return gauge_from_sites(u_sm, lat)


def _reunit(u_sm: torch.Tensor) -> None:
    """Project every link back onto SU(3), in place."""
    u_sm.copy_(project_su3(u_sm))


def thermalize(generator: torch.Generator, lat: Lattice, beta: float, n_sweeps: int,
               n_or: int = 3, u0: torch.Tensor | None = None,
               reunit_every: int = 20) -> torch.Tensor:
    """n_sweeps compound sweeps (1 heatbath + n_or overrelaxation) from u0
    (default: the cold start su3.unit_gauge on the generator's device)
    -> the device-layout gauge.  Links are reprojected onto SU(3) every
    reunit_every sweeps and at the end."""
    from .. import su3
    if u0 is None:
        u0 = su3.unit_gauge(lat, generator.device)
    tables = neighbour_tables(lat, u0.device)
    u_sm = gauge_sites(u0)
    for i in range(int(n_sweeps)):
        _sweep(u_sm, generator, beta, tables, overrelax=False)
        for _ in range(n_or):
            _sweep(u_sm, None, 0.0, tables, overrelax=True)
        if (i + 1) % reunit_every == 0:
            _reunit(u_sm)
    _reunit(u_sm)
    return gauge_from_sites(u_sm, lat)


def generate_ensemble(generator: torch.Generator, lat: Lattice, beta: float, n_cfg: int,
                      n_therm: int = 200, n_skip: int = 20):
    """Yield n_cfg gauge configurations (device layout) of ONE Markov chain:
    thermalize n_therm compound sweeps from the cold start, then a configuration every n_skip sweeps, every draw from
    ``generator``.  No yielded tensor aliases the next (thermalize works
    on its own copy), so each is safe to keep."""
    u = thermalize(generator, lat, beta, n_therm)
    for c in range(n_cfg):
        yield u
        if c + 1 < n_cfg:
            u = thermalize(generator, lat, beta, n_skip, u0=u)
