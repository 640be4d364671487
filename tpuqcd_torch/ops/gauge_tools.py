"""Gauge-field observables, the staple sum, APE and stout smearing.

Counterpart of ``tpuqcd/ops/gauge_tools.py``: ``plaquette``, the check
setup_gauge logs after generating or loading a gauge,
``spatial_plaquette``, ``_staple_sum``, which the heatbath updates
with, and the link smearings ``ape_smear`` and ``stout_smear`` that
build the gauge of the Gaussian source smearing.

The staple algebra runs on the site-major even-odd gauge
[4, 2(par), T*Z*S, 3, 3] (``gauge_sites``), where a product over all
sites of one parity is one batched matmul and a neighbour is one gather
through the Dslash's own index map (ops/dslash_cuda.hop_index).
"""
from __future__ import annotations

import torch

from ..fields import gauge_eo_to_full
from ..lattice import AXIS_OF_MU, Lattice
from .dslash_cuda import hop_index
from .layout import gauge_from_device
from . import mat3


def plaquette(u_dev: torch.Tensor, lat: Lattice) -> float:
    """Average plaquette Re tr P / 3 over all sites and mu < nu.

    u_dev: complex device-layout gauge [4, 2, 3, 3, T, Z, S] without
    boundary phases; unit gauge -> 1.0.
    """
    u = gauge_eo_to_full(gauge_from_device(u_dev, lat), lat)   # [4, T, Z, Y, X, 3, 3]
    total = 0.0
    for mu in range(4):
        for nu in range(mu + 1, 4):
            u_nu_xmu = torch.roll(u[nu], -1, dims=AXIS_OF_MU[mu])
            u_mu_xnu = torch.roll(u[mu], -1, dims=AXIS_OF_MU[nu])
            pl = u[mu] @ u_nu_xmu @ u_mu_xnu.mH @ u[nu].mH
            tr = torch.diagonal(pl, dim1=-2, dim2=-1).sum(-1).real
            total += tr.to(torch.float64).sum().item()
    return total / (3.0 * 6.0 * lat.volume)


def gauge_sites(u_dev: torch.Tensor) -> torch.Tensor:
    """Device layout [4, 2, 3, 3, T, Z, S] -> site-major [4, 2, T*Z*S, 3, 3]."""
    return u_dev.flatten(4).permute(0, 1, 4, 2, 3).contiguous()


def gauge_from_sites(u_sm: torch.Tensor, lat: Lattice) -> torch.Tensor:
    """Site-major [4, 2, T*Z*S, 3, 3] -> device layout [4, 2, 3, 3, T, Z, S]."""
    return u_sm.permute(0, 1, 3, 4, 2).reshape(4, 2, 3, 3, *lat.site_shape).contiguous()


def neighbour_tables(lat: Lattice, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """hop_index of each stored parity: tables[sp][mu, 0 | 1] gathers
    f(x + mu) | f(x - mu) of a field on parity sp onto the sites of
    parity 1 - sp."""
    return hop_index(lat, 0, device), hop_index(lat, 1, device)


def link_at(u_sm: torch.Tensor, mu: int, parity_of_x: int, shifts, tables) -> torch.Tensor:
    """U_mu at x + sum(shifts) for every site x of parity ``parity_of_x``
    -> [T*Z*S, 3, 3]; shifts (nu, sign) apply left to right, and their
    index maps compose into one gather."""
    tp = parity_of_x ^ (len(shifts) & 1)
    idx, par = None, tp
    for nu, sign in reversed(shifts):
        step = tables[par][nu, 0 if sign > 0 else 1]
        idx = step if idx is None else idx[step]
        par ^= 1
    f = u_sm[mu, tp]
    return f if idx is None else f[idx]


def _staple_sum(u_sm: torch.Tensor, mu: int, p: int, dirs, tables) -> torch.Tensor:
    """Sum of staples around the links (x, mu) at parity-p sites over nu
    in dirs, on the site-major gauge -> [T*Z*S, 3, 3]."""
    acc = None
    for nu in dirs:
        if nu == mu:
            continue
        # forward: U_nu(x) U_mu(x+nu) U_nu(x+mu)^dag
        t1 = mat3.mul(mat3.mul(u_sm[nu, p], link_at(u_sm, mu, p, [(nu, +1)], tables)),
                      link_at(u_sm, nu, p, [(mu, +1)], tables), bdag=True)
        # backward: U_nu(x-nu)^dag U_mu(x-nu) U_nu(x-nu+mu)
        a = link_at(u_sm, nu, p, [(nu, -1)], tables)
        b = link_at(u_sm, mu, p, [(nu, -1)], tables)
        c = link_at(u_sm, nu, p, [(nu, -1), (mu, +1)], tables)
        s = t1 + mat3.mul(mat3.mul(a, b, adag=True), c)
        acc = s if acc is None else acc + s
    return acc


def spatial_plaquette(u_dev: torch.Tensor, lat: Lattice) -> float:
    """Average spatial-only plaquette (mu < nu in {x, y, z}) of a complex
    device-layout gauge [4, 2, 3, 3, T, Z, S]."""
    u_sm = gauge_sites(u_dev)
    tables = neighbour_tables(lat, u_dev.device)
    total = 0.0
    for p in (0, 1):
        for mu in range(3):
            for nu in range(mu + 1, 3):
                ab = mat3.mul(u_sm[mu, p], link_at(u_sm, nu, p, [(mu, +1)], tables))
                pl = mat3.mul(mat3.mul(ab, link_at(u_sm, mu, p, [(nu, +1)], tables), bdag=True),
                              u_sm[nu, p], bdag=True)
                total += mat3.trace(pl).real.to(torch.float64).sum().item()
    return total / (3.0 * 3.0 * lat.volume)


def _smear_step(u_sm: torch.Tensor, tables, spatial_only: bool, new_link) -> torch.Tensor:
    """One smearing step on the site-major gauge: every link (mu, parity)
    becomes new_link(link, its staple sum); t links stay with
    spatial_only.  All staples are taken from the gauge before the step."""
    dirs = (0, 1, 2) if spatial_only else (0, 1, 2, 3)
    out = u_sm.clone()
    for mu in dirs:
        for p in (0, 1):
            out[mu, p] = new_link(u_sm[mu, p], _staple_sum(u_sm, mu, p, dirs, tables))
    return out


def ape_smear_step(u_dev: torch.Tensor, lat: Lattice, alpha: float = 0.5,
                   spatial_only: bool = True) -> torch.Tensor:
    """One APE step: U' = Proj_SU3[(1 - alpha) U + (alpha / (2 (n - 1))) staples]
    over the n smeared directions; spatial_only smears x, y, z links over
    spatial staples and leaves the t links (the gauge of the Gaussian
    source smearing)."""
    return ape_smear(u_dev, lat, alpha, 1, spatial_only)


def ape_smear(u_dev: torch.Tensor, lat: Lattice, alpha: float = 0.5, n_steps: int = 10,
              spatial_only: bool = True) -> torch.Tensor:
    """n_steps APE steps on a complex device-layout gauge [4, 2, 3, 3, T, Z, S]."""
    w = alpha / (2.0 * ((3 if spatial_only else 4) - 1))
    tables = neighbour_tables(lat, u_dev.device)
    u_sm = gauge_sites(u_dev)
    for _ in range(n_steps):
        u_sm = _smear_step(u_sm, tables, spatial_only,
                           lambda u, st: mat3.project_su3((1.0 - alpha) * u + w * st))
    return gauge_from_sites(u_sm, lat)


def _stout_link(u: torch.Tensor, staples: torch.Tensor, rho: float) -> torch.Tensor:
    """exp(iQ) U with Omega = rho C U^dag, Q = (i/2)(Omega^dag - Omega) -
    (i/6) tr(Omega^dag - Omega); the exponential by its power series (16
    terms reach float32 roundoff for ||rho C U|| of order 1)."""
    omega = rho * mat3.mul(staples, u, bdag=True)
    q = 0.5j * (mat3.dag(omega) - omega)
    eye = torch.eye(3, dtype=u.dtype, device=u.device)
    iq = 1j * (q - (mat3.trace(q) / 3.0)[..., None, None] * eye)
    term = acc = eye.expand_as(q)
    for k in range(1, 17):
        term = mat3.mul(term, iq) / k
        acc = acc + term
    return mat3.mul(acc, u)


def stout_smear_step(u_dev: torch.Tensor, lat: Lattice, rho: float = 0.1,
                     spatial_only: bool = False) -> torch.Tensor:
    """One stout (analytic SU(3) exponential) smearing step."""
    return stout_smear(u_dev, lat, rho, 1, spatial_only)


def stout_smear(u_dev: torch.Tensor, lat: Lattice, rho: float = 0.1, n_steps: int = 3,
                spatial_only: bool = False) -> torch.Tensor:
    """n_steps stout steps on a complex device-layout gauge [4, 2, 3, 3, T, Z, S]."""
    tables = neighbour_tables(lat, u_dev.device)
    u_sm = gauge_sites(u_dev)
    for _ in range(n_steps):
        u_sm = _smear_step(u_sm, tables, spatial_only,
                           lambda u, st: _stout_link(u, st, rho))
    return gauge_from_sites(u_sm, lat)
