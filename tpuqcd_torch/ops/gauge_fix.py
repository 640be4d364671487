"""Gauge fixing (Landau / Coulomb) by checkerboard overrelaxation.

Counterpart of ``tpuqcd/ops/gauge_fix.py``.  Maximizes

    F[g] = sum_{x, mu in dirs} Re tr[ g(x) U_mu(x) g(x+mu)^dag ]

(dirs: all four for Landau, the spatial three for Coulomb) by sweeping
the even and the odd sites: on one parity all local updates are
independent, so a half sweep is one batched SU(3) projection of the
local sum K(x) = sum_mu [U_mu(x) + U_mu(x-mu)^dag] over the sites of
that parity, overrelaxed as project(1 + OMEGA (g - 1)).  The sweeps stop
when the functional, in float64, changes by less than tol.

The gauge is the complex device layout [4, 2, 3, 3, T, Z, S] without the
boundary phase; inside it is site-major ([4, 2, T*Z*S, 3, 3],
ops/gauge_tools.gauge_sites) and a neighbour is a gather through the
Dslash's index map.  It runs on the gauge's device.
"""
from __future__ import annotations

import torch

from ..lattice import Lattice
from . import mat3
from .gauge_tools import gauge_from_sites, gauge_sites, link_at, neighbour_tables

#: the overrelaxation parameter, in (1, 2): g -> g^OMEGA to first order
OMEGA = 1.7


def _dirs(gauge: str) -> tuple[int, ...]:
    if gauge not in ("landau", "coulomb"):
        raise ValueError(f"gauge must be landau or coulomb, got {gauge!r}")
    return (0, 1, 2, 3) if gauge == "landau" else (0, 1, 2)


def _local_k(u_sm: torch.Tensor, p: int, dirs, tables) -> torch.Tensor:
    """K(x) = sum_mu [U_mu(x) + U_mu(x-mu)^dag] at parity-p sites."""
    acc = None
    for mu in dirs:
        t = u_sm[mu, p] + mat3.dag(link_at(u_sm, mu, p, [(mu, -1)], tables))
        acc = t if acc is None else acc + t
    return acc


def _apply_g(u_sm: torch.Tensor, g_p: torch.Tensor, p: int, tables) -> None:
    """Gauge-transform, in place, the links that parity-p g touches:
    U_mu(x) -> g(x) U_mu(x) at parity p, U_mu(x) -> U_mu(x) g(x+mu)^dag at
    parity 1 - p."""
    for mu in range(4):
        g_at_xpmu = g_p[tables[p][mu, 0]]            # g(x + mu) at the 1-p sites
        u_sm[mu, 1 - p] = mat3.mul(u_sm[mu, 1 - p], g_at_xpmu, bdag=True)
        u_sm[mu, p] = mat3.mul(g_p, u_sm[mu, p])


def functional(u_dev: torch.Tensor, lat: Lattice, gauge: str = "landau") -> float:
    """F / (3 n_dirs V) in float64: sum over the gauge's directions of
    Re tr U_mu(x)."""
    return _functional(gauge_sites(u_dev), _dirs(gauge), lat)


def _functional(u_sm: torch.Tensor, dirs, lat: Lattice) -> float:
    f = sum(mat3.trace(u_sm[mu, p]).real.to(torch.float64).sum() for p in (0, 1) for mu in dirs)
    return f.item() / (3.0 * len(dirs) * lat.volume)


def gauge_fix(u_dev: torch.Tensor, lat: Lattice, *, gauge: str = "landau",
              n_sweeps: int = 200, tol: float = 1e-9) -> tuple[torch.Tensor, list[float]]:
    """Returns (u_fixed, the functional after each sweep).

    Each local update is overrelaxed as project(1 + OMEGA (g - 1)).  The
    links are reprojected onto SU(3) every 10 sweeps and at the end (3
    Newton steps)."""
    dirs = _dirs(gauge)
    tables = neighbour_tables(lat, u_dev.device)
    u_sm = gauge_sites(u_dev).clone()     # gauge_sites may return a view of u_dev
    eye = torch.eye(3, dtype=u_sm.dtype, device=u_sm.device)

    def half_sweep(p):
        g = mat3.project_su3(mat3.dag(_local_k(u_sm, p, dirs, tables)))
        g = mat3.project_su3((1.0 - OMEGA) * eye + OMEGA * g)
        _apply_g(u_sm, g, p, tables)

    def reunit():
        u_sm.copy_(mat3.project_su3(u_sm, iters=3))

    hist = []
    f_prev = _functional(u_sm, dirs, lat)
    for it in range(int(n_sweeps)):
        half_sweep(0)
        half_sweep(1)
        if (it + 1) % 10 == 0:
            reunit()
        f = _functional(u_sm, dirs, lat)
        hist.append(f)
        if abs(f - f_prev) < tol:
            break
        f_prev = f
    reunit()
    return gauge_from_sites(u_sm, lat), hist
