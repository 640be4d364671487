"""Gauge-field observables.

Counterpart of ``tpuqcd/ops/gauge_tools.py`` (``plaquette`` only, the
check setup_gauge logs after generating or loading a gauge).
"""
from __future__ import annotations

import torch

from ..fields import gauge_eo_to_full
from ..lattice import AXIS_OF_MU, Lattice
from .layout import gauge_from_device


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
