"""Gauge-field observables and the staple sum.

Counterpart of ``tpuqcd/ops/gauge_tools.py``: ``plaquette``, the check
setup_gauge logs after generating or loading a gauge, and
``_staple_sum``, which the heatbath updates with.

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
