"""Full site order <-> even-odd layout, and the temporal boundary phase.

Counterpart of ``tpuqcd/fields.py``.  The even-odd split is a pair view
of the x axis: X -> (X//2, 2); within each pair the even element is the
one at index s(t, z, y) = (t + z + y) % 2.
"""
from __future__ import annotations

import torch

from .lattice import Lattice

EVEN, ODD = 0, 1


def _sub_parity(lat: Lattice, nb: int, n_inner: int, device) -> torch.Tensor:
    """bool mask s(t,z,y)==1, shaped to broadcast over [*batch, T,Z,Y,Xh, *inner]."""
    s = lat.eo_sub_parity(device)[..., None]
    return s.reshape((1,) * nb + s.shape + (1,) * n_inner)


def full_to_eo(f: torch.Tensor, lat: Lattice, site_ndim_left: int = 0) -> torch.Tensor:
    """[..., T, Z, Y, X, *inner] -> [..., 2, T, Z, Y, X//2, *inner]."""
    b = site_ndim_left
    T, Z, Y, X = f.shape[b:b + 4]
    inner = f.shape[b + 4:]
    fp = f.reshape(*f.shape[:b], T, Z, Y, X // 2, 2, *inner)
    s = _sub_parity(lat, b, len(inner), f.device)
    e0, e1 = fp.select(b + 4, 0), fp.select(b + 4, 1)
    return torch.stack([torch.where(s, e1, e0), torch.where(s, e0, e1)], dim=b)


def eo_to_full(f: torch.Tensor, lat: Lattice, site_ndim_left: int = 0) -> torch.Tensor:
    """[..., 2, T, Z, Y, X//2, *inner] -> [..., T, Z, Y, X, *inner]."""
    b = site_ndim_left
    even, odd = f.select(b, 0), f.select(b, 1)
    T, Z, Y, Xh = even.shape[b:b + 4]
    inner = even.shape[b + 4:]
    s = _sub_parity(lat, b, len(inner), f.device)
    pairs = torch.stack([torch.where(s, odd, even), torch.where(s, even, odd)],
                        dim=b + 4)
    return pairs.reshape(*even.shape[:b], T, Z, Y, 2 * Xh, *inner)


def gauge_full_to_eo(u: torch.Tensor, lat: Lattice) -> torch.Tensor:
    """[4, T, Z, Y, X, 3, 3] -> [4, 2, T, Z, Y, X//2, 3, 3]."""
    return full_to_eo(u, lat, site_ndim_left=1)


def gauge_eo_to_full(u: torch.Tensor, lat: Lattice) -> torch.Tensor:
    return eo_to_full(u, lat, site_ndim_left=1)


#: the T axis of U_t (u[3]) in each gauge layout
_T_AXIS = {"full": 0,        # [4, T, Z, Y, X, 3, 3]
           "eo": 1,          # [4, 2, T, Z, Y, X//2, 3, 3]
           "device": 3}      # [4, 2, 3, 3, T, Z, S] (ops/layout.gauge_to_device)


def apply_boundary_phase(u: torch.Tensor, lat: Lattice, layout: str = "full",
                         antiperiodic_t: bool = True) -> torch.Tensor:
    """Fold the fermion temporal boundary condition into the links.

    Returns a copy with U_t(t = Lt-1) multiplied by -1 (``layout`` full,
    eo or device), so that the hop stays periodic.
    """
    if not antiperiodic_t:
        return u
    out = u.clone()
    out[3].select(_T_AXIS[layout], lat.Lt - 1).neg_()
    return out

