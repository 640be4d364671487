"""ILDG payload -> the device layouts, decoded on the run's device.

Counterpart of ``tpuqcd/io/native.py:49`` ``ildg_payload_to_packed`` and
its C++ kernel ``native/ildg_layout.cpp`` (one host pass from the
big-endian payload to the packed float32 gauge with the antiperiodic-t
phase folded in).  Here the payload goes to the device as bytes and the
decode is torch there: swap each value's bytes (a flip of its 8 or 4
bytes), view them as float64 or float32, round to complex64 as tpuqcd's
reader does, and reorder the sites to even-odd and the device layout.

``ildg_payload_to_device`` is the unphased complex device layout, which
setup_gauge takes (its plaquette check and the gauge fix want the links
without the phase); ``ildg_payload_to_packed`` adds the phase and packs.
"""
from __future__ import annotations

import torch

from ..fields import apply_boundary_phase, gauge_full_to_eo
from ..lattice import Lattice
from ..ops.layout import gauge_to_device
from ..utils.packed import pack_gauge


def ildg_payload_to_device(payload, lat: Lattice, precision: int = 64,
                           device=None) -> torch.Tensor:
    """ILDG binary payload (bytes-like, big-endian) -> complex64 device
    layout [4, 2, 3, 3, T, Z, S] on ``device``, without the boundary phase."""
    width = precision // 8
    if len(payload) != lat.volume * 72 * width:
        raise ValueError(f"payload of {len(payload)} bytes is not a {lat.dims} gauge at "
                         f"{precision} bit")
    raw = torch.frombuffer(payload, dtype=torch.uint8).to(device)
    vals = raw.view(-1, width).flip(-1).view(torch.float64 if precision == 64 else torch.float32)
    del raw
    vals = vals.reshape(*lat.full_shape, 4, 3, 3, 2).to(torch.float32)
    u_full = torch.complex(vals[..., 0], vals[..., 1]).movedim(4, 0)   # [4, T, Z, Y, X, 3, 3]
    del vals
    return gauge_to_device(gauge_full_to_eo(u_full, lat), lat).contiguous()


def ildg_payload_to_packed(payload, lat: Lattice, antiperiodic_t: bool = True,
                           precision: int = 64, device=None) -> torch.Tensor:
    """ILDG binary payload -> packed float32 gauge [4, 2, 3, 3, 2, T, Z, S]
    on ``device`` with the temporal boundary phase folded in."""
    u_dev = ildg_payload_to_device(payload, lat, precision, device)
    u_dev = apply_boundary_phase(u_dev, lat, "device", antiperiodic_t)
    return pack_gauge(u_dev, torch.float32).contiguous()
