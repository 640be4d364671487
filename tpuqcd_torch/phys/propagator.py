"""Full-layout spinors -> packed two-parity fields.

Counterpart of ``tpuqcd/phys/propagator.py:29`` (``full_to_packed`` only;
the propagator and its contractions come with a later slice).
"""
from __future__ import annotations

import torch

from ..fields import full_to_eo
from ..lattice import Lattice
from ..ops.layout import spinor_to_device
from ..utils.packed import pack_spinor


def full_to_packed(psi_full: torch.Tensor, lat: Lattice,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """complex [T, Z, Y, X, 4, 3] -> packed [2(par), 2(ri), 4, 3, T, Z, S]."""
    return pack_spinor(spinor_to_device(full_to_eo(psi_full, lat), lat), dtype)
