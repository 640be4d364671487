"""The one traffic generator: a traffic file (qcdbench/traffic/<name>.json)
names a unit kind ("unit", a module qcdbench/kinds/<unit>.py) and its
parameters, and the seed alone draws the sources of every unit.

    {"unit": <kind>, "columns": n, ...}  A unit takes n spin-colour point-
        source columns (12, a whole propagator, where n is not given).  The
        seed draws a first column and a source position; units take the
        columns in turn, cycling through all 12, and a new position is
        drawn once the 12 are done.

Further keys (rhs_batch, flavor) are the kind's own.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference.fields import full_to_packed


def unit_specs(traffic: dict, seed: int, dims):
    """Yield each unit's {"position": (t, z, y, x), "columns": [...]}."""
    rng = np.random.default_rng(int(seed))
    lx, ly, lz, lt = dims
    n = int(traffic.get("columns", 12))
    col, done, pos = int(rng.integers(12)), 12, None
    while True:
        if done >= 12:
            pos, done = tuple(int(rng.integers(m)) for m in (lt, lz, ly, lx)), 0
        yield {"position": pos, "columns": [(col + j) % 12 for j in range(n)]}
        col, done = (col + n) % 12, done + n


def point_columns(dims, pos, columns, device) -> torch.Tensor:
    """The packed float32 point sources [n, 2(par), 2(ri), 4, 3, T, Z, S]."""
    lx, ly, lz, lt = dims
    full = torch.zeros((len(columns), lt, lz, ly, lx, 4, 3), dtype=torch.complex64)
    t, z, y, x = pos
    for i, c in enumerate(columns):
        full[i, t, z, y, x, c // 3, c % 3] = 1.0
    return full_to_packed(full, dims).to(device)
