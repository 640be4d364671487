"""Phase timers and analytic flop counts.

Counterpart of ``tpuqcd/utils/profile.py``.  A phase on a CUDA device is
timed on the host clock; the caller synchronises inside the phase.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

#: analytic flop count per lattice site of the twisted-mass hop
#: (BASELINE.md Tier 2)
FLOPS_TM_DSLASH = 1392


def sync(device: torch.device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU), so that a
    host clock read after it includes that work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Profile:
    """Phase timers and flop counters."""

    def __init__(self):
        self.times = defaultdict(float)
        self.flops = defaultdict(float)

    @contextlib.contextmanager
    def phase(self, name: str, flops: float = 0.0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] += time.perf_counter() - t0
            self.flops[name] += flops

    def add_flops(self, name: str, flops: float):
        self.flops[name] += flops


def solve_flops(lat, iters: int) -> float:
    """CG on the normal equations: 4 twisted-mass parity Dslash per
    iteration (the axpys are not counted)."""
    return float(FLOPS_TM_DSLASH * lat.half_volume * 4 * int(iters))
