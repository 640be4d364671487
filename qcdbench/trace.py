"""The device trace of one unit: torch.profiler (CUPTI kernel and memory
activity, no host-op recording) around the unit, reduced to the device's
busy time, the hop's kernels and the idle gaps.

The hop is the port's ``ops/dslash_cuda.dslash_eo``.  ``HopCalls`` wraps it
wherever the port's modules hold it and counts its calls by what their
compulsory bytes depend on (bytes_model.call_key).  Its kernels are the
device operations named after it ("dslash"); their number is checked
against the calls and against the port's own launch counter, so a hop that
leaves dslash_eo, or a kernel that changes its name, leaves the roofline
share unread rather than wrong.
"""
from __future__ import annotations

import collections
import contextlib
import sys

import numpy as np
import torch

from . import bytes_model

HOP_KERNEL = "dslash"


class HopCalls:
    """Counts the port's hop calls by byte key while installed."""

    def __init__(self):
        self.keys = collections.Counter()

    @contextlib.contextmanager
    def installed(self):
        from tpuqcd_torch.ops import dslash_cuda
        orig = dslash_cuda.dslash_eo
        keys = self.keys

        def dslash_eo(u, psi, src_parity, lat, **kw):
            keys[bytes_model.call_key(u, psi, kw)] += 1
            return orig(u, psi, src_parity, lat, **kw)

        patched = [mod for name, mod in list(sys.modules.items())
                   if name.split(".")[0] == "tpuqcd_torch"
                   and getattr(mod, "dslash_eo", None) is orig]
        for mod in patched:
            mod.dslash_eo = dslash_eo
        try:
            yield self
        finally:
            for mod in patched:
                mod.dslash_eo = orig

    def bytes(self) -> int:
        return sum(bytes_model.call_bytes(k) * n for k, n in self.keys.items())

    def calls(self) -> int:
        return sum(self.keys.values())


class _NoDevice:
    """The profiler of a run without a card: no device, nothing to record."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def profiler(device):
    """Device activity only: the host's ops are not recorded (an MG column
    launches some hundreds of thousands of kernels)."""
    if device.type != "cuda":
        return _NoDevice()
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                  record_shapes=False, with_stack=False)


def reduce(prof, w0: int, w1: int, top: int = 10) -> dict:
    """The device operations of the profiled unit: busy_s (the union of
    their intervals), window_s (the unit on the host's clock, [w0, w1] in
    time.time_ns()), the hop kernels' count and device seconds, the
    operations that took most time and the idle gaps by the operation that
    ended them.  The profile spans the unit alone, so no operation is cut
    at the window's edges (the device's clock and the host's may differ by
    some microseconds).  Vectorised: an MG unit holds some 1.8 million
    device operations."""
    events = [] if isinstance(prof, _NoDevice) else prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    ids, names, start, end = {}, [], [], []
    for e in events:
        if e.device_type() != cpu:
            n = e.name()
            i = ids.get(n)
            if i is None:
                i = ids[n] = len(ids)
            names.append(i)
            start.append(e.start_ns())
            end.append(e.end_ns())
    out = {"window_s": (w1 - w0) * 1e-9, "device_events": len(names)}
    if not names:
        return {**out, "busy_s": None}
    label = list(ids)
    order = np.argsort(np.asarray(start, dtype=np.int64), kind="stable")
    st = np.asarray(start, dtype=np.int64)[order]
    en = np.asarray(end, dtype=np.int64)[order]
    nm = np.asarray(names, dtype=np.int64)[order]
    reach = np.maximum.accumulate(en)              # the latest end so far
    gap = np.empty_like(st)                        # idle time before each operation
    gap[0] = max(st[0] - w0, 0)
    gap[1:] = np.maximum(st[1:] - reach[:-1], 0)
    last = int(reach[-1])
    out["busy_s"] = (last - int(st[0]) - int(gap[1:].sum())) * 1e-9
    by_name = np.bincount(nm, weights=(en - st).astype(np.float64), minlength=len(label))
    idle = np.bincount(nm, weights=gap.astype(np.float64), minlength=len(label))
    hop = np.array([HOP_KERNEL in n for n in label])
    top_ops = np.argsort(-by_name)[:top]
    gaps = [[label[i], float(idle[i]) * 1e-9] for i in np.argsort(-idle)[:top] if idle[i] > 0]
    if w1 > last:
        gaps = sorted(gaps + [["(end of unit)", (w1 - last) * 1e-9]], key=lambda g: -g[1])[:top]
    out.update(hop_device_s=float(by_name[hop].sum()) * 1e-9,
               hop_kernels=int(hop[nm].sum()),
               device_ops=[[label[i], float(by_name[i]) * 1e-9] for i in top_ops],
               idle_gaps=gaps)
    return out
