"""The yardstick: the byte model reproduces the port's per-site compulsory
bytes, and the trace reduction the busy time, hop kernels and idle gaps."""
from __future__ import annotations

import types

import pytest
import torch

from qcdbench import bytes_model
from qcdbench import trace

SITES = (8, 4, 8)


def _key(dtype, rows, epilogue="none", batch=None, legs_out=False, clover=False, dirs=None):
    shape = ((batch,) if batch else ()) + (2, 4, 3, *SITES)
    psi = torch.empty(shape, dtype=dtype)
    u = torch.empty((4, 2, rows, 3, 2, *SITES), dtype=dtype)
    kw = {"epilogue": epilogue, "legs_out": legs_out, "dirs": dirs}
    if clover:
        kw["clover"] = object()
    return bytes_model.call_key(u, psi, kw)


@pytest.mark.parametrize("args, per_site", [
    ((torch.float32, 2), 576),
    ((torch.float32, 2, "xpay"), 672),
    ((torch.float32, 3), 768),
    ((torch.float32, 4), 448),
    ((torch.float32, 4, "xpay"), 544),
    ((torch.float64, 3), 1536),
    ((torch.float64, 3, "xpay"), 1728),
    ((torch.float32, 2, "clover_inv"), 1152),
    ((torch.float32, 2, "clover_xpay"), 1248),
    ((torch.float64, 3, "clover_xpay"), 2880),
])
def test_per_site_bytes(args, per_site):
    dtype, rows, *epi = args
    epilogue = epi[0] if epi else "none"
    key = _key(dtype, rows, epilogue, clover=epilogue.startswith("clover"))
    assert bytes_model.site_bytes(key) == per_site


@pytest.mark.parametrize("n", [1, 2, 4, 11, 12])
def test_batch_formula(n):
    key = _key(torch.float32, 2, "xpay", batch=n if n > 1 else None)
    assert bytes_model.site_bytes(key) == pytest.approx(288 + 384 / n)


def test_legs_out_and_one_leg():
    key = _key(torch.float32, 2, legs_out=True)
    assert bytes_model.call_bytes(key) / (8 * 4 * 8) == 480 + 768
    assert bytes_model.site_bytes(_key(torch.float32, 2, dirs=((0, 1),))) == 96 + 96 + 48


class _Event:
    def __init__(self, start, end, name, device=True):
        self.start, self.end, self.label, self.device = start, end, name, device

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self.device else torch.autograd.DeviceType.CPU

    def name(self):
        return self.label

    def start_ns(self):
        return self.start

    def end_ns(self):
        return self.end


def test_trace_reduce():
    events = [_Event(10, 20, "dslash_eo_kernel"), _Event(15, 30, "add"), _Event(0, 5, "launch", False),
              _Event(40, 50, "dslash_eo_batch_kernel"), _Event(45, 47, "mul"), _Event(60, 61, "add")]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    out = trace.reduce(prof, 0, 100)
    assert out["device_events"] == 5 and out["busy_s"] == pytest.approx(31e-9)
    assert out["hop_kernels"] == 2 and out["hop_device_s"] == pytest.approx(20e-9)
    gaps = dict(out["idle_gaps"])
    assert gaps["(end of unit)"] == pytest.approx(39e-9)
    assert gaps["dslash_eo_batch_kernel"] == pytest.approx(10e-9)
    assert gaps["dslash_eo_kernel"] == pytest.approx(10e-9) and gaps["add"] == pytest.approx(10e-9)
    assert dict(out["device_ops"])["add"] == pytest.approx(16e-9)
