"""A whole CPU rehearsal of each cell at 4^3x8, in a fresh process: correct,
labelled device cpu, no device metric, and neither JAX nor the JAX package
loaded (top-level module names compared whole: tpuqcd_torch begins with
tpuqcd)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from qcdbench import registry

CODE = """
import json, sys
from qcdbench.tests.small import rehearse
out = []
for traced in (False, True):
    res, _ = rehearse({cell!r}, traced=traced)
    out.append(res)
loaded = sorted({{m.split(".")[0] for m in sys.modules}} & {{"jax", "jaxlib", "flax", "tpuqcd"}})
print(json.dumps({{"results": out, "forbidden": loaded}}))
"""


@pytest.mark.parametrize("cell", [w["name"] for w in registry.load_benchmark()["workloads"]])
def test_rehearsal(cell):
    p = subprocess.run([sys.executable, "-c", CODE.format(cell=cell)], cwd=registry.ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == []
    bench = registry.load_benchmark()
    device_metrics = {m["name"] for m in bench["per_layer"] if m["source"] == "device_trace"}
    plain, traced = out["results"]
    for res in (plain, traced):
        assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
        assert res["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                                 "memory_peak_bytes": None}
        assert not set(res["metrics"]) & device_metrics
        assert "breakdown" not in res
        assert list(res)[-1] == "checks"
    e2e = {m["name"] for m in registry.metrics_of(bench, cell, "end_to_end")}
    assert set(plain["metrics"]) == e2e
    assert traced["metrics"] and set(traced["metrics"]) <= {
        m["name"] for m in registry.metrics_of(bench, cell, "per_layer")}
