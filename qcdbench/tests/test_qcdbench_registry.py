"""The harness finds every configuration, traffic mix, unit kind and metric
that BENCHMARK.json names, and a cell, a unit kind and metrics added as
files alone."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from qcdbench import registry

REPO = registry.ROOT


def test_every_name_resolves():
    bench = registry.load_benchmark()
    for w in bench["workloads"]:
        cfg = registry.config(bench, w["config"])
        assert cfg["name"] == w["config"]
        kind = registry.kind(registry.traffic(w["traffic"])["unit"])
        assert all(callable(getattr(kind, f)) for f in ("Driver", "summary", "judge"))
        assert registry.metrics_of(bench, w["name"], "per_layer")
        e2e = {m["name"] for m in registry.metrics_of(bench, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        for m in registry.metrics_of(bench, w["name"], "per_layer"):
            assert m["moves"] in e2e
    for m in bench["per_layer"] + bench["end_to_end"]:
        assert callable(registry.reader(m["name"]))
    for c in bench["configs"]:
        assert (REPO / c["file"]).is_file()


def test_cell_and_metric_added_from_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a unit kind, a traffic
    mix, a cell, an end-to-end and a per-layer metric as new files and
    BENCHMARK.json entries; the harness of the copy, unedited, runs the cell
    on the CPU and reports both metrics."""
    shutil.copytree(REPO / "qcdbench", tmp_path / "qcdbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "qcdbench/configs/tm_mg_nearcrit_32c64.json").read_text())
    cfg.update(name="tm_tiny")
    cfg["gauge"].update(dims=[4, 4, 4, 8], sweeps=3)
    cfg["run"]["mg"] = {"enabled": True, "preset": "near_critical", "n_vec": [4],
                        "block": [[2, 2, 2, 2]], "setup_iters": 10}
    (tmp_path / "qcdbench/configs/tm_tiny.json").write_text(json.dumps(cfg))
    (tmp_path / "qcdbench/kinds/flavor_pair.py").write_text(
        "from qcdbench.kinds import solve\n"
        "judge = solve.judge\n"
        "class Driver(solve.Driver):\n"
        "    def run(self, spec):\n"
        "        rec = super().run(spec)\n"
        "        rec['pairs'] = len(spec['columns']) // 2\n"
        "        return rec\n"
        "def summary(rec, spec, tol):\n"
        "    return {**solve.summary(rec, spec, tol), 'pairs': rec['pairs']}\n")
    (tmp_path / "qcdbench/traffic/pair.json").write_text(
        json.dumps({"unit": "flavor_pair", "columns": 2, "rhs_batch": 2, "flavor": -1}))
    (tmp_path / "qcdbench/metrics/tiny.columns_per_unit.py").write_text(
        "def read(run):\n"
        "    return sum(u['summary']['columns'] for u in run['units']) / len(run['units'])\n")
    (tmp_path / "qcdbench/metrics/pair_s.py").write_text(
        "from qcdbench.metrics._common import per_certified\n"
        "def read(run):\n"
        "    return per_certified(run, lambda u: u['summary']['pairs'])\n")
    bench["configs"].append({"name": "tm_tiny", "source": "a test", "file":
                             "qcdbench/configs/tm_tiny.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.pair", "config": "tm_tiny", "traffic": "pair",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "pair_s", "unit": "s/pair", "better": "lower",
                                "bound": 0.1, "source": "host_clock", "workloads": ["tiny.pair"]})
    bench["per_layer"].append({"name": "tiny.columns_per_unit", "unit": "columns",
                               "better": "higher", "source": "program_counter", "layer": "entry",
                               "moves": "pair_s", "workloads": ["tiny.pair"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, time, torch\n"
            "from qcdbench import registry\n"
            "from qcdbench.run import run_cell\n"
            "assert registry.ROOT.samefile('.'), registry.ROOT\n"
            "out = [run_cell(registry.load_benchmark(), 'tiny.pair', 7, 0.1, traced,\n"
            "                torch.device('cpu'), t_process=time.perf_counter())[0]\n"
            "       for traced in (False, True)]\n"
            "print(json.dumps(out))\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(tmp_path), str(REPO)])}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    plain, traced = json.loads(p.stdout.strip().splitlines()[-1])
    assert plain["correct"] is True and traced["correct"] is True
    assert set(plain["metrics"]) == {"pair_s", "setup_s"}
    assert plain["metrics"]["pair_s"]["unit"] == "s/pair" and plain["metrics"]["pair_s"]["value"] > 0
    assert traced["metrics"] == {"tiny.columns_per_unit": {"value": 2.0, "unit": "columns"}}
