"""Where the harness finds what BENCHMARK.json names: a cell's configuration
file (its "file"), its traffic mix (qcdbench/traffic/<traffic>.json), the
unit kind the traffic names (qcdbench/kinds/<unit>.py) and each metric's
reader, end-to-end and per-layer alike (qcdbench/metrics/<metric>.py, a
function ``read(run)`` that returns a number, or None where it finds
nothing to read).  A new configuration, traffic mix, unit kind or metric
is a new file and a new entry, never an edit."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def load_benchmark(path: Path | None = None) -> dict:
    return json.loads(Path(path or ROOT / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"BENCHMARK.json has no config {name!r}")


def traffic(name: str) -> dict:
    return json.loads((PKG / "traffic" / f"{name}.json").read_text())


def kind(name: str):
    """The module of a unit kind (see qcdbench/kinds/__init__.py)."""
    return importlib.import_module(f"qcdbench.kinds.{name}")


def reader(name: str):
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"qcdbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell: str, group: str) -> list[dict]:
    """The entries of ``group`` (end_to_end or per_layer) that ``cell`` reports."""
    return [m for m in bench[group] if cell in m.get("workloads", [cell])]
