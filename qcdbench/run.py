"""Run one cell of the benchmark once and print its result as the last line.

    python3 -m qcdbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json, qcdbench/ and the
port (tpuqcd_torch/).  Set-up: the gauge file (made by the frozen chain
only where the checkout has none), the port's input path, its solver set-up
and a warm-up of every shape the cell's units use.  The window: units back
to back, from the seed's sources, until the first unit that ends at or
after --seconds.  Then the program's state is freed and the plain
reference judges every output of the window.  With --trace 1 the window
is the first unit alone, run under torch.profiler, and the per-layer
metrics are printed instead of the end-to-end ones.  ``--control 1`` judges the reference put
in the program's place one precision lower instead (a check of the
limits: it has to come out not correct).

Needs a CUDA card: without one, or with fewer than the cell asks for, it
exits non-zero and prints no result.  Lines before the last give the
card, the set-up's parts and each unit; the last lines of standard error
give each compared number beside its limit.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time


def _process_start() -> float:
    """perf_counter() at the moment this process started (Linux /proc)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_PROCESS = _process_start()

import torch  # noqa: E402

from . import registry, trace  # noqa: E402
from .inputs import gauge as gauge_input  # noqa: E402
from .sources import unit_specs  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tpuqcd")


def say(tag: str, obj) -> None:
    print(f"# {tag} {json.dumps(obj, default=str)}", flush=True)


def card_state() -> dict:
    q = "name,power.limit,power.draw,clocks.sm,clocks.mem,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return {"query": q, "cards": out.splitlines()}


def run_cell(bench: dict, cell: str, seed: int, seconds: float, traced: bool, device,
             control: bool = False, config: dict | None = None,
             t_process: float | None = None) -> tuple[dict, dict]:
    """One run of ``cell``; returns (the result line's object, the compared
    numbers with their limits).  ``config`` replaces the cell's
    configuration (the CPU rehearsal's small lattice)."""
    t0 = T_PROCESS if t_process is None else t_process
    w = registry.workload(bench, cell)
    cfg = config or registry.config(bench, w["config"])
    traffic = registry.traffic(w["traffic"])
    kind = traffic["unit"]
    units_of = registry.kind(kind)
    detail = {}
    t = time.perf_counter()
    gauge_file, made = gauge_input.ensure(cfg["gauge"], device)
    detail["gauge_make"] = made
    detail["gauge_ensure_s"] = time.perf_counter() - t
    t = time.perf_counter()
    driver = units_of.Driver(cfg, traffic, str(gauge_file), device, detail)
    detail["driver_setup_s"] = time.perf_counter() - t
    from tpuqcd_torch.ops import dslash_cuda
    tol = driver.cfg.solver.tol
    specs = unit_specs(traffic, seed, cfg["gauge"]["dims"])
    units, trace_out, hops = [], None, trace.HopCalls()
    dslash_cuda.reset_counts()
    t_window = time.perf_counter()
    setup_s = t_window - t0
    say("setup", {"setup_s": setup_s, **detail})
    while True:
        spec = next(specs)
        if traced:
            # the traced window is one unit, under the profiler; its start
            # and stop are not the unit's time
            prof = trace.profiler(device)
            with hops.installed(), prof:
                ts = time.perf_counter()
                w0 = time.time_ns()
                rec = driver.run(spec)
                w1 = time.time_ns()
                te = time.perf_counter()
            profiler_s = time.perf_counter() - te + (ts - t_window)
            launches = sum(n for k, n in dslash_cuda.counts.items() if k != "plain")
            t_window = ts
        else:
            ts = time.perf_counter()
            rec = driver.run(spec)
            te = time.perf_counter()
        rec.update(spec=spec, seconds=te - ts)
        summary = units_of.summary(rec, spec, tol)
        rec["summary"] = summary
        units.append(rec)
        say("unit", {"k": len(units) - 1, "position": spec["position"],
                     "spec_columns": spec["columns"], "seconds": te - ts,
                     "ends_at": te - t_window, **summary})
        if traced or te - t_window >= seconds:
            break
    window_s = te - t_window
    program = driver.program()
    launch_counts = dict(dslash_cuda.counts)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    audit_bytes = sum(x.numel() * x.element_size() for u in units
                      for x in [x for _, x, _ in u["audit"]] + [u.get("returned")]
                      if x is not None)
    if traced:
        t = time.perf_counter()
        trace_out = trace.reduce(prof, w0, w1)
        trace_out.update(hop_bytes=hops.bytes(), hop_calls=hops.calls(), hop_launches=launches,
                         profiler_s=profiler_s)
        del prof
        say("trace", {**{k: v for k, v in trace_out.items()
                         if k not in ("device_ops", "idle_gaps")},
                      "reduce_s": time.perf_counter() - t})
    say("window", {"window_s": window_s, "units": len(units), "launch_counts": launch_counts,
                   "memory_peak_bytes": peak, "audit_bytes_held": audit_bytes,
                   "card": card_state() if device.type == "cuda" else None})
    driver.close()
    del driver
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = units_of.judge(units, cfg, traffic, str(gauge_file), device, control=control)
    limits = cfg["limits"]
    checks = {k: {"value": v if math.isfinite(v) else 1e300, "limit": limits[k]}
              for k, v in numbers.items()}
    say("judge", {"judge_s": time.perf_counter() - t, "control": control})
    attempted = len(units)
    failed = sum(not u["summary"]["ok"] for u in units)
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    run = {"cell": cell, "kind": kind,
           "units": [{k: v for k, v in u.items() if k not in ("audit", "returned")}
                     for u in units],
           "program": program, "trace": trace_out, "setup_s": setup_s,
           "window_s": window_s,
           "card": torch.cuda.get_device_name(device) if device.type == "cuda" else None}
    metrics = {}
    for m in registry.metrics_of(bench, cell, "per_layer" if traced else "end_to_end"):
        if m["source"] == "device_trace" and device.type != "cuda":
            continue
        val = registry.reader(m["name"])(run)
        if val is not None:
            metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev}
    if traced and trace_out is not None and trace_out.get("busy_s") is not None:
        dev.update(busy_s=trace_out["busy_s"], window_s=trace_out["window_s"])
        result["breakdown"] = {"device_ops": trace_out["device_ops"],
                               "idle_gaps": trace_out["idle_gaps"]}
    result["checks"] = checks
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import tpuqcd_torch  # noqa: F401  (the program under test: nothing runs without it)
    bench = registry.load_benchmark()
    chips = registry.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"qcdbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    say("card", {"name": torch.cuda.get_device_name(device), "torch": torch.__version__,
                 "cuda": torch.version.cuda})
    result, checks = run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), device, control=bool(args.control))
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"qcdbench: modules that the port must not load are loaded: {loaded}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
