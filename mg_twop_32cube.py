"""examples/twop_mg_bf16_32cube.yaml on one NVIDIA GPU: run_twop's two-point
run at 32^3x64 through the MG branch with MG's bfloat16 solver buffers and
lockstep batches of the example's solver.rhs_batch columns:

    python3 mg_twop_32cube.py [--config examples/twop_mg_bf16_32cube.yaml] [--skip-over]

1. The gauge (cli/common.setup_gauge: 4b's c0000).
2. run_twop.measure at the example's rhs_batch W, every solver call's
   columns held to the plain float64 operator (chip_smoke.audited_measure);
   at each lockstep MG solve the columns _check_batch_fits admits then
   (with the call's columns allocated), batch_bytes of the call's width,
   the memory allocated at its start and its peak; the seconds by stage
   and all 24 columns certified by the solver and by the plain operator
   (chip_smoke.check_columns).  Were W refused, the MemoryError is printed
   with the widths admitted, and the run is made again at the smallest.
3. Unless --skip-over, the same run at W + 1, which must raise MemoryError
   at a lockstep solve before that solve allocates (its peak growth
   printed).

It imports chip_smoke and tpuqcd_torch from the current directory; every
number is printed beside the card's name and power limit.  About 15 min
on an H100 with the build and the 62 s heatbath.
"""
import argparse
import dataclasses
import gc
import sys
import time

sys.path.insert(0, ".")
import torch

import chip_smoke as cs
from tpuqcd_torch.cli import run_twop
from tpuqcd_torch.cli.common import setup_gauge
from tpuqcd_torch.lattice import Lattice
from tpuqcd_torch.mg.dsolve import DeviceMG
from tpuqcd_torch.utils.config import load_config

CALLS = []


def watched(solve):
    """solve_certified_batch recording, at each call, the columns the check
    admits with the call's columns allocated, batch_bytes and the memory."""
    def call(self, b, **kw):
        torch.cuda.synchronize()
        rec = {"n": b.shape[0], "admits": cs.admitted_columns(self),
               "batch_bytes": self.batch_bytes(b.shape[0]),
               "base": torch.cuda.memory_allocated()}
        CALLS.append(rec)
        torch.cuda.reset_peak_memory_stats()
        try:
            return solve(self, b, **kw)
        finally:
            torch.cuda.synchronize()
            rec["peak"] = torch.cuda.max_memory_allocated()
    return call


def calls_line() -> str:
    return "; ".join(
        f"{r['n']} columns: admits {r['admits']}, batch_bytes {r['batch_bytes'] / 1e9:.3f} GB, "
        f"start {r['base'] / 1e9:.3f} GB, growth {(r['peak'] - r['base']) / 1e9:.3f} GB"
        for r in CALLS)


def run(cfg, dev, gauge, smi):
    lat, u64 = Lattice(tuple(cfg.gauge.dims)), gauge.u_pk.double()
    CALLS.clear()
    t0 = time.perf_counter()
    res, counts, audited, audit_s, peak = cs.audited_measure(run_twop.measure, cfg, dev, gauge,
                                                             u64, lat)
    total = time.perf_counter() - t0
    print(f"  rhs_batch {cfg.solver.rhs_batch}: {total:.1f} s; seconds by stage: "
          + ", ".join(f"{k} {v:.3f}" for k, v in res.seconds.items())
          + f"; the plain audit {audit_s:.3f} s; peak {peak:.2f} GiB [{smi}]", flush=True)
    print(f"  lockstep solves: {calls_line()}", flush=True)
    for rec in res.solves:
        print(f"  flavor {rec['flavor']:+d} columns {rec['first_column']}-"
              f"{rec['first_column'] + rec['columns'] - 1}: relres <= {max(rec['relres']):.3e}, "
              f"inner iterations {rec['iters'][0]}", flush=True)
    cs.check_columns(res, audited, 24, "the 24 columns")
    pion = res.correlators["twop/pion/sx0sy0sz0st0"] if "twop/pion/sx0sy0sz0st0" in \
        res.correlators else None
    print(f"  correlators: {len(res.correlators)}"
          + ("" if pion is None else f"; pion p=0 t=0..3 {pion[0][:4]}"), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="examples/twop_mg_bf16_32cube.yaml")
    ap.add_argument("--skip-over", action="store_true", help="skip step 3")
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi, _ = cs.card()
    print(smi, flush=True)
    print(f"build {cs.build():.1f} s", flush=True)
    cfg = load_config(args.config)
    gauge = setup_gauge(cfg, dev)
    print(f"  gauge: plaquette {gauge.plaquette:.6f}, {gauge.seconds:.1f} s", flush=True)
    DeviceMG.solve_certified_batch = watched(DeviceMG.solve_certified_batch)
    width, refused = cfg.solver.rhs_batch, attempt(cfg, dev, gauge, smi)
    if refused:
        width = min(r["admits"] for r in CALLS)
        print(f"  rhs_batch {cfg.solver.rhs_batch} REFUSED: {refused}; {calls_line()}; again "
              f"at {width}", flush=True)
        run(with_width(cfg, width), dev, gauge, smi)
    if not args.skip_over:
        refused = attempt(with_width(cfg, width + 1), dev, gauge, smi)
        r = CALLS[-1]
        print(f"  rhs_batch {width + 1}: " + (
            f"refused at a lockstep solve of {r['n']} columns, growth {r['peak'] - r['base']} B "
            f"before the refusal: {refused}" if refused else "NOT REFUSED"), flush=True)
    print("mg_twop_32cube done", smi, flush=True)


def with_width(cfg, width):
    return dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, rhs_batch=width))


def attempt(cfg, dev, gauge, smi) -> str:
    """run() at cfg's width: '' when it ran, else the MemoryError's message
    (the run's buffers freed before returning)."""
    try:
        run(cfg, dev, gauge, smi)
        return ""
    except MemoryError as e:
        msg = str(e)
    gc.collect()
    torch.cuda.empty_cache()
    return msg


if __name__ == "__main__":
    main()
