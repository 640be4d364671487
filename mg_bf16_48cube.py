"""examples/invert_mg_bf16_48cube.yaml on one NVIDIA GPU: near-critical
MG at 48^3x96 with both bfloat16 solver buffers, then the same recipe
with float32 buffers on the same gauge, expected to run out of memory:

    python3 mg_bf16_48cube.py

The heatbath gauge once (setup_gauge), then run_invert's invert for each
buffer dtype: the certified and the plain float64 relres, inner
iterations, refinements, solve and setup seconds, the peak allocation of
the setup and of the solve (torch.cuda.max_memory_allocated, reset as the
solve starts) and the allocation at the solve's start; an out-of-memory
error is printed with what was allocated.  It imports chip_smoke (card,
build, plain_full_relres) and tpuqcd_torch from the current directory.
"""
import dataclasses, gc, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from tpuqcd_torch.cli import common
from tpuqcd_torch.cli.common import setup_gauge
from tpuqcd_torch.cli.run_invert import invert
from tpuqcd_torch.lattice import Lattice
from tpuqcd_torch.utils.config import load_config


def main():
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi, _ = cs.card()
    print(smi, flush=True)
    print(f"build {cs.build():.1f} s", flush=True)
    cfg = load_config("examples/invert_mg_bf16_48cube.yaml")
    t0 = time.perf_counter()
    gauge = setup_gauge(cfg, dev)
    torch.cuda.synchronize()
    print(f"heatbath {cfg.gauge.dims} {cfg.gauge.heatbath_sweeps} sweeps: {time.perf_counter() - t0:.1f} s, "
          f"plaquette {gauge.plaquette:.6f}", flush=True)

    rec = {}
    call = common.MGSolver.__call__


    def peaked(self, *a, **kw):
        torch.cuda.synchronize()
        rec["setup_peak"] = torch.cuda.max_memory_allocated()
        rec["base"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = call(self, *a, **kw)
        torch.cuda.synchronize()
        rec["peak"] = torch.cuda.max_memory_allocated()
        return out


    common.MGSolver.__call__ = peaked
    for label, dt in (("bfloat16", "bfloat16"), ("float32", "float32")):
        c = dataclasses.replace(cfg, mg=dataclasses.replace(cfg.mg, gcr_dtype=dt, vec_dtype=dt))
        rec.clear()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        print(f"--- {label} buffers: allocated before {torch.cuda.memory_allocated() / 1e9:.3f} GB",
              flush=True)
        t0 = time.perf_counter()
        try:
            res = invert(c, dev, gauge)
        except (torch.OutOfMemoryError, MemoryError) as e:
            torch.cuda.synchronize()
            print(f"{label}: out of memory after {time.perf_counter() - t0:.1f} s, allocated "
                  f"{torch.cuda.memory_allocated() / 1e9:.3f} GB, peak so far "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, record {rec}: "
                  f"{str(e).splitlines()[0][:300]}", flush=True)
            del e
            continue
        st = res.setup_seconds
        print(f"{label}: certified relres {res.relres:.3e} (solver {res.solver_relres:.3e}), inner "
              f"iterations {res.iters}, refinements {res.refinements}, solve {res.seconds:.3f} s, "
              f"setup {st['mg_setup']:.2f} s (nulls0 {st['nulls0']:.2f}, galerkin0 "
              f"{st['galerkin0']:.2f}); setup peak {rec['setup_peak'] / 1e9:.3f} GB, solve start "
              f"{rec['base'] / 1e9:.3f} GB, solve peak {rec['peak'] / 1e9:.3f} GB", flush=True)
        x, b = res.x, res.b_pk
        res = None
        gc.collect()
        torch.cuda.empty_cache()
        rel = cs.plain_full_relres(gauge.u_pk.double(), b.double(), x, Lattice(tuple(cfg.gauge.dims)),
                                   cfg.action.kappa, cfg.action.mu)
        print(f"{label}: plain-operator relres {rel:.3e}", flush=True)
        del x, b
    print("run_48cube done", smi, flush=True)


if __name__ == "__main__":
    main()
