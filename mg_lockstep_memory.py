"""The lockstep MG memory check (DeviceMG.batch_bytes, _check_batch_fits)
held to one NVIDIA GPU at 32^3x64:

    python3 mg_lockstep_memory.py [--widths 1 2 4] [--admitted [--parent-count]] [--admitted-f32]
                                  [--no-trace]
                                  [--write-dims 48 48 48 96]

1. 4b's gauge (cli/common.setup_gauge: beta 6.0 heatbath, 160 compound
   sweeps, seed 0, which is c0000 of 4b's chain) and 4b's run_invert MG
   path (near_critical, kappa 0.157, mu 0.0009): its float32-buffer
   hierarchy and source.
2. Columns as in chip_smoke 4i: 4b's source, then point sources at the
   origin (spin-colour 0, 1, ...), float32 in solve_certified_batch's
   layout [N, 2(ri), 2(par), 4, 3, T, Z, S].
3. With --trace (the default): one GCR cycle of one refinement plus the
   float64 residuals (maxiter = restart, max_refine = 1) at N = 1 and 2 for
   each buffer dtype under torch.cuda.memory._record_memory_history; the
   trace is replayed to the moment of most memory allocated, and the
   blocks live then are summed by the port's line that allocated them.
4. solve_certified_batch to 1e-10 at each of --widths with float32 buffers
   (4b's hierarchy), then with both bfloat16 buffers (DeviceMG.rebuilt, 4b's
   float32 hierarchy freed first: chip_smoke 4v's twin).  Each run: the
   memory allocated at its start, its peak (max_memory_allocated, reset
   at its start) and growth, batch_bytes(N) and its terms, the peak of
   its first cycle alone, the certified relres of every column and the
   plain float64 operator's (chip_smoke.plain_relres_cols), printed in
   full, the inner iterations, refinements and seconds.
   With --admitted, on the twin: the width the check admits with the
   columns already allocated, as a caller hands them over, run to the
   end, then one column more, which must raise MemoryError before
   allocating; and with --parent-count first the width the count of the
   parent tree (2 restart + 10 fields a column, in gcr_dtype for the
   basis) admits, run under that count, whose out-of-memory error is
   printed with what was allocated.  --admitted-f32 does the same on 4b's
   float32 hierarchy, after its --widths.
5. With --write-dims: one heatbath chain member's ILDG write
   (write_ildg_gauge of a cold-start gauge at those dims; encode,
   checksum, write), and torch.distributed's default timeouts.

It imports chip_smoke (card, build, mg_path, point_columns,
plain_relres_cols) and tpuqcd_torch from the current directory; every
number is printed beside the card's name and power limit.
"""
import argparse
import collections
import contextlib
import gc
import os
import sys
import tempfile
import time

sys.path.insert(0, ".")
import torch

import chip_smoke as cs


def field_count(nbytes, field):
    return f"{nbytes / 1e9:.3f} GB ({nbytes / field:.2f} fields)"


def _site(frames):
    """(the innermost frame in tpuqcd_torch, the innermost in mg/dsolve.py or
    solvers/krylov_pk.py) of an allocation, as 'path:line name'."""
    def fmt(f):
        fn = f["filename"]
        i = fn.rfind("tpuqcd_torch")
        return f"{fn[i:] if i >= 0 else os.path.basename(fn)}:{f['line']} {f['name']}"
    inner = next((f for f in frames if "tpuqcd_torch" in f["filename"]), None)
    outer = next((f for f in frames if f["filename"].endswith(("dsolve.py", "krylov_pk.py"))),
                 None)
    return (fmt(inner) if inner else "?", fmt(outer) if outer else "?")


def peak_sites(snapshot, field):
    """Replay the allocator trace: the most bytes allocated past the start of
    recording, and the blocks live at that moment summed by allocation site."""
    events = snapshot["device_traces"][0]
    cur = peak = 0
    peak_at = -1
    sizes = {}
    for i, e in enumerate(events):
        if e["action"] == "alloc":
            sizes[e["addr"]] = e["size"]
            cur += e["size"]
        elif e["action"] == "free_requested":
            sizes.pop(e["addr"], None)
            cur -= e["size"]
        if cur > peak:
            peak, peak_at = cur, i
    live = {}
    for e in events[:peak_at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] == "free_requested":
            live.pop(e["addr"], None)
    by = collections.defaultdict(lambda: [0, 0])
    for e in live.values():
        k = _site(e.get("frames", []))
        by[k][0] += e["size"]
        by[k][1] += 1
    where = _site(events[peak_at].get("frames", [])) if peak_at >= 0 else ("?", "?")
    print(f"    trace: {len(events)} events, peak growth {field_count(peak, field)} at event "
          f"{peak_at} (allocated at {where[0]} <- {where[1]}); live then, by site:")
    for (inner, outer), (nb, cnt) in sorted(by.items(), key=lambda kv: -kv[1][0]):
        if nb >= 0.05 * field:
            print(f"      {nb / field:7.2f} fields {cnt:4d} blocks  {inner}  <-  {outer}")
    return peak


def columns(lat, dev, b_4b, n):
    """4b's source and n - 1 point sources, [n, 2(ri), 2(par), ...] float32."""
    cols = [b_4b.to(torch.float32)[None]]
    if n > 1:
        cols.append(cs.point_columns(lat, dev, n - 1))
    return torch.cat(cols).transpose(1, 2).contiguous()


def fresh():
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def measured(mg, b, **kw):
    """solve_certified_batch(b) with the memory at its start and its peak."""
    fresh()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = mg.solve_certified_batch(b, tol=cs.RELRES_MAX, inner_tol=1e-7, **kw)
    torch.cuda.synchronize()
    return res, base, torch.cuda.max_memory_allocated(), time.perf_counter() - t0


def traced(mg, label, b, field):
    """One cycle of one refinement and the float64 residuals under the
    allocator's history."""
    fresh()
    torch.cuda.memory._record_memory_history(enabled="all", context="alloc", stacks="python",
                                             max_entries=4_000_000)
    try:
        res, base, peak, secs = measured(mg, b, maxiter=mg.params.restart, max_refine=1)
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    print(f"  trace {label} N={b.shape[0]}: start {field_count(base, field)}, one cycle's "
          f"growth {field_count(peak - base, field)}, batch_bytes "
          f"{field_count(mg.batch_bytes(b.shape[0]), field)}, {secs:.1f} s", flush=True)
    peak_sites(snap, field)
    del res, snap


def run(mg, label, lat, dev, b_4b, u64, n, field, smi):
    """The one-cycle peak, then the certified solve of n columns."""
    b = columns(lat, dev, b_4b, n)
    need = mg.batch_bytes(n)
    terms = mg.batch_buffers(n)
    try:
        _, base1, peak1, _ = measured(mg, b, maxiter=mg.params.restart, max_refine=1)
        res, base, peak, secs = measured(mg, b)
    except torch.OutOfMemoryError as e:
        torch.cuda.synchronize()
        print(f"  {label} N={n}: OUT OF MEMORY, allocated "
              f"{torch.cuda.memory_allocated() / 1e9:.3f} GB, peak so far "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, batch_bytes "
              f"{field_count(need, field)}: {str(e).splitlines()[0][:300]} [{smi}]", flush=True)
        del e
        fresh()
        return False
    x = res.x.transpose(1, 2).contiguous()
    bb = b.transpose(1, 2).contiguous()
    del b
    fresh()
    plain = cs.plain_relres_cols(u64, bb, x, lat, cs.MG_KAPPA, cs.MG_MU)
    ok = max(res.relres) <= cs.RELRES_MAX and max(plain) <= cs.RELRES_MAX
    print(f"  {label} N={n}: start {base / 1e9:.3f} GB, peak {peak / 1e9:.3f} GB, growth "
          f"{field_count(peak - base, field)}; first cycle's growth "
          f"{field_count(peak1 - base1, field)}; batch_bytes {field_count(need, field)} "
          f"({'covers' if need >= peak - base else 'UNDER'} the growth); certified relres "
          f"{[repr(r) for r in res.relres]}, plain f64 max {max(plain):.3e} "
          f"({'certified' if ok else 'NOT CERTIFIED'}); {res.iters} inner iterations, "
          f"{res.refinements} refinements, {secs:.2f} s [{smi}]", flush=True)
    if terms:
        print("    terms: " + ", ".join(f"{k} {v / field:.2f}" for k, v in terms.items())
              + " fields")
    del res, x, bb
    fresh()
    return True


def admitted_run(mg, buffers, lat, dev, b_4b, u64, field, smi):
    """run() at the width the check admits with the columns allocated, then
    one column more, which must be refused before allocating."""
    n = admitted_with_columns(mg, lat, dev, b_4b)
    print(f"  _check_batch_fits admits {n} columns with them allocated ({buffers} buffers)",
          flush=True)
    run(mg, f"{buffers} buffers, admitted width", lat, dev, b_4b, u64, n, field, smi)
    b = columns(lat, dev, b_4b, n + 1)
    fresh()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        mg.solve_certified_batch(b, tol=cs.RELRES_MAX, inner_tol=1e-7)
        print(f"  N={n + 1}: NOT REFUSED", flush=True)
    except MemoryError as e:
        print(f"  N={n + 1}: refused before allocating (peak growth "
              f"{torch.cuda.max_memory_allocated() - before} B): {e}", flush=True)
    del b
    fresh()


def admitted_with_columns(mg, lat, dev, b_4b) -> int:
    """The most columns _check_batch_fits lets through with those columns
    allocated, as solve_certified_batch receives them."""
    n = cs.admitted_columns(mg) + 1
    while n > 0:
        b = columns(lat, dev, b_4b, n)
        try:
            mg._check_batch_fits(n)
            return n
        except MemoryError:
            n -= 1
        finally:
            del b
            fresh()
    return 0


@contextlib.contextmanager
def parent_count(mg):
    """The parent tree's count on ``mg``: 2 restart + 10 fine fields a column
    (the basis in gcr_dtype) and as many of every coarse level's."""
    def old(n_rhs):
        basis = 2 * mg.params.restart
        fine_basis = basis * torch.finfo(mg._basis_dtype()).bits // 32
        coarse = mg._column_field_bytes() - mg._fine_field_bytes()
        return n_rhs * ((fine_basis + 10) * mg._fine_field_bytes() + (basis + 10) * coarse)
    mg.batch_bytes = old
    try:
        yield
    finally:
        del mg.batch_bytes


def write_member(dims, smi):
    from tpuqcd_torch import su3
    from tpuqcd_torch.fields import gauge_eo_to_full
    from tpuqcd_torch.io.lime import write_ildg_gauge
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.ops.layout import gauge_from_device
    lat = Lattice(tuple(dims))
    u_dev = su3.unit_gauge(lat, torch.device("cuda", 0))
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        wr = write_ildg_gauge(os.path.join(d, "m.lime"),
                              gauge_eo_to_full(gauge_from_device(u_dev, lat), lat), lat)
        total = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(d, "m.lime"))
    print(f"  ILDG write of one member at {'x'.join(map(str, dims))} ({size / 1e9:.2f} GB, "
          f"64-bit): {total:.2f} s with the device-to-host copy; "
          + ", ".join(f"{k} {v:.2f} s" for k, v in wr.items()) + f" [{smi}]", flush=True)
    from torch.distributed import constants
    print(f"  torch.distributed default timeouts: {constants.default_pg_timeout} (gloo), "
          f"{getattr(constants, 'default_pg_nccl_timeout', None)} (nccl); torch "
          f"{torch.__version__}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", type=int, nargs="*", default=[1, 2, 4])
    ap.add_argument("--admitted", action="store_true")
    ap.add_argument("--parent-count", action="store_true")
    ap.add_argument("--admitted-f32", action="store_true")
    ap.add_argument("--no-trace", action="store_true")
    ap.add_argument("--write-dims", type=int, nargs=4)
    args = ap.parse_args()
    from tpuqcd_torch.lattice import Lattice
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi, _ = cs.card()
    print(smi, flush=True)
    print(f"build {cs.build():.1f} s", flush=True)
    lat = Lattice(cs.LARGE)
    gauge = cs.heatbath_gauge(dev, cs.LARGE)
    mg_res, _ = cs.mg_path(dev, gauge)
    mg, b_4b = mg_res.mg, mg_res.b_pk
    print(f"  4b: {mg_res.iters} inner iterations, relres {mg_res.relres:.3e}", flush=True)
    mg_res = None
    field = mg._fine_field_bytes()
    u64 = gauge.u_pk.double()
    if not args.no_trace:
        for n in (1, 2):
            traced(mg, "float32", columns(lat, dev, b_4b, n), field)
    for n in args.widths:
        run(mg, "float32 buffers", lat, dev, b_4b, u64, n, field, smi)
    if args.admitted_f32:
        admitted_run(mg, "float32", lat, dev, b_4b, u64, field, smi)
    twin = mg.rebuilt(cs.bf16_params(mg.params))
    del mg
    fresh()
    if not args.no_trace:
        for n in (1, 2):
            traced(twin, "bfloat16", columns(lat, dev, b_4b, n), field)
    for n in args.widths:
        run(twin, "bfloat16 buffers", lat, dev, b_4b, u64, n, field, smi)
    if args.admitted:
        if args.parent_count:
            with parent_count(twin):
                n = admitted_with_columns(twin, lat, dev, b_4b)
                print(f"  the parent tree's count admits {n} columns with them allocated",
                      flush=True)
                run(twin, "bfloat16 buffers, the parent tree's count", lat, dev, b_4b, u64, n,
                    field, smi)
        admitted_run(twin, "bfloat16", lat, dev, b_4b, u64, field, smi)
    del twin, u64, gauge
    fresh()
    if args.write_dims:
        write_member(args.write_dims, smi)
    print("mg_lockstep_memory done", smi, flush=True)


if __name__ == "__main__":
    main()
