"""MG's bfloat16 solver buffers and the plain float64 audit on one NVIDIA
GPU, at 32^3x64 on a random gauge:

    python3 mg_bf16_probe.py

1. the plain float64 residual |b - M x| / |b| of one column at a time
   (chip_smoke.plain_full_relres) against the same residuals of 2, 4, 6 and
   12 columns in one batched plain call, seconds a column, the extra peak
   allocation and the largest difference (twice);
2. a two-level MG (n_vec 16, block 4^4, restart 24, kappa 0.115, mu 0.08,
   bfloat16 smoother and coarse links) with float32 buffers and its twin
   with both bfloat16 buffers (DeviceMG.rebuilt), the float32 hierarchy
   freed before the twin's solve: each solve's certified and plain
   relres, inner iterations, seconds, the allocation at its start and its
   peak; restrict + prolong per V-cycle on both banks (CUDA events); the
   columns DeviceMG._check_batch_fits admits with either GCR basis.

It imports chip_smoke (problem, plain_full_relres, time_ms) and
tpuqcd_torch from the current directory; every line names the card.
"""
import sys, time, subprocess
sys.path.insert(0, ".")
import torch
import chip_smoke as cs


def main():
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print("card", smi, torch.__version__, torch.version.cuda, flush=True)
    from tpuqcd_torch.ops import dslash_cuda
    t0 = time.perf_counter(); dslash_cuda.library.get(); print("build", time.perf_counter() - t0, flush=True)

    from tpuqcd_torch.ops.dslash_cuda import dslash_eo_plain

    def relres_cols(u64, b, x, lat, kappa, mu):
        """b, x [N, 2(par), 2(ri), 4, 3, T, Z, S] f64 -> per-column relres via batched plain calls."""
        m = [dslash_eo_plain(u64, x[:, 1 - par].contiguous(), 1 - par, lat, epilogue="xpay",
                             kappa=kappa, mu=mu, psi0=x[:, par].contiguous(), xpay_scale=kappa)
             for par in (0, 1)]
        r = b - torch.stack(m, dim=1)
        return ((r.square().flatten(1).sum(1) / b.square().flatten(1).sum(1)).sqrt()).tolist()

    lat, gauges, psi, psi0 = cs.problem(cs.LARGE, dev, seed=3)
    u64 = gauges["f64"]
    g = torch.Generator(device=dev).manual_seed(5)
    N = 12
    shape = (N, 2, 2, 4, 3, *lat.site_shape)
    b = torch.randn(shape, generator=g, dtype=torch.float64, device=dev)
    x = torch.randn(shape, generator=g, dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    for rep in range(2):
        t0 = time.perf_counter()
        one = [cs.plain_full_relres(u64, b[i], x[i], lat) for i in range(4)]
        torch.cuda.synchronize(); t1 = time.perf_counter()
        print(f"single plain relres: {(t1 - t0) / 4:.4f} s a column", flush=True)
        for nb in (2, 4, 6, 12):
            torch.cuda.reset_peak_memory_stats(); base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            rb = relres_cols(u64, b[:nb], x[:nb], lat, cs.KAPPA, cs.MU)
            torch.cuda.synchronize(); t1 = time.perf_counter()
            print(f"batched N={nb}: {(t1 - t0) / nb:.4f} s a column, peak +{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB; "
                  f"max rel diff to single {max(abs(a - c) / c for a, c in zip(rb[:4], one)):.2e}", flush=True)
    del b, x, gauges, psi, psi0
    torch.cuda.empty_cache()

    # --- MG with bf16 buffers at 32^3x64 on a random gauge (far from critical) ---
    from tpuqcd_torch.mg.device import DeviceFineLevel, DeviceFineTransfer
    from tpuqcd_torch.mg.dsolve import DeviceMG, DeviceMGParams
    from tpuqcd_torch.solve import solve_tm_mg
    lat, gauges, psi, psi0 = cs.problem(cs.LARGE, dev, seed=4)
    u32 = gauges["f32_18"] if "f32_18" in gauges else gauges["f64"].float()
    u64 = gauges["f64"]
    del gauges, psi, psi0
    fine = DeviceFineLevel(lat, u64.float().contiguous(), 0.115, 0.08)
    params = DeviceMGParams(n_vec=(16,), block=((4, 4, 4, 4),), setup_iters=20, restart=24,
                            smoother_dtype="bfloat16", coarse_dtype="bfloat16", coarse_iters=24)
    t0 = time.perf_counter(); mg = DeviceMG(fine, params); torch.cuda.synchronize()
    print("setup", time.perf_counter() - t0, mg.setup_seconds, flush=True)
    bsrc = torch.randn((2, 2, 4, 3, *lat.site_shape), generator=g, device=dev)
    def solve(m, tag):
        torch.cuda.synchronize(); base = torch.cuda.memory_allocated(); torch.cuda.reset_peak_memory_stats()
        dslash_cuda.reset_counts(); t0 = time.perf_counter()
        res = solve_tm_mg(m, bsrc, tol=1e-10, inner_tol=1e-7)
        torch.cuda.synchronize(); s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        rel = cs.plain_full_relres(u64, bsrc.double(), res.x, lat, 0.115, 0.08)
        print(f"{tag}: relres {res.relres:.3e} plain {rel:.3e} iters {res.iters} ref {res.refinements} "
              f"{s:.2f} s; base {base / 1e9:.3f} GB peak {peak / 1e9:.3f} GB; counts {dict(dslash_cuda.counts)}", flush=True)
        return peak, res
    p32, r32 = solve(mg, "f32")
    r32 = None
    tr32 = mg.transfers[0]
    r = torch.randn((2, 2, 4, 3, *lat.site_shape), generator=g, device=dev)
    ms32 = cs.time_ms(lambda: tr32.prolong(tr32.restrict(r)), reps=10)
    twin = mg.rebuilt(DeviceMGParams(**{**params.__dict__, "gcr_dtype": "bfloat16", "vec_dtype": "bfloat16"}))
    tr16 = twin.transfers[0]
    ms16 = cs.time_ms(lambda: tr16.prolong(tr16.restrict(r)), reps=10)
    print(f"restrict+prolong ms: f32 {ms32:.3f} bf16 {ms16:.3f}; twin setup {twin.setup_seconds}", flush=True)
    print("links vs f32 twin: ", ((twin.levels[1].links_c - mg.levels[1].links_c).abs().max() / mg.levels[1].links_c.abs().max()).item())
    del mg, tr32
    torch.cuda.empty_cache()
    p16, r16 = solve(twin, "bf16")
    print(f"peak drop {(p32 - p16) / 1e9:.3f} GB (reckoned {(48 + 16) * 96 * lat.volume / 2 / 1e9:.3f})", flush=True)
    for gdt in ("float32", "bfloat16"):
        import copy, dataclasses
        pr = copy.copy(twin); pr.params = dataclasses.replace(twin.params, gcr_dtype=gdt)
        n_ok = 0
        for n in range(1, 65):
            try:
                pr._check_batch_fits(n); n_ok = n
            except MemoryError:
                break
        print(f"admits {gdt}: {n_ok}", flush=True)
    print("probe done", smi, flush=True)


if __name__ == "__main__":
    main()
