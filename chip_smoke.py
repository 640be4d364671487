"""Smoke run of the PyTorch/CUDA port (tpuqcd_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. the card: its name and power limit from nvidia-smi, and
   torch.cuda.get_device_name;
2. the build of tpuqcd_torch/csrc/dslash_eo.cu with nvcc for sm_90a, and
   its seconds;
3. the Dslash kernel against its plain PyTorch version on the card, at
   8^3x16 and 32^3x64, in every mode the solves run (epilogues none,
   twist_inv, xpay and xpay with the kappa scale; both source parities;
   dagger off and on) and in each storage type (float64 18-real links,
   float32 and bfloat16 reconstruct-12 links); then the leg modes (K4):
   legs_out with all 8 legs and with a dirs subset given out of order,
   each single dirs leg, and legs_out into the parity views of an MG
   field, in the same parities, daggers and storage types; and the MG
   fine operator (DeviceFineLevel.apply: xpay into the parity views of an
   MG field, flavor +1 and -1) in each storage type;
4. the main paths, each with the kernel's launch counts set to 0 just
   before it and read just after, the certified residual, and an
   independent float64 residual of the solution through the plain
   version:
   a. tpuqcd_torch.cli.run_invert at 32^3x64 (random gauge seed 1,
      kappa 0.115, mu 0.08, CG, tol 1e-10);
   b. run_invert's multigrid path at 32^3x64: a beta = 6.0 heatbath gauge
      (160 compound sweeps), kappa 0.157, mu 0.0009, mg.preset
      near_critical, inner_tol 1e-7, tol 1e-10; it prints the plaquette,
      the setup seconds by stage, the inner iterations and refinements;
5. times at 32^3x64: the kernel per launch for each epilogue and storage
   type the solves use and for the legs_out and dirs modes, beside the
   plain version, with GFLOP/s and effective GB/s.

The line before the last is the JSON summary of the kernels; the last
line is {"ok": true, "device": {...}}.  Without CUDA, or without the
tpuqcd_torch package beside this file, it exits with code 1 and prints
no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

KAPPA, MU = 0.115, 0.08
SMALL, LARGE = (8, 8, 8, 16), (32, 32, 32, 64)
#: storage types: (name, dtype, link rows, tolerance on max|k - p| / max|p|)
STORAGE = (("f64", torch.float64, 3, 1e-13),
           ("f32", torch.float32, 2, 1e-5),
           ("bf16", torch.bfloat16, 2, 1e-2))   # about 2 bf16 ulp
#: epilogue modes: (name, epilogue, xpay_scale)
MODES = (("none", "none", None), ("twist_inv", "twist_inv", None),
         ("xpay", "xpay", None), ("xpay_full", "xpay", KAPPA))
#: the multigrid cell: heatbath gauge, near-critical action and preset
MG_KAPPA, MG_MU, MG_BETA, MG_SWEEPS = 0.157, 0.0009, 6.0, 160
PLAQ_BETA6, PLAQ_TOL = 0.5937, 0.002
FLOP_PER_SITE = 1320
RELRES_MAX = 1e-10
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet, at the 700 W limit


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card() -> tuple[str, str]:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    return line, torch.cuda.get_device_name(0)


def build() -> float:
    from tpuqcd_torch.ops.dslash_cuda import library
    library.get()
    for ln in library.build_log.splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"  ptxas: {ln.strip()}")
    return library.build_seconds


def problem(dims, dev, seed=0):
    """Random gauge with the boundary phase, packed in every storage type,
    and two random spinors of one parity, on ``dev``."""
    from tpuqcd_torch import su3
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.utils.convert import gauge_from_full
    lat = Lattice(dims)
    gen = torch.Generator().manual_seed(seed)
    u64 = gauge_from_full(su3.random_gauge(lat, gen, dev, torch.complex128), lat,
                          True, torch.float64, dev)
    gauges = {name: (u64 if rows == 3 else u64[:, :, :2]).to(dt).contiguous()
              for name, dt, rows, _ in STORAGE}
    shape = (2, 4, 3, *lat.site_shape)
    psi = torch.randn(shape, generator=gen, dtype=torch.float64).to(dev)
    psi0 = torch.randn(shape, generator=gen, dtype=torch.float64).to(dev)
    return lat, gauges, psi, psi0


def compare(dims, dev) -> dict:
    """Kernel against plain version; returns {storage: max abs err}."""
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo, dslash_eo_plain
    lat, gauges, psi64, psi064 = problem(dims, dev)
    max_abs = {}
    for name, dt, _, tol in STORAGE:
        u, psi, psi0 = gauges[name], psi64.to(dt), psi064.to(dt)
        max_abs[name] = 0.0
        for mode, epi, scale in MODES:
            rel = 0.0
            for parity in (0, 1):
                for dagger in (False, True):
                    kw = dict(dagger=dagger, epilogue=epi, kappa=KAPPA, mu=MU,
                              psi0=psi0 if epi == "xpay" else None, xpay_scale=scale)
                    k = dslash_eo(u, psi, parity, lat, **kw).double()
                    p = dslash_eo_plain(u, psi, parity, lat, **kw).double()
                    torch.cuda.synchronize()
                    if not torch.isfinite(k).all():
                        fail(f"{dims} {name} {mode}: non-finite kernel output")
                    err = (k - p).abs().max().item()
                    max_abs[name] = max(max_abs[name], err)
                    rel = max(rel, err / p.abs().max().item())
            ok = rel <= tol
            print(f"  {'x'.join(map(str, dims))} {name:4s} {mode:9s} "
                  f"max rel err {rel:.3e} (tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"kernel disagrees with the plain version: {dims} {name} {mode}")
    return max_abs


def compare_legs(dims, dev) -> dict:
    """The leg modes (K4) against the plain version; returns {storage:
    max abs err over the legs_out cases}."""
    from tpuqcd_torch.ops.dslash_cuda import LEG_ORDER, dslash_eo, dslash_eo_plain
    lat, gauges, psi64, _ = problem(dims, dev, seed=3)
    subset = ((3, -1), (0, +1), (2, +1))           # out of the kernel's order
    cases = [("legs_out", dict(legs_out=True)),
             ("legs_out_subset", dict(legs_out=True, dirs=subset))]
    cases += [(f"dirs{m}{'+' if s > 0 else '-'}", dict(dirs=((m, s),))) for m, s in LEG_ORDER]
    max_abs = {}
    for name, dt, _, tol in STORAGE:
        u = gauges[name]
        # psi as the odd-parity view of an MG field [2(ri), 2(par), ...]
        field = torch.stack([psi64, psi64.flip(0)], dim=1).to(dt)
        psi = field[:, 1]
        max_abs[name] = 0.0
        rel = {}
        for parity in (0, 1):
            for dagger in (False, True):
                for case, kw in cases:
                    k = dslash_eo(u, psi, parity, lat, dagger=dagger, **kw).double()
                    p = dslash_eo_plain(u, psi, parity, lat, dagger=dagger, **kw).double()
                    torch.cuda.synchronize()
                    if not torch.isfinite(k).all():
                        fail(f"{dims} {name} {case}: non-finite kernel output")
                    err = (k - p).abs().max().item()
                    if case.startswith("legs_out"):
                        max_abs[name] = max(max_abs[name], err)
                    rel[case] = max(rel.get(case, 0.0), err / p.abs().max().item())
                # legs_out written into the parity views of an MG leg bank
                out = torch.empty((8, *field.shape), dtype=dt, device=dev)
                dslash_eo(u, psi, parity, lat, dagger=dagger, legs_out=True, out=out[:, :, 0])
                p = dslash_eo_plain(u, psi, parity, lat, dagger=dagger, legs_out=True)
                torch.cuda.synchronize()
                err = (out[:, :, 0].double() - p.double()).abs().max().item()
                rel["legs_out_view"] = max(rel.get("legs_out_view", 0.0),
                                           err / p.double().abs().max().item())
        for case, r in rel.items():
            ok = r <= tol
            print(f"  {'x'.join(map(str, dims))} {name:4s} {case:15s} "
                  f"max rel err {r:.3e} (tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"leg mode disagrees with the plain version: {dims} {name} {case}")
    return max_abs


def compare_fine_apply(dims, dev) -> dict:
    """The MG fine operator M v (mg/device.DeviceFineLevel.apply: xpay with
    the kappa scale, psi0 and out the parity views of an MG field
    [2(ri), 2(par), ...]) at the MG cell's kappa and mu, flavor +1 and -1
    (the CG-NE setup), in each storage type (the float32 level, its bf16
    smoother twin, its float64 certification twin), against the plain
    version on contiguous copies of the same parities; returns {storage:
    max abs err}."""
    from tpuqcd_torch.mg.device import DeviceFineLevel
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo_plain
    lat, gauges, psi64, psi064 = problem(dims, dev, seed=4)
    field = torch.stack([psi64, psi064], dim=1)           # [2(ri), 2(par), 4, 3, T, Z, S]
    max_abs = {}
    for flavor in (+1, -1):
        f32 = DeviceFineLevel(lat, gauges["f64"].float(), MG_KAPPA, MG_MU, flavor)
        for name, level in (("f64", f32.as_hp()), ("f32", f32), ("bf16", f32.sloppy())):
            u = level.u_pk if level.u12 is None else level.u12
            tol = next(s[3] for s in STORAGE if s[0] == name)
            v = field.to(u.dtype)
            k = level.apply(v).double()
            p = torch.stack([dslash_eo_plain(
                u, v[:, 1 - par].contiguous(), 1 - par, lat, epilogue="xpay",
                kappa=MG_KAPPA, mu=MG_MU, flavor=flavor, t_boundary=level.t_boundary,
                psi0=v[:, par].contiguous(), xpay_scale=MG_KAPPA).double()
                for par in (0, 1)], dim=1)
            torch.cuda.synchronize()
            if not torch.isfinite(k).all():
                fail(f"{dims} {name} fine apply flavor {flavor:+d}: non-finite output")
            err = (k - p).abs().max().item()
            max_abs[name] = max(max_abs.get(name, 0.0), err)
            rel = err / p.abs().max().item()
            ok = rel <= tol
            print(f"  {'x'.join(map(str, dims))} {name:4s} fine apply flavor {flavor:+d} "
                  f"max rel err {rel:.3e} (tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"MG fine apply disagrees with the plain version: {dims} {name} "
                     f"flavor {flavor:+d}")
    return max_abs


def plain_full_relres(u64, b, x, lat, kappa=KAPPA, mu=MU) -> float:
    """|b - M x| / |b| of the two-parity system with the plain version."""
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo_plain
    m = [dslash_eo_plain(u64, x[1 - par].contiguous(), 1 - par, lat, epilogue="xpay",
                         kappa=kappa, mu=mu, psi0=x[par].contiguous(), xpay_scale=kappa)
         for par in (0, 1)]
    r = b - torch.stack(m)
    return (r.square().sum() / b.square().sum()).sqrt().item()


def main_path(dev):
    from tpuqcd_torch.cli.common import random_source, setup_gauge
    from tpuqcd_torch.cli.run_invert import invert
    from tpuqcd_torch.ops import dslash_cuda
    from tpuqcd_torch.utils.config import config_from_dict
    cfg = config_from_dict({
        "gauge": {"dims": list(LARGE), "random_seed": 1},
        "action": {"kappa": KAPPA, "mu": MU},
        "solver": {"solver": "cg", "tol": RELRES_MAX}})
    torch.cuda.synchronize()
    dslash_cuda.reset_counts()
    res = invert(cfg, dev)
    torch.cuda.synchronize()
    counts = dict(dslash_cuda.counts)
    print(f"  launches during the solve: {counts}")
    if counts.get("float32", 0) <= 0 or counts.get("float64", 0) <= 0:
        fail(f"the solve did not launch the float32 and float64 kernels: {counts}")
    if counts.get("plain", 0) != 0:
        fail(f"the solve called the plain version {counts['plain']} times")
    if not (res.relres <= RELRES_MAX and torch.isfinite(res.x).all()):
        fail(f"certified relres {res.relres:.3e} > {RELRES_MAX:.0e} or non-finite x")
    if tuple(res.x.shape) != (2, 2, 4, 3, LARGE[3], LARGE[2], LARGE[1] * LARGE[0] // 2):
        fail(f"solution shape {tuple(res.x.shape)}")
    # independent check: the same problem, rebuilt from its seeds, and the
    # plain float64 operator (launches here are outside the counted run)
    lat, u_pk, _, _ = setup_gauge(cfg, dev)
    b = random_source(lat, dev).double()
    rel_plain = plain_full_relres(u_pk.double(), b, res.x, lat)
    print(f"  certified relres {res.relres:.3e}, plain-operator relres {rel_plain:.3e}, "
          f"solver relres {res.solver_relres:.3e}, iters {res.iters}, "
          f"refinements {res.refinements}, wallclock {res.seconds:.3f} s")
    if not rel_plain <= RELRES_MAX:
        fail(f"plain-operator relres {rel_plain:.3e} > {RELRES_MAX:.0e}")
    return res, counts


def mg_path(dev):
    """run_invert's multigrid path on the 32^3x64 heatbath gauge."""
    from tpuqcd_torch.cli.run_invert import invert
    from tpuqcd_torch.ops import dslash_cuda
    from tpuqcd_torch.utils.config import config_from_dict
    cfg = config_from_dict({
        "gauge": {"dims": list(LARGE), "heatbath_beta": MG_BETA,
                  "heatbath_sweeps": MG_SWEEPS, "random_seed": 0},
        "action": {"kappa": MG_KAPPA, "mu": MG_MU},
        "solver": {"tol": RELRES_MAX, "inner_tol": 1e-7},
        "mg": {"enabled": True, "preset": "near_critical"}})
    torch.cuda.synchronize()
    dslash_cuda.reset_counts()
    res = invert(cfg, dev)
    torch.cuda.synchronize()
    counts = dict(dslash_cuda.counts)
    st = res.setup_seconds
    print(f"  heatbath beta {MG_BETA}, {MG_SWEEPS} compound sweeps: plaquette "
          f"{res.plaquette:.6f} (|p - {PLAQ_BETA6}| = {abs(res.plaquette - PLAQ_BETA6):.2e}, "
          f"limit {PLAQ_TOL}), {st['gauge']:.1f} s")
    print(f"  MG setup {st['mg_setup']:.2f} s: null vectors {st['nulls0']:.2f} s, "
          f"Galerkin probing {st['galerkin0']:.2f} s")
    print(f"  launches during setup and solve: {counts}")
    if abs(res.plaquette - PLAQ_BETA6) > PLAQ_TOL:
        fail(f"plaquette {res.plaquette:.6f} is not within {PLAQ_TOL} of {PLAQ_BETA6}")
    for key in ("float32", "bfloat16", "float64", "float32:legs_out"):
        if counts.get(key, 0) <= 0:
            fail(f"the MG path did not launch the {key} kernel: {counts}")
    if counts.get("plain", 0) != 0:
        fail(f"the MG path called the plain version {counts['plain']} times")
    if not (res.relres <= RELRES_MAX and res.solver_relres <= RELRES_MAX
            and torch.isfinite(res.x).all()):
        fail(f"certified relres {res.relres:.3e} / {res.solver_relres:.3e} > "
             f"{RELRES_MAX:.0e} or non-finite x")
    from tpuqcd_torch.lattice import Lattice
    rel_plain = plain_full_relres(res.u_pk.double(), res.b_pk.double(), res.x, Lattice(LARGE),
                                  MG_KAPPA, MG_MU)
    print(f"  certified relres {res.relres:.3e} (hierarchy's own {res.solver_relres:.3e}), "
          f"plain-operator relres {rel_plain:.3e}, inner iterations {res.iters}, "
          f"refinements {res.refinements}, solve wallclock {res.seconds:.3f} s")
    if not rel_plain <= RELRES_MAX:
        fail(f"plain-operator relres {rel_plain:.3e} > {RELRES_MAX:.0e}")
    return res, counts


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bytes_per_site(dt, rows, xpay) -> tuple[int, int]:
    """(naive, compulsory) device-memory bytes per output site.  Naive
    reads the 8 neighbour spinors and 8 links, stores one spinor and, for
    xpay, reads psi0; compulsory reads each spinor once, since a neighbour
    spinor read by 8 sites can come from the caches (links are each read
    once either way)."""
    item = torch.empty((), dtype=dt).element_size()
    spinor, link = 24 * item, rows * 6 * item
    tail = 8 * link + spinor + (spinor if xpay else 0)
    return 8 * spinor + tail, spinor + tail


def timings(dev, card_tag) -> dict:
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo, dslash_eo_plain
    lat, gauges, psi64, psi064 = problem(LARGE, dev, seed=2)
    sites = lat.half_volume
    out = {}
    for name, dt, rows, _ in STORAGE:
        u, psi, psi0 = gauges[name], psi64.to(dt), psi064.to(dt)
        modes = MODES if name == "f32" else MODES[3:]
        for mode, epi, scale in modes:
            kw = dict(epilogue=epi, kappa=KAPPA, mu=MU, xpay_scale=scale,
                      psi0=psi0 if epi == "xpay" else None)
            k_ms = time_ms(lambda: dslash_eo(u, psi, 0, lat, **kw), reps=50)
            p_ms = time_ms(lambda: dslash_eo_plain(u, psi, 0, lat, **kw), reps=3, warmup=1)
            gf = FLOP_PER_SITE * sites / (k_ms * 1e-3) / 1e9
            naive, comp = (b * sites / (k_ms * 1e-3)
                           for b in bytes_per_site(dt, rows, epi == "xpay"))
            print(f"  {'x'.join(map(str, LARGE))} {name} recon-{rows * 6} {mode:9s} "
                  f"kernel {k_ms:.4f} ms ({gf:.1f} GFLOP/s; effective {naive / 1e9:.1f} GB/s "
                  f"naive, {comp / 1e9:.1f} GB/s compulsory = "
                  f"{comp / HBM_BYTES_PER_S:.1%} of 3.35 TB/s) | plain {p_ms:.3f} ms | {card_tag}")
            out[(name, mode)] = (k_ms, p_ms)
    # legs_out (f32, reconstruct-12, the probing operand): one spinor and 8
    # links read, 8 spinors written per output site
    u, psi = gauges["f32"], psi64.float()
    k_ms = time_ms(lambda: dslash_eo(u, psi, 0, lat, legs_out=True), reps=50)
    p_ms = time_ms(lambda: dslash_eo_plain(u, psi, 0, lat, legs_out=True), reps=3, warmup=1)
    byts = (96 + 8 * 48 + 8 * 96) * sites
    print(f"  {'x'.join(map(str, LARGE))} f32 recon-12 legs_out kernel {k_ms:.4f} ms "
          f"({byts / 1e9:.2f} GB compulsory, {byts / (k_ms * 1e-3) / 1e9:.1f} GB/s = "
          f"{byts / (k_ms * 1e-3) / HBM_BYTES_PER_S:.1%} of 3.35 TB/s; floor "
          f"{byts / HBM_BYTES_PER_S * 1e3:.3f} ms) | plain {p_ms:.3f} ms | {card_tag}")
    out[("f32", "legs_out")] = (k_ms, p_ms)
    # one dirs leg (the per-leg probing path): one spinor, one link, one store
    k_ms = time_ms(lambda: dslash_eo(u, psi, 0, lat, dirs=((3, +1),)), reps=50)
    p_ms = time_ms(lambda: dslash_eo_plain(u, psi, 0, lat, dirs=((3, +1),)), reps=3, warmup=1)
    print(f"  {'x'.join(map(str, LARGE))} f32 recon-12 dirs (t, +1) kernel {k_ms:.4f} ms | "
          f"plain {p_ms:.3f} ms | {card_tag}")
    out[("f32", "dirs")] = (k_ms, p_ms)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", flush=True)
        sys.exit(1)
    try:
        import tpuqcd_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: the tpuqcd_torch package is not importable here: {e}", flush=True)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full float32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    print("phase 1: card", flush=True)
    smi, name = card()
    card_tag = f"[{smi}]"
    print(f"  nvidia-smi: {smi}; torch: {name}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    print("phase 2: build", flush=True)
    t0 = time.perf_counter()
    secs = build()
    print(f"  built tpuqcd_torch/csrc/dslash_eo.cu in {secs:.1f} s "
          f"(load {time.perf_counter() - t0:.1f} s)", flush=True)

    print("phase 3: kernel against plain version", flush=True)
    compare(SMALL, dev)
    max_abs = compare(LARGE, dev)
    print("phase 3: leg modes (K4) against plain version", flush=True)
    compare_legs(SMALL, dev)
    legs_abs = compare_legs(LARGE, dev)
    print("phase 3: MG fine apply against plain version", flush=True)
    compare_fine_apply(SMALL, dev)
    fine_abs = compare_fine_apply(LARGE, dev)

    print("phase 4a: main path, tpuqcd_torch.cli.run_invert (CG) at 32^3x64", flush=True)
    res, counts = main_path(dev)
    print("phase 4b: main path, tpuqcd_torch.cli.run_invert (MG) at 32^3x64", flush=True)
    mg_res, mg_counts = mg_path(dev)

    print(f"phase 5: times {card_tag}", flush=True)
    t = timings(dev, card_tag)
    print(f"  CG solve: {res.seconds:.3f} s wallclock, {res.iters} sloppy matvecs, "
          f"{res.gflops:.1f} GFLOP/s (solve_flops accounting) {card_tag}")
    print(f"  MG solve: {mg_res.seconds:.3f} s wallclock, {mg_res.iters} inner iterations, "
          f"{mg_res.refinements} refinements; setup {mg_res.setup_seconds['mg_setup']:.2f} s "
          f"{card_tag}")

    from tpuqcd_torch.ops.dslash_cuda import SOURCE
    src = "tpuqcd_torch/csrc/" + SOURCE.name
    replaces = "tpuqcd/ops/dslash_pallas.py:514"

    def entry(name, launches, err, timed):
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": t[timed][0],
                "plain_ms": t[timed][1]}

    kernels = [
        entry("dslash_eo<float> reconstruct-12 (CG sloppy operator), xpay timed",
              counts["float32"], max_abs["f32"], ("f32", "xpay")),
        entry("dslash_eo<double> 18-real (CG certification operator), xpay_full timed",
              counts["float64"], max_abs["f64"], ("f64", "xpay_full")),
        entry("dslash_eo<float> reconstruct-12 (MG fine operator), xpay_full timed",
              mg_counts["float32"], fine_abs["f32"], ("f32", "xpay_full")),
        entry("dslash_eo<bf16> reconstruct-12 (MG smoother), xpay_full timed",
              mg_counts["bfloat16"], fine_abs["bf16"], ("bf16", "xpay_full")),
        entry("dslash_eo<double> 18-real (MG certification operator), xpay_full timed",
              mg_counts["float64"], fine_abs["f64"], ("f64", "xpay_full")),
        entry("dslash_eo<float> reconstruct-12 legs_out (K4, MG Galerkin probing)",
              mg_counts["float32:legs_out"], legs_abs["f32"], ("f32", "legs_out")),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
