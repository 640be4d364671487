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
   field, in the same parities, daggers and storage types; the clover
   epilogues (K3: clover_inv, clover_xpay and clover_xpay with the kappa
   scale) with a clover term built from the random gauge at csw 1.2, in
   the same parities, daggers and storage types; and the MG fine
   operators (DeviceFineLevel.apply and DeviceFineCloverLevel.apply: xpay
   or clover_xpay into the parity views of an MG field, flavor +1 and -1)
   in each storage type;
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
   c. run_invert's direct twisted-clover path at 32^3x64 with the action
      and solver of BASELINE config 2 (random gauge seed 1, kappa 0.115,
      mu 0.06, csw 1.2, BiCGStab on bfloat16 storage, inner_tol 1e-4,
      tol 1e-10); the plain residual applies A directly;
   d. run_invert's twisted-clover multigrid path on the heatbath gauge of
      4b (thermalized once for both): csw 1.769, kappa 0.1352, mu 0.0009,
      near_critical, inner_tol 1e-7, tol 1e-10;
5. times at 32^3x64: the kernel per launch for each epilogue and storage
   type the solves use and for the legs_out and dirs modes, beside the
   plain version, with GFLOP/s, effective GB/s and the bound (compulsory
   bytes at 3.35 TB/s).

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
#: the clover epilogues (K3): (name, epilogue, xpay_scale)
CLOVER_MODES = (("clover_inv", "clover_inv", None), ("clover_xpay", "clover_xpay", None),
                ("clover_xpay_full", "clover_xpay", KAPPA))
#: cell 4c: the action of tests/test_clover.py and BASELINE config 2's
#: solver; with kappa csw = 0.138, |A - 1| <= 0.83 on any gauge
CL_KAPPA, CL_MU, CL_CSW = 0.115, 0.06, 1.2
#: cell 4d: the non-perturbative csw at beta = 6.0 (ALPHA collaboration,
#: hep-lat/9609035) and a kappa near its critical value
MGC_KAPPA, MGC_MU, MGC_CSW = 0.1352, 0.0009, 1.769
FLOP_PER_SITE = 1320
CLOVER_FLOP_PER_SITE = 552   # two 6x6 complex mat-vecs
RELRES_MAX = 1e-10
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet, at the 700 W limit
#: peak rates outside the tensor cores (H100 SXM data sheet): bfloat16
#: storage computes in float32
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12, torch.bfloat16: 67e12}


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


def clover_blocks_of(u_pk, lat, kappa, csw) -> torch.Tensor:
    """The packed float32 A blocks of both parities, [2(par), 2(ri),
    2(chir), 6, 6, T, Z, S], from the gauge's float32 links."""
    from tpuqcd_torch.solve import clover_pk_from_gauge
    return clover_pk_from_gauge(u_pk, lat, kappa=kappa, csw=csw)


def compare_clover(dims, dev) -> dict:
    """The clover epilogues (K3) against the plain version, with A built
    from the random gauge at csw 1.2 (clover_xpay) and its twisted inverse
    (clover_inv) at the output parity; returns {(storage, epilogue): max
    abs err}."""
    from tpuqcd_torch.ops.clover import clover_twist_inverse
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo, dslash_eo_plain
    from tpuqcd_torch.utils.packed import pack_clover
    lat, gauges, psi64, psi064 = problem(dims, dev, seed=5)
    a_pk = clover_blocks_of(gauges["f64"], lat, CL_KAPPA, CL_CSW)
    a = torch.complex(a_pk[:, 0], a_pk[:, 1])
    blocks = {"clover_xpay": a_pk.double(),
              "clover_inv": torch.stack([pack_clover(clover_twist_inverse(
                  a, CL_KAPPA, CL_MU, 1, par), torch.float64) for par in (0, 1)])}
    del a
    max_abs = {}
    for name, dt, _, tol in STORAGE:
        u, psi, psi0 = gauges[name], psi64.to(dt), psi064.to(dt)
        for mode, epi, scale in CLOVER_MODES:
            rel = 0.0
            for parity in (0, 1):
                cl = blocks[epi][1 - parity].to(dt).contiguous()
                for dagger in (False, True):
                    kw = dict(dagger=dagger, epilogue=epi, kappa=CL_KAPPA, mu=CL_MU, clover=cl,
                              psi0=psi0 if epi == "clover_xpay" else None, xpay_scale=scale)
                    k = dslash_eo(u, psi, parity, lat, **kw).double()
                    p = dslash_eo_plain(u, psi, parity, lat, **kw).double()
                    torch.cuda.synchronize()
                    if not torch.isfinite(k).all():
                        fail(f"{dims} {name} {mode}: non-finite kernel output")
                    err = (k - p).abs().max().item()
                    max_abs[(name, epi)] = max(max_abs.get((name, epi), 0.0), err)
                    rel = max(rel, err / p.abs().max().item())
            ok = rel <= tol
            print(f"  {'x'.join(map(str, dims))} {name:4s} {mode:16s} "
                  f"max rel err {rel:.3e} (tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"clover epilogue disagrees with the plain version: {dims} {name} {mode}")
    return max_abs


def compare_fine_apply(dims, dev, clover: bool = False) -> dict:
    """The MG fine operator M v (mg/device.DeviceFineLevel.apply: xpay with
    the kappa scale, psi0 and out the parity views of an MG field
    [2(ri), 2(par), ...]; with ``clover`` DeviceFineCloverLevel.apply,
    clover_xpay with A at csw 1.769) at the MG cells' kappa and mu,
    flavor +1 and -1 (the CG-NE setup), in each storage type (the float32
    level, its bf16 smoother twin, its float64 certification twin),
    against the plain version on contiguous copies of the same parities;
    returns {storage: max abs err}."""
    from tpuqcd_torch.mg.device import DeviceFineCloverLevel, DeviceFineLevel
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo_plain
    lat, gauges, psi64, psi064 = problem(dims, dev, seed=4)
    field = torch.stack([psi64, psi064], dim=1)           # [2(ri), 2(par), 4, 3, T, Z, S]
    u32 = gauges["f64"].float()
    kappa, mu = (MGC_KAPPA, MGC_MU) if clover else (MG_KAPPA, MG_MU)
    a_pk = clover_blocks_of(u32, lat, kappa, MGC_CSW) if clover else None
    what = "fine clover apply" if clover else "fine apply"
    max_abs = {}
    for flavor in (+1, -1):
        if clover:
            f32 = DeviceFineCloverLevel(lat, u32, a_pk, kappa, mu, flavor=flavor)
        else:
            f32 = DeviceFineLevel(lat, u32, kappa, mu, flavor)
        for name, level in (("f64", f32.as_hp()), ("f32", f32), ("bf16", f32.sloppy())):
            u = level.u_pk if level.u12 is None else level.u12
            tol = next(s[3] for s in STORAGE if s[0] == name)
            v = field.to(u.dtype)
            k = level.apply(v).double()
            p = torch.stack([dslash_eo_plain(
                u, v[:, 1 - par].contiguous(), 1 - par, lat,
                epilogue="clover_xpay" if clover else "xpay", kappa=kappa, mu=mu,
                flavor=flavor, t_boundary=level.t_boundary, psi0=v[:, par].contiguous(),
                xpay_scale=kappa, clover=level.clover_pk[par] if clover else None).double()
                for par in (0, 1)], dim=1)
            torch.cuda.synchronize()
            if not torch.isfinite(k).all():
                fail(f"{dims} {name} {what} flavor {flavor:+d}: non-finite output")
            err = (k - p).abs().max().item()
            max_abs[name] = max(max_abs.get(name, 0.0), err)
            rel = err / p.abs().max().item()
            ok = rel <= tol
            print(f"  {'x'.join(map(str, dims))} {name:4s} {what} flavor {flavor:+d} "
                  f"max rel err {rel:.3e} (tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"MG {what} disagrees with the plain version: {dims} {name} "
                     f"flavor {flavor:+d}")
    return max_abs


def plain_full_relres(u64, b, x, lat, kappa=KAPPA, mu=MU, a64=None) -> float:
    """|b - M x| / |b| of the two-parity system with the plain version;
    with the A blocks a64 [2(par), 2(ri), 2(chir), 6, 6, T, Z, S] the
    twisted-clover M, A applied directly beside the plain hop."""
    from tpuqcd_torch.operators import gamma5_apply_pk
    from tpuqcd_torch.ops.clover import clover_apply_pk
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo_plain
    if a64 is None:
        m = [dslash_eo_plain(u64, x[1 - par].contiguous(), 1 - par, lat, epilogue="xpay",
                             kappa=kappa, mu=mu, psi0=x[par].contiguous(), xpay_scale=kappa)
             for par in (0, 1)]
    else:
        tw = 2.0 * kappa * mu
        m = []
        for par in (0, 1):
            g = gamma5_apply_pk(x[par])
            site = clover_apply_pk(a64[par], x[par]) + tw * torch.stack([-g[1], g[0]])
            m.append(site - kappa * dslash_eo_plain(u64, x[1 - par].contiguous(), 1 - par, lat))
    r = b - torch.stack(m)
    return (r.square().sum() / b.square().sum()).sqrt().item()


def counted_invert(cfg, dev, gauge=None):
    """run_invert's invert with the launch counts set to 0 just before and
    read just after; returns (result, counts)."""
    from tpuqcd_torch.cli.run_invert import invert
    from tpuqcd_torch.ops import dslash_cuda
    torch.cuda.synchronize()
    dslash_cuda.reset_counts()
    res = invert(cfg, dev, gauge)
    torch.cuda.synchronize()
    counts = dict(dslash_cuda.counts)
    print(f"  launches during the run: {counts}")
    if counts.get("plain", 0) != 0:
        fail(f"the main path called the plain version {counts['plain']} times")
    if not (res.relres <= RELRES_MAX and res.solver_relres <= RELRES_MAX
            and torch.isfinite(res.x).all()):
        fail(f"certified relres {res.relres:.3e} / {res.solver_relres:.3e} > "
             f"{RELRES_MAX:.0e} or non-finite x")
    if tuple(res.x.shape) != (2, 2, 4, 3, LARGE[3], LARGE[2], LARGE[1] * LARGE[0] // 2):
        fail(f"solution shape {tuple(res.x.shape)}")
    return res, counts


def need_launches(counts, keys) -> None:
    for key in keys:
        if counts.get(key, 0) <= 0:
            fail(f"the main path did not launch the {key} kernel: {counts}")


def check_plain(res, lat, kappa, mu, csw=0.0) -> float:
    """The independent float64 residual of a main path's solution."""
    a64 = clover_blocks_of(res.u_pk, lat, kappa, csw).double() if csw else None
    rel = plain_full_relres(res.u_pk.double(), res.b_pk.double(), res.x, lat, kappa, mu, a64)
    print(f"  certified relres {res.relres:.3e} (solver's own {res.solver_relres:.3e}), "
          f"plain-operator relres {rel:.3e}, iterations {res.iters}, "
          f"refinements {res.refinements}, solve wallclock {res.seconds:.3f} s")
    if not rel <= RELRES_MAX:
        fail(f"plain-operator relres {rel:.3e} > {RELRES_MAX:.0e}")
    return rel


def main_path(dev):
    """run_invert's direct path: CG on the twisted-mass system."""
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.utils.config import config_from_dict
    cfg = config_from_dict({
        "gauge": {"dims": list(LARGE), "random_seed": 1},
        "action": {"kappa": KAPPA, "mu": MU},
        "solver": {"solver": "cg", "tol": RELRES_MAX}})
    res, counts = counted_invert(cfg, dev)
    need_launches(counts, ("float32", "float64"))
    check_plain(res, Lattice(LARGE), KAPPA, MU)
    return res, counts


def clover_path(dev):
    """run_invert's direct twisted-clover path, BASELINE config 2's action
    and solver at 32^3x64."""
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.utils.config import config_from_dict
    cfg = config_from_dict({
        "gauge": {"dims": list(LARGE), "random_seed": 1},
        "action": {"kappa": CL_KAPPA, "mu": CL_MU, "csw": CL_CSW},
        "solver": {"solver": "bicgstab", "sloppy_dtype": "bfloat16", "inner_tol": 1e-4,
                   "tol": RELRES_MAX}})
    res, counts = counted_invert(cfg, dev)
    print(f"  clover term and twisted inverses {res.setup_seconds['clover']:.3f} s")
    need_launches(counts, ("bfloat16:clover_inv", "bfloat16:clover_xpay",
                           "float64:clover_inv", "float64:clover_xpay"))
    check_plain(res, Lattice(LARGE), CL_KAPPA, CL_MU, CL_CSW)
    return res, counts


def mg_config(kappa, mu, csw=0.0):
    from tpuqcd_torch.utils.config import config_from_dict
    return config_from_dict({
        "gauge": {"dims": list(LARGE), "heatbath_beta": MG_BETA,
                  "heatbath_sweeps": MG_SWEEPS, "random_seed": 0},
        "action": {"kappa": kappa, "mu": mu, "csw": csw},
        "solver": {"tol": RELRES_MAX, "inner_tol": 1e-7},
        "mg": {"enabled": True, "preset": "near_critical"}})


def mg_path(dev, gauge, clover: bool = False):
    """run_invert's multigrid path on the 32^3x64 heatbath gauge: twisted
    mass (4b) or, with ``clover``, twisted clover (4d)."""
    from tpuqcd_torch.lattice import Lattice
    kappa, mu, csw = (MGC_KAPPA, MGC_MU, MGC_CSW) if clover else (MG_KAPPA, MG_MU, 0.0)
    res, counts = counted_invert(mg_config(kappa, mu, csw), dev, gauge)
    st = res.setup_seconds
    rest = st["mg_setup"] - st["nulls0"] - st["galerkin0"]
    print(f"  MG setup {st['mg_setup']:.2f} s: null vectors {st['nulls0']:.2f} s, "
          f"Galerkin probing {st['galerkin0']:.2f} s, the rest (fine level"
          f"{', clover term' if clover else ''}, transfers) {rest:.2f} s")
    if clover:
        need_launches(counts, ("float32:clover_xpay", "bfloat16:clover_xpay",
                               "float64:clover_xpay", "float32:legs_out"))
    else:
        need_launches(counts, ("float32", "bfloat16", "float64", "float32:legs_out"))
    check_plain(res, Lattice(LARGE), kappa, mu, csw)
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


def bytes_per_site(dt, rows, xpay, clover=False) -> tuple[int, int]:
    """(naive, compulsory) device-memory bytes per output site.  Naive
    reads the 8 neighbour spinors and 8 links, stores one spinor and, for
    xpay, reads psi0; compulsory reads each spinor once, since a neighbour
    spinor read by 8 sites can come from the caches (links, and the 144
    reals of a clover block, are each read once either way)."""
    item = torch.empty((), dtype=dt).element_size()
    spinor, link = 24 * item, rows * 6 * item
    tail = 8 * link + spinor + (spinor if xpay else 0) + (144 * item if clover else 0)
    return 8 * spinor + tail, spinor + tail


def bound(byts: float, flops: float, dt) -> tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it: the
    compulsory bytes at 3.35 TB/s or the flops at the peak for dt."""
    tb, tf = byts / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dt]
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


def timings(dev, card_tag) -> dict:
    """{(storage, mode): (kernel ms, plain ms, bound ms, bound by)}."""
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo, dslash_eo_plain
    lat, gauges, psi64, psi064 = problem(LARGE, dev, seed=2)
    a_pk = clover_blocks_of(gauges["f64"], lat, CL_KAPPA, CL_CSW)[1]   # at the output parity
    sites = lat.half_volume
    dims = "x".join(map(str, LARGE))
    out = {}
    for name, dt, rows, _ in STORAGE:
        u, psi, psi0 = gauges[name], psi64.to(dt), psi064.to(dt)
        cl = a_pk.to(dt).contiguous()
        modes = MODES if name == "f32" else MODES[3:]
        for mode, epi, scale in modes + CLOVER_MODES[:2]:
            xpay, clover = epi.endswith("xpay"), epi.startswith("clover")
            kw = dict(epilogue=epi, kappa=KAPPA, mu=MU, xpay_scale=scale,
                      psi0=psi0 if xpay else None, clover=cl if clover else None)
            k_ms = time_ms(lambda: dslash_eo(u, psi, 0, lat, **kw), reps=50)
            p_ms = time_ms(lambda: dslash_eo_plain(u, psi, 0, lat, **kw), reps=3, warmup=1)
            flops = (FLOP_PER_SITE + (CLOVER_FLOP_PER_SITE if clover else 0)) * sites
            naive, comp = (b * sites for b in bytes_per_site(dt, rows, xpay, clover))
            b_ms, b_by = bound(comp, flops, dt)
            print(f"  {dims} {name} recon-{rows * 6} {mode:11s} kernel {k_ms:.4f} ms "
                  f"({flops / (k_ms * 1e-3) / 1e9:.1f} GFLOP/s; effective "
                  f"{naive / (k_ms * 1e-3) / 1e9:.1f} GB/s naive, "
                  f"{comp / (k_ms * 1e-3) / 1e9:.1f} GB/s compulsory = "
                  f"{comp / (k_ms * 1e-3) / HBM_BYTES_PER_S:.1%} of 3.35 TB/s; bound "
                  f"{b_ms:.4f} ms by {b_by}) | plain {p_ms:.3f} ms | {card_tag}")
            out[(name, mode)] = (k_ms, p_ms, b_ms, b_by)
    # legs_out (f32, reconstruct-12, the probing operand): one spinor and 8
    # links read, 8 spinors written per output site, 8 legs without the sum
    u, psi = gauges["f32"], psi64.float()
    k_ms = time_ms(lambda: dslash_eo(u, psi, 0, lat, legs_out=True), reps=50)
    p_ms = time_ms(lambda: dslash_eo_plain(u, psi, 0, lat, legs_out=True), reps=3, warmup=1)
    byts = (96 + 8 * 48 + 8 * 96) * sites
    b_ms, b_by = bound(byts, (FLOP_PER_SITE - 7 * 24) * sites, torch.float32)
    print(f"  {dims} f32 recon-12 legs_out kernel {k_ms:.4f} ms "
          f"({byts / 1e9:.2f} GB compulsory, {byts / (k_ms * 1e-3) / 1e9:.1f} GB/s = "
          f"{byts / (k_ms * 1e-3) / HBM_BYTES_PER_S:.1%} of 3.35 TB/s; bound "
          f"{b_ms:.4f} ms by {b_by}) | plain {p_ms:.3f} ms | {card_tag}")
    out[("f32", "legs_out")] = (k_ms, p_ms, b_ms, b_by)
    # one dirs leg (the per-leg probing path): one spinor, one link, one store
    k_ms = time_ms(lambda: dslash_eo(u, psi, 0, lat, dirs=((3, +1),)), reps=50)
    p_ms = time_ms(lambda: dslash_eo_plain(u, psi, 0, lat, dirs=((3, +1),)), reps=3, warmup=1)
    b_ms, b_by = bound((96 + 48 + 96) * sites, FLOP_PER_SITE // 8 * sites, torch.float32)
    print(f"  {dims} f32 recon-12 dirs (t, +1) kernel {k_ms:.4f} ms (bound {b_ms:.4f} ms by "
          f"{b_by}) | plain {p_ms:.3f} ms | {card_tag}")
    out[("f32", "dirs")] = (k_ms, p_ms, b_ms, b_by)
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
    t_start = time.perf_counter()

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
    print("phase 3: clover epilogues (K3) against plain version", flush=True)
    compare_clover(SMALL, dev)
    clover_abs = compare_clover(LARGE, dev)
    print("phase 3: MG fine applies against plain version", flush=True)
    compare_fine_apply(SMALL, dev)
    fine_abs = compare_fine_apply(LARGE, dev)
    compare_fine_apply(SMALL, dev, clover=True)
    fine_cl_abs = compare_fine_apply(LARGE, dev, clover=True)

    print("phase 4a: main path, tpuqcd_torch.cli.run_invert (CG) at 32^3x64", flush=True)
    res, counts = main_path(dev)
    print("phase 4b: main path, tpuqcd_torch.cli.run_invert (MG) at 32^3x64", flush=True)
    from tpuqcd_torch.cli.common import setup_gauge
    gauge = setup_gauge(mg_config(MG_KAPPA, MG_MU), dev)
    print(f"  heatbath beta {MG_BETA}, {MG_SWEEPS} compound sweeps: plaquette "
          f"{gauge.plaquette:.6f} (|p - {PLAQ_BETA6}| = {abs(gauge.plaquette - PLAQ_BETA6):.2e}, "
          f"limit {PLAQ_TOL}), {gauge.seconds:.1f} s; the same gauge serves 4b and 4d",
          flush=True)
    if abs(gauge.plaquette - PLAQ_BETA6) > PLAQ_TOL:
        fail(f"plaquette {gauge.plaquette:.6f} is not within {PLAQ_TOL} of {PLAQ_BETA6}")
    mg_res, mg_counts = mg_path(dev, gauge)
    print("phase 4c: main path, run_invert (twisted clover, BiCGStab bf16) at 32^3x64",
          flush=True)
    cl_res, cl_counts = clover_path(dev)
    print("phase 4d: main path, run_invert (twisted clover, MG) at 32^3x64", flush=True)
    mgc_res, mgc_counts = mg_path(dev, gauge, clover=True)

    print(f"phase 5: times {card_tag}", flush=True)
    t = timings(dev, card_tag)
    print(f"  CG solve: {res.seconds:.3f} s wallclock, {res.iters} sloppy matvecs, "
          f"{res.gflops:.1f} GFLOP/s (solve_flops accounting) {card_tag}")
    for what, r in (("MG solve", mg_res), ("clover MG solve", mgc_res)):
        print(f"  {what}: {r.seconds:.3f} s wallclock, {r.iters} inner iterations, "
              f"{r.refinements} refinements; setup {r.setup_seconds['mg_setup']:.2f} s "
              f"{card_tag}")
    print(f"  clover BiCGStab solve: {cl_res.seconds:.3f} s wallclock, {cl_res.iters} sloppy "
          f"matvecs, {cl_res.refinements} refinements; clover set-up "
          f"{cl_res.setup_seconds['clover']:.3f} s {card_tag}")
    print(f"  smoke run {time.perf_counter() - t_start:.1f} s so far", flush=True)

    from tpuqcd_torch.ops.dslash_cuda import SOURCE
    src = "tpuqcd_torch/csrc/" + SOURCE.name

    def entry(name, launches, err, timed, replaces="tpuqcd/ops/dslash_pallas.py:514"):
        k_ms, p_ms, b_ms, b_by = t[timed]
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    k3 = "tpuqcd/ops/dslash_pallas.py:461"
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
        entry("dslash_eo<bf16> reconstruct-12 clover_inv (K3, clover BiCGStab sloppy operator)",
              cl_counts["bfloat16:clover_inv"], clover_abs[("bf16", "clover_inv")],
              ("bf16", "clover_inv"), k3),
        entry("dslash_eo<bf16> reconstruct-12 clover_xpay (K3, clover BiCGStab sloppy operator)",
              cl_counts["bfloat16:clover_xpay"], clover_abs[("bf16", "clover_xpay")],
              ("bf16", "clover_xpay"), k3),
        entry("dslash_eo<double> 18-real clover_inv (K3, clover certification operator)",
              cl_counts["float64:clover_inv"], clover_abs[("f64", "clover_inv")],
              ("f64", "clover_inv"), k3),
        entry("dslash_eo<double> 18-real clover_xpay (K3, clover certification operator)",
              cl_counts["float64:clover_xpay"], clover_abs[("f64", "clover_xpay")],
              ("f64", "clover_xpay"), k3),
        entry("dslash_eo<float> reconstruct-12 clover_xpay (K3, MG fine clover operator)",
              mgc_counts["float32:clover_xpay"], fine_cl_abs["f32"], ("f32", "clover_xpay"), k3),
        entry("dslash_eo<bf16> reconstruct-12 clover_xpay (K3, MG clover smoother)",
              mgc_counts["bfloat16:clover_xpay"], fine_cl_abs["bf16"], ("bf16", "clover_xpay"),
              k3),
        entry("dslash_eo<double> 18-real clover_xpay (K3, MG clover certification operator)",
              mgc_counts["float64:clover_xpay"], fine_cl_abs["f64"], ("f64", "clover_xpay"), k3),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
