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
   the same parities, daggers and storage types; the MG fine
   operators (DeviceFineLevel.apply and DeviceFineCloverLevel.apply: xpay
   or clover_xpay into the parity views of an MG field, flavor +1 and -1)
   in each storage type; and halo mode (K6) on an emulated (nt, nz) =
   (2, 2) decomposition, each shard's faces cut from the global fields
   with its own t_offset (epilogues none, twist_inv, xpay; both parities;
   dagger off and on; half-spinor and full faces; float64 and float32
   18-real, float32 and bfloat16 reconstruct-12 links), against the plain
   version and, stitched, against the unsharded kernel;
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
   4b also builds 4b's coarse operator once more by per-leg probing
   (dirs launches) and holds its links against the fused probing's;
   e. run_invert's non-degenerate doublet path at 32^3x64 (random gauge
      seed 1, kappa 0.115, mubar 0.135, epsbar 0.170: ETMC's heavy
      doublet at beta = 1.95, arXiv:1010.3659; CG, tol 1e-10);
   f. the same doublet solve through solve_ndeg_tm_sharded on a one-rank
      LatticeMesh, whose faces are its own boundary slices (halo mode at
      full width), its x held against 4e's;
   g. with more than one card only: torchrun of run_invert's doublet path
      on a mesh nt = 2 or 4 over NCCL, its x held against 4e's (with one
      card it says so and is no pass);
5. times at 32^3x64: the kernel per launch for each epilogue and storage
   type the solves use and for the legs_out and dirs modes, and halo mode
   on the one-rank mesh and at the (2, 2) shard size beside the plain hop
   on the same volume, beside the plain version, with GFLOP/s, effective
   GB/s and the bound (compulsory bytes at 3.35 TB/s).

The line before the last is the JSON summary of the kernels; the last
line is {"ok": true, "device": {...}}.  Without CUDA, or without the
tpuqcd_torch package beside this file, it exits with code 1 and prints
no result.  ``--invert-rank`` runs one rank of phase 4g (invert_rank).
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
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
#: cell 4e-4g: the heavy doublet (ETMC, beta = 1.95, arXiv:1010.3659)
ND_KAPPA, ND_MUBAR, ND_EPSBAR = 0.115, 0.135, 0.170
#: halo mode's storage types: STORAGE and float32 with 18-real links
HALO_STORAGE = STORAGE[:1] + (("f32_18", torch.float32, 3, 1e-5),) + STORAGE[1:]
#: max |x(4f) - x(4e)| / max |x(4e)|: the same system, certified to 1e-10
#: by two solves whose sloppy operators differ only in summation order
X_AGREE = 1e-8
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


def compare_legs(dims, dev) -> tuple[dict, dict]:
    """The leg modes (K4) against the plain version; returns {storage:
    max abs err} over the legs_out cases and over the single dirs legs."""
    from tpuqcd_torch.ops.dslash_cuda import LEG_ORDER, dslash_eo, dslash_eo_plain
    lat, gauges, psi64, _ = problem(dims, dev, seed=3)
    subset = ((3, -1), (0, +1), (2, +1))           # out of the kernel's order
    cases = [("legs_out", dict(legs_out=True)),
             ("legs_out_subset", dict(legs_out=True, dirs=subset))]
    cases += [(f"dirs{m}{'+' if s > 0 else '-'}", dict(dirs=((m, s),))) for m, s in LEG_ORDER]
    max_abs, dirs_abs = {}, {}
    for name, dt, _, tol in STORAGE:
        u = gauges[name]
        # psi as the odd-parity view of an MG field [2(ri), 2(par), ...]
        field = torch.stack([psi64, psi64.flip(0)], dim=1).to(dt)
        psi = field[:, 1]
        max_abs[name] = dirs_abs[name] = 0.0
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
                    else:
                        dirs_abs[name] = max(dirs_abs[name], err)
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
    return max_abs, dirs_abs


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


def compare_halo(dims, dev) -> dict:
    """Halo mode (K6) on a one-rank mesh (grid (1, 1): the whole lattice,
    its faces its own boundary slices, the shape 4f launches) and on an
    emulated (2, 2) decomposition (each shard's local fields and faces cut
    from the global ones by parallel/sharded.cut_halo, its own t_offset):
    kernel against the plain version on the same operands, and the
    stitched shards against the unsharded kernel; returns {storage: max
    abs err against the plain version over both grids}."""
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo, dslash_eo_plain
    from tpuqcd_torch.parallel.mesh import LatticeMesh
    from tpuqcd_torch.parallel.sharded import cut_halo
    lat, gauges, psi64, psi064 = problem(dims, dev, seed=6)
    grids = {(1, 1): [LatticeMesh(lat, 1, 1, 1, 0)],
             (2, 2): [LatticeMesh(lat, 2, 2, 1, r) for r in range(4)]}
    max_abs = {}
    for name, dt, rows, tol in HALO_STORAGE:
        u = (gauges["f64"] if rows == 3 else gauges["f32"]).to(dt).contiguous()
        psi, psi0 = psi64.to(dt), psi064.to(dt)
        max_abs[name] = 0.0
        for mode, epi, _ in MODES[:3]:
            rel, stitched = dict.fromkeys(grids, 0.0), dict.fromkeys(grids, 0.0)
            for parity in (0, 1):
                for dagger in (False, True):
                    kw = dict(dagger=dagger, epilogue=epi, kappa=KAPPA, mu=MU)
                    whole = dslash_eo(u, psi, parity, lat, psi0=psi0 if epi == "xpay" else None,
                                      **kw).double()
                    for half in (True, False):
                        for grid, shards in grids.items():
                            for m in shards:
                                ul, pl, halo = cut_halo(m, u, psi, parity, dagger, half)
                                p0 = m.shard(psi0).contiguous() if epi == "xpay" else None
                                k = dslash_eo(ul, pl, parity, m.local_lat, psi0=p0, halo=halo,
                                              **kw).double()
                                p = dslash_eo_plain(ul, pl, parity, m.local_lat, psi0=p0,
                                                    halo=halo, **kw).double()
                                torch.cuda.synchronize()
                                if not torch.isfinite(k).all():
                                    fail(f"{dims} {name} halo {mode} grid {grid}: non-finite "
                                         "kernel output")
                                err = (k - p).abs().max().item()
                                max_abs[name] = max(max_abs[name], err)
                                rel[grid] = max(rel[grid], err / p.abs().max().item())
                                ref = m.shard(whole)
                                stitched[grid] = max(stitched[grid], (k - ref).abs().max().item()
                                                     / ref.abs().max().item())
            for grid in grids:
                ok = rel[grid] <= tol and stitched[grid] <= tol
                print(f"  {'x'.join(map(str, dims))} {name:6s} halo {mode:9s} grid {grid} "
                      f"max rel err {rel[grid]:.3e} against plain, {stitched[grid]:.3e} "
                      f"{'stitched ' if grid != (1, 1) else ''}against unsharded "
                      f"(tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"halo mode disagrees: {dims} {name} {mode} grid {grid}")
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


def counted_invert(cfg, dev, gauge=None, flavors=False):
    """run_invert's invert with the launch counts set to 0 just before and
    read just after; returns (result, counts).  ``flavors``: x is a
    doublet [2(fl), 2(par), ...]."""
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
    want = (2,) * (3 if flavors else 2) + (4, 3, LARGE[3], LARGE[2], LARGE[1] * LARGE[0] // 2)
    if tuple(res.x.shape) != want:
        fail(f"solution shape {tuple(res.x.shape)}, not {want}")
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


def plain_ndeg_relres(u64, b, x, lat) -> float:
    """|b - M_nd x| / |b| of the two-parity doublet system with the plain
    hop and the site term A = 1 + i t g5 tau3 + e tau1 written out."""
    from tpuqcd_torch.operators import gamma5_apply_pk
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo_plain
    tw, e = 2.0 * ND_KAPPA * ND_MUBAR, 2.0 * ND_KAPPA * ND_EPSBAR
    r = []
    for par in (0, 1):
        for f, sign in ((0, 1.0), (1, -1.0)):
            g = gamma5_apply_pk(x[f, par])
            site = x[f, par] + sign * tw * torch.stack([-g[1], g[0]]) + e * x[1 - f, par]
            hop = dslash_eo_plain(u64, x[f, 1 - par].contiguous(), 1 - par, lat)
            r.append(b[f, par] - (site - ND_KAPPA * hop))
    r = torch.stack(r)
    return (r.square().sum() / b.square().sum()).sqrt().item()


def ndeg_dict(mesh_nt: int = 1) -> dict:
    """The run config of cells 4e-4g, as a dict."""
    return {"gauge": {"dims": list(LARGE), "random_seed": 1},
            "action": {"kappa": ND_KAPPA, "mubar": ND_MUBAR, "epsbar": ND_EPSBAR},
            "solver": {"solver": "cg", "tol": RELRES_MAX}, "mesh": {"nt": mesh_nt}}


def ndeg_config(mesh_nt: int = 1):
    from tpuqcd_torch.utils.config import config_from_dict
    return config_from_dict(ndeg_dict(mesh_nt))


def ndeg_path(dev):
    """run_invert's non-degenerate doublet path on one card (4e)."""
    from tpuqcd_torch.lattice import Lattice
    res, counts = counted_invert(ndeg_config(), dev, flavors=True)
    need_launches(counts, ("float32", "float64"))
    rel = plain_ndeg_relres(res.u_pk.double(), res.b_pk.double(), res.x, Lattice(LARGE))
    print(f"  certified doublet relres {res.relres:.3e} (solver's own {res.solver_relres:.3e}), "
          f"plain-operator relres {rel:.3e}, iterations {res.iters}, refinements "
          f"{res.refinements}, solve wallclock {res.seconds:.3f} s")
    if not rel <= RELRES_MAX:
        fail(f"plain-operator doublet relres {rel:.3e} > {RELRES_MAX:.0e}")
    return res, counts


def sharded_path(dev, nd_res):
    """4e's doublet solve through solve_ndeg_tm_sharded on a one-rank
    LatticeMesh (4f): every hop in halo mode, its faces the shard's own
    boundary slices.  Returns (seconds, counts)."""
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.ops import dslash_cuda
    from tpuqcd_torch.parallel.mesh import LatticeMesh
    from tpuqcd_torch.parallel.sharded import ShardedNdegTMOperatorPC
    from tpuqcd_torch.solve import solve_ndeg_tm_sharded
    lat = Lattice(LARGE)
    lmesh = LatticeMesh.make(lat, 1)
    op = ShardedNdegTMOperatorPC(lat, kappa=ND_KAPPA, mubar=ND_MUBAR, epsbar=ND_EPSBAR,
                                 lmesh=lmesh)
    ug = op.extend_gauge(nd_res.u_pk)
    fields_s, fields_hp = ug.to(torch.float32, rows=2), ug.to(torch.float64)
    torch.cuda.synchronize()
    dslash_cuda.reset_counts()
    t0 = time.perf_counter()
    res = solve_ndeg_tm_sharded(op, fields_s, fields_hp, nd_res.b_pk, tol=RELRES_MAX)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(dslash_cuda.counts)
    print(f"  launches during the run: {counts}")
    if counts.get("plain", 0) != 0:
        fail(f"the sharded path called the plain version {counts['plain']} times")
    need_launches(counts, ("float32:halo", "float64:halo"))
    rel = plain_ndeg_relres(nd_res.u_pk.double(), nd_res.b_pk.double(), res.x, lat)
    agree = ((res.x - nd_res.x).abs().max() / nd_res.x.abs().max()).item()
    print(f"  certified relres {res.relres:.3e} (4e: {nd_res.solver_relres:.3e}), "
          f"plain-operator relres {rel:.3e} (4e: see above), iterations {res.iters} (4e: "
          f"{nd_res.iters}), max|x - x(4e)| / max|x(4e)| = {agree:.3e} (limit {X_AGREE:.0e}), "
          f"solve wallclock {seconds:.3f} s")
    if not (res.relres <= RELRES_MAX and rel <= RELRES_MAX and agree <= X_AGREE):
        fail("the sharded doublet solve is not certified or does not agree with 4e")
    return seconds, counts


def free_port() -> int:
    """A free TCP port on localhost for torchrun's rendezvous."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def invert_rank(argv) -> None:
    """One rank of phase 4g under torchrun: run_invert's entry (parse_args,
    which joins the process group, then invert); rank 0 saves the gathered
    x to the path after --save-x.

        torchrun --nproc_per_node 2 chip_smoke.py --invert-rank \\
            --config cfg.yaml --save-x x.pt [--device cpu]
    """
    from tpuqcd_torch.cli import run_invert
    from tpuqcd_torch.cli.common import parse_args
    i = argv.index("--save-x")
    cfg, device = parse_args(run_invert.__doc__, argv[:i] + argv[i + 2:])
    res = run_invert.invert(cfg, device)
    if res.x is not None:
        torch.save(res.x.cpu(), argv[i + 1])


def multi_card_path(nd_res) -> None:
    """4g: run_invert's doublet path under torchrun on a mesh nt = n over
    NCCL, n the largest of 2 or 4 that the visible cards hold; its x held
    against 4e's."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"  phase 4g not run: torch.cuda.device_count() = {n_cards}; the multi-rank "
              "NCCL exchange needs one process per card (it is held on the CPU over gloo by "
              "tests/test_torch_sharded.py)")
        return
    import yaml
    n = 4 if n_cards >= 4 else 2
    with tempfile.TemporaryDirectory() as tmp:
        cfg, x_path = os.path.join(tmp, "ndeg_mesh.yaml"), os.path.join(tmp, "x.pt")
        with open(cfg, "w") as f:
            yaml.safe_dump(ndeg_dict(n), f)      # writes 1e-10 as 1.0e-10, a YAML float
        r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
                            str(n), "--master_addr", "localhost", "--master_port",
                            str(free_port()), os.path.abspath(__file__), "--invert-rank",
                            "--config", cfg, "--save-x", x_path],
                           capture_output=True, text=True, timeout=600)
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
        if r.returncode != 0 or len(line) != 1 or not os.path.exists(x_path):
            fail(f"torchrun of {n} ranks: rc {r.returncode}\n{r.stdout[-2000:]}\n"
                 f"{r.stderr[-2000:]}")
        x = torch.load(x_path)
    iters = re.findall(r"ndeg solve: .* iters=(\d+)", r.stdout + r.stderr)
    rel = float(re.search(r"relres=(\S+)", line[0]).group(1))
    x4e = nd_res.x.cpu()
    agree = ((x - x4e).abs().max() / x4e.abs().max()).item()
    print(f"  {n} ranks over NCCL: {line[0]}; iterations {iters[0] if iters else '?'} (4e: "
          f"{nd_res.iters}); max|x - x(4e)| / max|x(4e)| = {agree:.3e} (limit {X_AGREE:.0e})")
    if not (rel <= RELRES_MAX and agree <= X_AGREE):
        fail(f"the {n}-rank doublet solve: relres {rel:.3e}, x against 4e's {agree:.3e}")


def per_leg_probing(mg_res):
    """4b's coarse operator built once more by per-leg probing (one dirs
    launch per leg and parity, the memory-lean switch of
    mg/device.build_coarse_device), held against the fused probing;
    returns the launch counts of the per-leg build."""
    from tpuqcd_torch.mg.device import build_coarse_device
    from tpuqcd_torch.ops import dslash_cuda
    level, tr = mg_res.mg.levels[0], mg_res.mg.transfers[0]
    torch.cuda.synchronize()
    dslash_cuda.reset_counts()
    t0 = time.perf_counter()
    per_leg = build_coarse_device(level, tr, fused_legs=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(dslash_cuda.counts)
    print(f"  per-leg probing {seconds:.2f} s, launches: {counts}")
    if counts.get("plain", 0) != 0:
        fail("per-leg probing called the plain version")
    need_launches(counts, ("float32:dirs",))
    fused = build_coarse_device(level, tr, fused_legs=True).links_c
    rel = ((per_leg.links_c - fused).abs().max() / fused.abs().max()).item()
    print(f"  per-leg against fused Galerkin links: max rel err {rel:.3e} (tol 1e-5)")
    if not rel <= 1e-5:
        fail(f"per-leg probing disagrees with the fused probing: {rel:.3e}")
    return counts


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
        modes = {"f32": MODES, "f64": MODES[:1] + MODES[3:]}.get(name, MODES[3:])
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
    out.update(halo_timings(dev, card_tag))
    return out


def halo_timings(dev, card_tag) -> dict:
    """Halo mode, epilogue none, half-spinor faces, per launch: on the
    one-rank mesh at 32^3x64 (4f's shape; faces the own boundary slices)
    and at the (2, 2) shard size (32^2 x 16 x 32), beside the plain hop on
    the same local volume.  The bound reads the spinor, the links and the
    faces (12 reals a face site, the face links) once and writes the
    output once.  Returns {(storage, "halo_none" | "halo_none_2x2" |
    "none_2x2"): (kernel ms, plain ms, bound ms, bound by)}."""
    from tpuqcd_torch.ops.dslash_cuda import dslash_eo, dslash_eo_plain
    from tpuqcd_torch.parallel.mesh import LatticeMesh
    from tpuqcd_torch.parallel.sharded import cut_halo
    lat, gauges, psi64, _ = problem(LARGE, dev, seed=7)
    out = {}
    for name, dt, rows, _ in HALO_STORAGE[:3]:
        u = (gauges["f64"] if rows == 3 else gauges["f32"]).to(dt).contiguous()
        psi = psi64.to(dt)
        item = psi.element_size()
        for grid, tag in (((1, 1), "halo_none"), ((2, 2), "halo_none_2x2")):
            m = LatticeMesh(lat, *grid, 1, 0)
            ul, pl, halo = cut_halo(m, u, psi, 0)
            llat = m.local_lat
            T, Z, S = llat.site_shape
            sites = llat.half_volume
            k_ms = time_ms(lambda: dslash_eo(ul, pl, 0, llat, halo=halo), reps=50)
            p_ms = time_ms(lambda: dslash_eo_plain(ul, pl, 0, llat, halo=halo), reps=3, warmup=1)
            faces = sum(x.numel() for x in halo[:6]) * item
            byts = (24 + 8 * rows * 6 + 24) * item * sites + faces
            b_ms, b_by = bound(byts, FLOP_PER_SITE * sites, dt)
            out[(name, tag)] = (k_ms, p_ms, b_ms, b_by)
            line = (f"  {'x'.join(map(str, llat.dims))} {name} recon-{rows * 6} halo none "
                    f"(grid {grid}) kernel {k_ms:.4f} ms ({byts / (k_ms * 1e-3) / 1e9:.1f} GB/s "
                    f"compulsory with {faces / 1e6:.2f} MB of faces = "
                    f"{byts / (k_ms * 1e-3) / HBM_BYTES_PER_S:.1%} of 3.35 TB/s; bound "
                    f"{b_ms:.4f} ms by {b_by}) | plain {p_ms:.3f} ms")
            if grid != (1, 1):
                # K1 none on the same local volume, periodic in the shard
                n_ms = time_ms(lambda: dslash_eo(ul, pl, 0, llat), reps=50)
                out[(name, "none_2x2")] = (n_ms, None, None, None)
                line += f" | K1 none on the shard {n_ms:.4f} ms"
            print(line + f" | {card_tag}")
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
    legs_abs, dirs_abs = compare_legs(LARGE, dev)
    print("phase 3: clover epilogues (K3) against plain version", flush=True)
    compare_clover(SMALL, dev)
    clover_abs = compare_clover(LARGE, dev)
    print("phase 3: MG fine applies against plain version", flush=True)
    compare_fine_apply(SMALL, dev)
    fine_abs = compare_fine_apply(LARGE, dev)
    compare_fine_apply(SMALL, dev, clover=True)
    fine_cl_abs = compare_fine_apply(LARGE, dev, clover=True)
    print("phase 3: halo mode (K6) on a one-rank mesh and an emulated (2, 2) decomposition",
          flush=True)
    compare_halo(SMALL, dev)
    halo_abs = compare_halo(LARGE, dev)

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
    print("phase 4b: the same coarse operator by per-leg probing", flush=True)
    pl_counts = per_leg_probing(mg_res)
    print("phase 4c: main path, run_invert (twisted clover, BiCGStab bf16) at 32^3x64",
          flush=True)
    cl_res, cl_counts = clover_path(dev)
    print("phase 4d: main path, run_invert (twisted clover, MG) at 32^3x64", flush=True)
    mgc_res, mgc_counts = mg_path(dev, gauge, clover=True)
    print("phase 4e: main path, run_invert (non-degenerate doublet, CG) at 32^3x64",
          flush=True)
    nd_res, nd_counts = ndeg_path(dev)
    print("phase 4f: the doublet solve on a one-rank LatticeMesh (halo mode) at 32^3x64",
          flush=True)
    sh_seconds, sh_counts = sharded_path(dev, nd_res)
    print("phase 4g: run_invert's doublet path on a mesh of cards (torchrun, NCCL)", flush=True)
    multi_card_path(nd_res)

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
    print(f"  doublet CG solve: {nd_res.seconds:.3f} s wallclock, {nd_res.iters} sloppy "
          f"matvecs, {nd_res.refinements} refinements; on the one-rank mesh {sh_seconds:.3f} s "
          f"{card_tag}")
    print(f"  smoke run {time.perf_counter() - t_start:.1f} s so far", flush=True)

    from tpuqcd_torch.ops.dslash_cuda import SOURCE
    src = "tpuqcd_torch/csrc/" + SOURCE.name

    def entry(name, launches, err, timed, replaces="tpuqcd/ops/dslash_pallas.py:514"):
        k_ms, p_ms, b_ms, b_by = t[timed]
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    k3 = "tpuqcd/ops/dslash_pallas.py:461"
    k6 = "tpuqcd/ops/dslash_pallas.py:583"
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
        entry("dslash_eo<float> reconstruct-12 dirs (K4, per-leg Galerkin probing), one leg timed",
              pl_counts["float32:dirs"], dirs_abs["f32"], ("f32", "dirs"),
              "tpuqcd/ops/dslash_pallas.py:428"),
        entry("dslash_eo<float> reconstruct-12 none (ndeg sloppy operator, per-flavor hop)",
              nd_counts["float32"], max_abs["f32"], ("f32", "none")),
        entry("dslash_eo<double> 18-real none (ndeg certification operator)",
              nd_counts["float64"], max_abs["f64"], ("f64", "none")),
        entry("dslash_eo<float> reconstruct-12 halo (K6, sharded ndeg sloppy operator), none "
              "timed on the one-rank mesh", sh_counts["float32:halo"], halo_abs["f32"],
              ("f32", "halo_none"), k6),
        entry("dslash_eo<double> 18-real halo (K6, sharded ndeg certification operator), none "
              "timed on the one-rank mesh", sh_counts["float64:halo"], halo_abs["f64"],
              ("f64", "halo_none"), k6),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--invert-rank"]:
        invert_rank(sys.argv[2:])
    else:
        main()
