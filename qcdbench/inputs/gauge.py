"""The benchmark's gauge ensemble: one heatbath configuration, made once per
checkout by the frozen chain (inputs/heatbath.py) on the run's device and
written as a 64-bit ILDG file into ``qcdbench/cache/`` (ignored by git).

The configuration's "gauge" group is the recipe: dims (Lx, Ly, Lz, Lt),
beta, sweeps (compound sweeps from a cold start, n_or overrelaxation
sweeps each, reprojection every reunit_every) and seed (the
torch.Generator's seed on the device).  The file's name holds the whole
recipe, so two recipes never share a file, and a run that finds the file
does not make it again.
"""
from __future__ import annotations

import time
from pathlib import Path

import torch

from . import heatbath, lime

CACHE = Path(__file__).resolve().parents[1] / "cache"


def gauge_path(recipe: dict) -> Path:
    lx, ly, lz, lt = recipe["dims"]
    return CACHE / (f"hb_b{recipe['beta']:g}_n{recipe['sweeps']}_or{recipe['n_or']}"
                    f"_r{recipe['reunit_every']}_s{recipe['seed']}_{lx}x{ly}x{lz}x{lt}.lime")


def make_links(recipe: dict, device) -> torch.Tensor:
    """The chain's last configuration, complex64 device layout [4, 2, 3, 3, T, Z, S]."""
    gen = torch.Generator(device=device).manual_seed(int(recipe["seed"]))
    return heatbath.thermalize(gen, tuple(recipe["dims"]), float(recipe["beta"]),
                               int(recipe["sweeps"]), n_or=int(recipe["n_or"]),
                               reunit_every=int(recipe["reunit_every"]))


def ensure(recipe: dict, device) -> tuple[Path, dict]:
    """(the ILDG file of ``recipe``, what making it cost: {} when it was there)."""
    path = gauge_path(recipe)
    if path.exists():
        return path, {}
    CACHE.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    u = make_links(recipe, device)
    if u.is_cuda:
        torch.cuda.synchronize(u.device)
    t1 = time.perf_counter()
    lime.write_ildg_gauge(str(path), heatbath.gauge_device_to_full(u, tuple(recipe["dims"])),
                          tuple(recipe["dims"]), 64)
    return path, {"sweeps_s": t1 - t0, "write_s": time.perf_counter() - t1}
