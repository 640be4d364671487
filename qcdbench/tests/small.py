"""The cells' configurations cut to a 4^3x8 lattice for CPU rehearsals: the
same action, solver and physics, a short heatbath, and an MG hierarchy
that such a lattice holds (2^4 blocks, 4 null vectors)."""
from __future__ import annotations

import copy

import torch

from qcdbench import registry


def small_config(bench: dict, cell: str) -> dict:
    cfg = copy.deepcopy(registry.config(bench, registry.workload(bench, cell)["config"]))
    cfg["gauge"].update(dims=[4, 4, 4, 8], sweeps=5)
    if cfg["run"]["mg"].get("enabled"):
        cfg["run"]["mg"] = {"enabled": True, "preset": "near_critical", "n_vec": [4],
                            "block": [[2, 2, 2, 2]], "setup_iters": 20}
    return cfg


def rehearse(cell: str, seed: int = 2 ** 31 + 12345, traced: bool = False, control=False,
             bench: dict | None = None):
    from qcdbench.run import run_cell
    import time
    bench = bench or registry.load_benchmark()
    return run_cell(bench, cell, seed, 0.1, traced, torch.device("cpu"), control=control,
                    config=small_config(bench, cell), t_process=time.perf_counter())
