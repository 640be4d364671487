"""The multi-device communication policy, timed on the cards and cached.

Counterpart of ``tpuqcd/utils/tune.py:109-165`` (``tune_comm_policy``
only; the TPU's block_z sweep has no counterpart, ROADMAP item 12).  The
two policies of a sharded hop, ``fused`` (face exchange, then the halo-mode
kernel) and ``overlap`` (the interior launch beside the exchange, then the
slab repairs), are timed on the production operands, and the winner is
cached as JSON under $TPUQCD_RESOURCE_PATH (default ~/.cache/tpuqcd) in
``torch_tunecache.json``, keyed by the lattice, the mesh, the operator
and the card's name.

Every rank must take the same policy (their face exchanges must match),
so rank 0 reads the cache and broadcasts its entry; on a miss every rank
times both (the applies are collective), the slowest rank's time decides,
and rank 0 stores the winner.
"""
from __future__ import annotations

import json
import logging
import os
import time

import torch
import torch.distributed as dist

from ..parallel import dist as tdist

log = logging.getLogger("tpuqcd_torch")

POLICIES = ("fused", "overlap")
#: applies a timing round takes (two rounds, the best kept)
NITER = 10


def _cache_path() -> str:
    d = os.environ.get("TPUQCD_RESOURCE_PATH", os.path.expanduser("~/.cache/tpuqcd"))
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, "torch_tunecache.json")


def _load() -> dict:
    try:
        with open(_cache_path()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _store(cache: dict) -> None:
    with open(_cache_path(), "w") as f:
        json.dump(cache, f, indent=1, sort_keys=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_apply(fn, b, niter: int) -> float:
    """Seconds per apply, the best of two rounds of niter, the card synchronised."""
    fn(b)
    best = float("inf")
    for _ in range(2):
        _sync(b.device)
        t0 = time.perf_counter()
        for _ in range(niter):
            fn(b)
        _sync(b.device)
        best = min(best, time.perf_counter() - t0)
    return best / niter


def _device_name(device: torch.device) -> str:
    """The cache key's card: its name, or "cpu"."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def tune_comm_policy(lat, lmesh, apply_fns: dict, b_loc: torch.Tensor, *,
                     tag: str = "tm") -> str:
    """The faster of apply_fns {"fused": fn, "overlap": fn} (one operator
    apply each on this rank's shard b_loc, timed over NITER applies), the
    same on every rank; ``tag`` names the operator timed."""
    dev = b_loc.device
    key = f"comm_policy/{lat.dims}/{lmesh.nt}x{lmesh.nz}x{lmesh.ny}/{tag}/{_device_name(dev)}"
    code = torch.tensor([-1], dtype=torch.int64, device=dev)
    if tdist.rank() == 0:
        hit = _load().get(key, {}).get("policy")
        if hit in POLICIES:
            code[0] = POLICIES.index(hit)
    if tdist.world_size() > 1:
        dist.broadcast(code, 0)
    if code.item() >= 0:
        return POLICIES[code.item()]
    secs = torch.tensor([_time_apply(apply_fns[p], b_loc, NITER) for p in POLICIES],
                        dtype=torch.float64, device=dev)
    if tdist.world_size() > 1:
        dist.all_reduce(secs, op=dist.ReduceOp.MAX)
    winner = POLICIES[int(torch.argmin(secs).item())]
    log.info("comm_policy timed (%s, the slowest rank): %s -> %s", tag,
             ", ".join(f"{p} {s * 1e6:.1f} us" for p, s in zip(POLICIES, secs.tolist())), winner)
    if tdist.rank() == 0:
        cache = _load()
        cache[key] = {"policy": winner,
                      "us_per_apply": {p: round(s * 1e6, 2) for p, s in zip(POLICIES, secs.tolist())}}
        _store(cache)
    return winner
