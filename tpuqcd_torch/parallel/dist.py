"""Multi-process layer: one process per card, launched by torchrun.

Counterpart of ``tpuqcd/parallel/dist.py``.  Where tpuqcd reads
TPUQCD_DIST and forms a multi-controller JAX runtime, the port reads
torchrun's environment (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT) and forms a torch.distributed process group: NCCL between
cards, gloo between CPU processes (the tests).  Each rank's device is
cuda:LOCAL_RANK.

    torchrun --nproc_per_node 4 -m tpuqcd_torch.cli.run_invert --config cfg.yaml
    torchrun --nproc_per_node 2 -m tpuqcd_torch.cli.run_invert --config cfg.yaml --device cpu

A failed init raises; nothing falls back to one process.
"""
from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger("tpuqcd_torch")


#: the variables of torchrun's env:// rendezvous
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def is_enabled() -> bool:
    """True when the process was launched by torchrun, as one rank of
    several or alone (--nproc_per_node 1: a group of one, whose collectives
    run over the same backend)."""
    return all(k in os.environ for k in _TORCHRUN_ENV)


def init_distributed(device_type: str) -> torch.device | None:
    """Join the process group of a torchrun launch (idempotent; a no-op
    unless is_enabled()): backend nccl for ``device_type`` "cuda", gloo
    for "cpu".  Returns this rank's device (cuda:LOCAL_RANK or cpu), or
    None when not launched as several ranks.  Must run before the rank
    touches its card."""
    if not is_enabled():
        return None
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda rank was launched, but CUDA is not available")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device_type == "cpu":
        device, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"device must be cuda or cpu, got {device_type!r}")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                world_size=int(os.environ["WORLD_SIZE"]),
                                rank=int(os.environ["RANK"]))
        log.info("distributed: rank %d/%d (%s) on %s", dist.get_rank(), dist.get_world_size(),
                 backend, device)
    return device


def shutdown() -> None:
    """Leave the process group of a torchrun launch (a no-op without one).
    Every CLI calls it on the way out: a gloo rank that exits with its
    group still up can abort in the group's teardown (SIGABRT, "terminate
    called without an active exception") after its work is done, which
    fails the launch."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_shard(arr, lmesh, device=None) -> torch.Tensor:
    """Counterpart of tpuqcd's global_put: every rank holds the SAME full
    array (gauge and sources are built from the shared seed) and keeps
    its own slice of the trailing [T, Z, S] axes, contiguous on
    ``device``."""
    return lmesh.shard(torch.as_tensor(arr)).to(device).contiguous()


def all_processes_agree(value: float, tag: str = "") -> bool:
    """Cheap cross-process consistency check: every rank contributes
    value / N to a float64 sum, which must equal value."""
    n = world_size()
    if n == 1:
        return True
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    x = torch.tensor([value / n], dtype=torch.float64, device=dev)
    dist.all_reduce(x)
    total = x.item()
    ok = abs(total - value) <= 1e-12 * max(1.0, abs(value))
    if not ok:
        log.error("process disagreement on %s: %r vs %r", tag, value, total)
    return ok


def rank0_outcome(value: float, failed: bool, device: torch.device) -> tuple[int, float]:
    """(how many ranks report ``failed``, rank 0's ``value``) on every rank,
    in one all-reduce of two float64s on ``device`` ((int(failed), value)
    without a group).  It closes a step that rank 0 alone finishes, such as
    the write of a heatbath chain's member (cli/common._heatbath_chain_members):
    every rank learns rank 0's result, and a failure on any rank is seen by
    all, so that no rank is left waiting in a later collective."""
    if not dist.is_initialized():
        return int(failed), value
    x = torch.tensor([float(failed), value if rank() == 0 and not failed else 0.0],
                     dtype=torch.float64, device=device)
    dist.all_reduce(x)
    return int(x[0].item()), x[1].item()


def broadcast_float(value: float, device: torch.device, src: int = 0) -> float:
    """``value`` of rank ``src`` on every rank (itself without a group)."""
    if world_size() == 1:
        return value
    x = torch.tensor([value], dtype=torch.float64, device=device)
    dist.broadcast(x, src)
    return x.item()
