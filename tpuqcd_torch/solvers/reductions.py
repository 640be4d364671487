"""Global reductions accumulated in float64.

Counterpart of ``tpuqcd/solvers/reductions.py``.  The H100 has native
f64, so the sums simply run in float64; results are 0-d float64
tensors on the field's device (no host sync until a caller asks).

On a LatticeMesh the fields are local shards: inside ``over(lmesh)``
every reduction all-reduces its float64 partial sum over the ranks (the
psum XLA inserts on tpuqcd's sharded arrays, tpuqcd/parallel/mesh.py:7-8),
so the solvers run unchanged on shards:

    with reductions.over(lmesh):
        x, relres, k, nref = _refined_solve(op, ...)
    corr = reductions.mesh_sum(partial, lmesh)    # complex128 [n_mom, T] on every rank
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

#: the mesh whose ranks a reduction sums over (None: the field is whole)
_MESH: contextvars.ContextVar = contextvars.ContextVar("tpuqcd_torch_reduce_mesh",
                                                       default=None)


@contextlib.contextmanager
def over(lmesh):
    """Reductions inside the block sum over the ranks of ``lmesh``; over(None)
    makes them local again (the replicated coarse levels of a sharded
    multigrid).  utils/pkalg's reductions follow the same scope."""
    token = _MESH.set(lmesh)
    try:
        yield
    finally:
        _MESH.reset(token)


def active() -> bool:
    """Whether reductions sum over several ranks here."""
    lmesh = _MESH.get()
    return lmesh is not None and lmesh.size > 1


def summed(s: torch.Tensor) -> torch.Tensor:
    """A partial sum of local shards summed over the ranks of the mesh in
    scope (in place); itself outside ``over``."""
    if active():
        dist.all_reduce(s)
    return s


def mesh_sum(s: torch.Tensor, lmesh) -> torch.Tensor:
    """The sum over the ranks of ``lmesh`` of a partial sum (float64 or
    complex128, any shape: a projection's [n_mom, T]), in place."""
    with over(lmesh):
        return summed(s)


def _f64(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1).to(torch.float64)


def norm2(x: torch.Tensor) -> torch.Tensor:
    """sum |x|^2 (x real or complex) as a float64 0-d tensor."""
    if x.is_complex():
        return norm2(torch.view_as_real(x))
    v = _f64(x)
    return summed(torch.dot(v, v))


def redot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Re <x, y> = Re sum conj(x) y as a float64 0-d tensor."""
    if x.is_complex():
        return redot(torch.view_as_real(x), torch.view_as_real(y))
    return summed(torch.dot(_f64(x), _f64(y)))


def cdot(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """<x, y> = sum conj(x) y of complex fields as a (re, im) float64 pair."""
    xr, xi = _f64(x.real), _f64(x.imag)
    yr, yi = _f64(y.real), _f64(y.imag)
    s = summed(torch.stack([torch.dot(xr, yr) + torch.dot(xi, yi),
                             torch.dot(xr, yi) - torch.dot(xi, yr)]))
    return s[0], s[1]


def _cols64(x: torch.Tensor) -> torch.Tensor:
    if x.is_complex():
        x = torch.view_as_real(x)
    return x.flatten(1).to(torch.float64)


def norm2_cols(x: torch.Tensor) -> torch.Tensor:
    """sum |x_i|^2 of every field of a batch [N, ...] as float64 [N]: one
    reduction over the flattened columns."""
    v = _cols64(x)
    return summed(torch.linalg.vecdot(v, v))


def redot_cols(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Re <x_i, y_i> of every field of two batches [N, ...] as float64 [N]."""
    return summed(torch.linalg.vecdot(_cols64(x), _cols64(y)))
