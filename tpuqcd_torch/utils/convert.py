"""State carried over from tpuqcd: numpy arrays -> the port's tensors.

A gauge field in the full site layout (as tpuqcd's setup or an ILDG
reader returns it) goes through the port's own boundary phase, eo split,
device layout and packing; arrays already in a packed layout (spinors,
gauges, clover blocks) are checked and moved as they are.
"""
from __future__ import annotations

import numpy as np
import torch

from ..fields import apply_boundary_phase, gauge_full_to_eo
from ..lattice import Lattice
from ..ops.layout import gauge_to_device
from .packed import pack_gauge


def gauge_from_full(u_full, lat: Lattice, antiperiodic_t: bool = True,
                    dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Complex full-layout gauge [4, T, Z, Y, X, 3, 3] (numpy array or
    tensor, no boundary phase) -> packed [4, 2, 3, 3, 2, T, Z, S] on
    ``device``, with the temporal boundary phase folded in."""
    u = torch.as_tensor(u_full, device=device)
    if not u.is_complex() or tuple(u.shape) != lat.gauge_shape():
        raise ValueError(f"gauge must be complex {lat.gauge_shape()}, got "
                         f"{u.dtype} {tuple(u.shape)}")
    u = apply_boundary_phase(u, lat, antiperiodic_t=antiperiodic_t)
    return pack_gauge(gauge_to_device(gauge_full_to_eo(u, lat), lat), dtype)


def packed_from_numpy(arr: np.ndarray, lat: Lattice, device=None) -> torch.Tensor:
    """An array in one of the packed layouts -> a contiguous tensor on
    ``device`` of the same dtype (float32, float64, or bfloat16 as numpy
    carries it for jax).  Layouts:

        spinor          [2, 4, 3, T, Z, S]
        full system     [2, 2, 4, 3, T, Z, S] (also a one-parity doublet
                        [2(fl), 2(ri), 4, 3, T, Z, S])
        doublet system  [2(fl), 2(par), 2, 4, 3, T, Z, S]
        gauge           [4, 2, 3, 3, 2, T, Z, S], reconstruct-12 [4, 2, 2, 3, 2, T, Z, S]
                        or reconstruct-8 [4, 2, 4, 1, 2, T, Z, S]
        a batch         [N, ...] of spinors, full systems (packed sources) or
                        propagator columns [N, 2(par), 2(ri), 4, 3, T, Z, S]
    """
    arr = np.asarray(arr)
    sites = lat.site_shape
    layouts = [(2, 4, 3, *sites), (2, 2, 4, 3, *sites), (2, 2, 2, 4, 3, *sites),
               (4, 2, 3, 3, 2, *sites), (4, 2, 2, 3, 2, *sites), (4, 2, 4, 1, 2, *sites)]
    if arr.shape not in layouts and arr.shape[1:] not in layouts[:2]:
        raise ValueError(f"shape {arr.shape} is not a packed layout of {lat.dims}: "
                         f"{layouts}")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(device, torch.bfloat16)
    if arr.dtype not in (np.float32, np.float64):
        raise ValueError(f"dtype {arr.dtype} is not float32, float64 or bfloat16")
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def clover_from_numpy(lat: Lattice, cl_pk: np.ndarray, *inverses: np.ndarray,
                      device=None) -> tuple[torch.Tensor, ...]:
    """tpuqcd's packed clover arrays -> the port's tensors on ``device``,
    dtypes kept: the A blocks cl_pk [2(par), 2(ri), 2(chir), 6, 6, T, Z, S]
    (solve.make_clover_fields[0], or the clover_pk of setup_multigrid) and
    any number of one-parity blocks [2(ri), 2(chir), 6, 6, T, Z, S] (the
    twisted inverses clinv_plus, clinv_minus).  Returns (cl_pk, *inverses)."""
    sites = lat.site_shape
    out = []
    for arr, lead in ((cl_pk, (2,)), *((a, ()) for a in inverses)):
        arr = np.asarray(arr)
        want = (*lead, 2, 2, 6, 6, *sites)
        if arr.shape != want or arr.dtype not in (np.float32, np.float64):
            raise ValueError(f"clover array {arr.dtype} {arr.shape} is not float32 or "
                             f"float64 {want}")
        out.append(torch.from_numpy(np.ascontiguousarray(arr)).to(device))
    return tuple(out)


def fine_transfer_from_numpy(lat: Lattice, block, v_np: np.ndarray,
                             linv_np: np.ndarray | None = None, device=None):
    """tpuqcd's null vectors [n, 2, 2, 4, 3, T, Z, S] (and optionally its
    Linv [2, 2, n, n, Tc, Zc, Sc]) as numpy arrays -> the port's
    mg.device.DeviceFineTransfer on ``device``; without Linv the port
    orthogonalizes the blocks itself."""
    from ..mg.device import DeviceFineTransfer
    from .checkpoint import float_array
    v = torch.tensor(float_array(np.asarray(v_np), "v"), device=device)
    linv = None if linv_np is None else torch.tensor(
        float_array(np.asarray(linv_np), "linv"), device=device)
    return DeviceFineTransfer.from_pk(lat, block, v, linv)
