"""MG hierarchy dumps and deflation eigenpairs, in the npz formats of
``tpuqcd.utils.checkpoint``.

``save_device_mg`` writes, and ``load_device_mg`` reads, the arrays of
tpuqcd's ``save_device_mg`` (utils/checkpoint.py:70, :87) under the same
keys and layouts: per transfer the raw null vectors ``t{i}_v``, Linv
``t{i}_linv`` and the block ``t{i}_block``; per coarse level the links
``c{i}_links`` [2, 9, N, N, Vc], ``c{i}_dims`` and ``c{i}_n``.  A
hierarchy dumped by either package loads into the other; a reload skips
the null-vector solves, the block orthogonalization and the probing.

``save_eigenpairs`` and ``load_eigenpairs`` (tpuqcd/utils/checkpoint.py:
128-157) keep a deflation basis under the keys ``evals``, ``evecs`` and
``layout``; files of either package load in the other.

tpuqcd writes bfloat16 coarse links (coarse_dtype "bfloat16") and a
bfloat16 null-vector bank (vec_dtype "bfloat16") with ml_dtypes'
bfloat16, which ``np.load`` returns as a 2-byte void dtype; they are read
here as the bfloat16 bit patterns they are.  The port writes a bfloat16
bank as its exact float32 widening, and either file loads into a
bfloat16 bank bit for bit when params.vec_dtype is "bfloat16".
"""
from __future__ import annotations

import numpy as np
import torch


def save_device_mg(path: str, mg) -> None:
    """Dump a DeviceMG (tpuqcd_torch.mg.dsolve) hierarchy; float32 arrays
    (bfloat16-rounded coarse links and a bfloat16 bank are exact in
    float32)."""
    blobs = {"n_transfers": np.asarray(len(mg.transfers))}
    for i, tr in enumerate(mg.transfers):
        blobs[f"t{i}_v"] = tr.v_pk().cpu().numpy()
        blobs[f"t{i}_linv"] = tr.linv_pk().cpu().numpy()
        blobs[f"t{i}_block"] = np.asarray(tr.block)
    for i, lv in enumerate(mg.levels[1:]):
        blobs[f"c{i}_links"] = lv.links_pk().cpu().numpy()
        blobs[f"c{i}_dims"] = np.asarray(lv.dims)
        blobs[f"c{i}_n"] = np.asarray(lv.n)
    np.savez_compressed(path, **blobs)


def float_array(arr: np.ndarray, name: str = "array") -> np.ndarray:
    """A dumped float array as float32 or float64: a 2-byte void array (a
    bfloat16 array written from jax) is widened bit-exactly; any other
    dtype raises."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        bits = arr.view(np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32)
    if arr.dtype.name == "bfloat16":
        return arr.astype(np.float32)
    if arr.dtype not in (np.float32, np.float64):
        raise ValueError(f"{name}: dtype {arr.dtype} is not float32, float64 or bfloat16")
    return arr


def load_device_mg(path: str, fine_level, params):
    """Rebuild a DeviceMG on ``fine_level`` from a dump (no setup).  With
    params.vec_dtype "bfloat16" the null vectors reach the device in
    bfloat16 (rounded on the host, exact for a bfloat16 bank's file)."""
    from ..mg.device import DeviceCoarseLevel, DeviceCoarseTransfer, DeviceFineTransfer
    from ..mg.dsolve import DeviceMG

    dev = fine_level.device
    z = np.load(path)
    vec_dtype = torch.bfloat16 if params.vec_dtype == "bfloat16" else torch.float32

    def tensor(key, dtype=None):
        host = torch.from_numpy(np.ascontiguousarray(float_array(z[key], key)))
        return (host if dtype is None else host.to(dtype)).to(dev)

    transfers, coarse = [], []
    level = fine_level
    for i in range(int(z["n_transfers"])):
        block = tuple(int(b) for b in z[f"t{i}_block"])
        v, linv = tensor(f"t{i}_v", vec_dtype), tensor(f"t{i}_linv")
        if i == 0:
            tr = DeviceFineTransfer.from_pk(fine_level.lat, block, v, linv)
        else:
            tr = DeviceCoarseTransfer.from_pk(level.dims, level.n, block, v, linv)
        links = tensor(f"c{i}_links")
        if links.ndim != 5:
            raise ValueError(f"{path}: coarse links have rank {links.ndim}, not the "
                             "[2, 9, N, N, Vc] layout; regenerate the dump")
        level = DeviceCoarseLevel.from_links_pk(tuple(int(d) for d in z[f"c{i}_dims"]),
                                                int(z[f"c{i}_n"]), links)
        transfers.append(tr)
        coarse.append(level)
    return DeviceMG.from_parts(fine_level, params, transfers, coarse)


def save_eigenpairs(path: str, evals, evecs, layout: str = "", lmesh=None) -> None:
    """evals [n] and evecs (a stack or a list of n fields) into ``path``
    (numpy adds .npz when the name lacks it).  layout: "packed" (the
    device basis, MG layout [2(ri), 2(par), 4, 3, T, Z, S]) or "full"
    (tpuqcd's host basis), recorded so that a reload on the other path
    fails instead of feeding the wrong layout on.  Uncompressed (tpuqcd
    compresses; np.load reads both): float32 eigenvectors hardly compress,
    and zlib takes tens of seconds on a 32^3x64 basis.  On a mesh
    (``lmesh``; every rank calls it) evecs are this rank's blocks of
    packed fields: each vector is gathered whole to rank 0 in turn, and
    rank 0 alone writes the one-card file."""
    if lmesh is not None:
        whole = []
        for v in evecs:             # to the host one at a time: rank 0's card holds one
            v = lmesh.gather(torch.as_tensor(v).contiguous())
            if v is not None:
                whole.append(v.cpu())
        if lmesh.rank != 0:
            return
        evecs = whole
    np.savez(path, evals=np.asarray(evals),
                        evecs=np.stack([torch.as_tensor(v).cpu().numpy() for v in evecs]),
                        layout=np.asarray(layout))


def load_eigenpairs(path: str, expect_layout: str | None = None,
                    n_expect: int | None = None, lmesh=None):
    """(evals, [evec tensors on the CPU]) from a save_eigenpairs file; with
    ``n_expect`` the first n_expect pairs; on a mesh (``lmesh``) this rank's
    blocks of packed fields.  A file of another layout than
    ``expect_layout``, or with fewer than n_expect pairs, raises."""
    z = np.load(path)
    if expect_layout and "layout" in z:
        got = str(z["layout"])
        if got and got != expect_layout:
            raise ValueError(f"{path} holds {got!r}-layout eigenvectors; this run needs "
                             f"{expect_layout!r} (device and host deflation bases are not "
                             "interchangeable: regenerate on this path or drop eig_infile)")
    evecs = [torch.from_numpy(np.ascontiguousarray(v)) for v in z["evecs"]]
    if lmesh is not None:
        evecs = [lmesh.shard(v).contiguous() for v in evecs]
    evals = z["evals"]
    if n_expect is not None:
        if len(evecs) < n_expect:
            raise ValueError(f"{path} holds {len(evecs)} eigenpairs but the config asks "
                             f"n_deflate={n_expect}; regenerate with enough modes or lower "
                             "n_deflate")
        return evals[:n_expect], evecs[:n_expect]
    return evals, evecs
