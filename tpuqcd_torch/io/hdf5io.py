"""HDF5 output of the correlators and loops.

Counterpart of ``tpuqcd/io/hdf5io.py`` (``write_twop``, ``write_threep``,
``write_loops`` and ``read_dataset``).  Results are host numpy arrays
written with h5py: correlators one dataset per momentum, per source
position, so a killed run loses at most one source; loops one dataset per
insertion.  h5py is imported inside the call.
"""
from __future__ import annotations

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("writing or reading correlator files needs the h5py package "
                          "(the `torch` extra of this project lists it)") from e
    return h5py


def _group(f, group: str, attrs: dict):
    g = f.require_group(group)
    for k, v in attrs.items():
        g.attrs[k] = v
    return g


def _write_momenta(g, corr: np.ndarray, momenta: np.ndarray) -> None:
    """corr [n_mom, T]: one dataset mom_px_py_pz per momentum, replacing one
    already there."""
    for i, p in enumerate(np.asarray(momenta)):
        name = f"mom_{p[0]}_{p[1]}_{p[2]}"
        if name in g:
            del g[name]
        g.create_dataset(name, data=np.asarray(corr[i]))


def write_twop(path: str, group: str, corr: np.ndarray, momenta: np.ndarray, src_pos,
               meta: dict | None = None, mode: str = "a") -> None:
    """corr [n_mom, T] complex; one dataset ``mom_px_py_pz`` per momentum
    under ``group``, with src_pos and meta as the group's attributes."""
    with _h5py().File(path, mode) as f:
        _write_momenta(_group(f, group, {"src_pos": np.asarray(src_pos), **(meta or {})}),
                       corr, momenta)


def write_threep(path: str, group: str, corr: np.ndarray, momenta: np.ndarray,
                 insertions: list[str], src_pos, t_sink: int, meta: dict | None = None,
                 mode: str = "a") -> None:
    """corr [n_insertion, n_mom, T] complex; under ``group`` one subgroup per
    insertion and in it one dataset ``mom_px_py_pz`` per momentum, with
    src_pos, t_sink and meta as the group's attributes."""
    with _h5py().File(path, mode) as f:
        g = _group(f, group, {"src_pos": np.asarray(src_pos), "t_sink": t_sink, **(meta or {})})
        for j, ins in enumerate(insertions):
            _write_momenta(g.require_group(ins), corr[j], momenta)


def write_loops(path: str, group: str, loops: np.ndarray, insertions: list[str],
                meta: dict | None = None, mode: str = "a") -> None:
    """loops [n_insertion, n_mom, T] (or [n_insertion, T]) complex; under
    ``group`` one dataset per insertion, replacing one already there, with
    meta as the group's attributes."""
    with _h5py().File(path, mode) as f:
        g = _group(f, group, meta or {})
        for j, ins in enumerate(insertions):
            if ins in g:
                del g[ins]
            g.create_dataset(ins, data=np.asarray(loops[j]))


def read_dataset(path: str, name: str) -> np.ndarray:
    with _h5py().File(path, "r") as f:
        return np.asarray(f[name])
