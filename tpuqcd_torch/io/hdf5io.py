"""HDF5 output of the correlators.

Counterpart of ``tpuqcd/io/hdf5io.py`` (``write_twop`` and
``read_dataset``; the three-point and loop writers come with their
programs).  Results are host numpy arrays written with h5py, one dataset
per momentum, per source position, so a killed run loses at most one
source.  h5py is imported inside the call.
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


def write_twop(path: str, group: str, corr: np.ndarray, momenta: np.ndarray, src_pos,
               meta: dict | None = None, mode: str = "a") -> None:
    """corr [n_mom, T] complex; one dataset ``mom_px_py_pz`` per momentum
    under ``group``, with src_pos and meta as the group's attributes."""
    with _h5py().File(path, mode) as f:
        g = f.require_group(group)
        g.attrs["src_pos"] = np.asarray(src_pos)
        for k, v in (meta or {}).items():
            g.attrs[k] = v
        for i, p in enumerate(np.asarray(momenta)):
            name = f"mom_{p[0]}_{p[1]}_{p[2]}"
            if name in g:
                del g[name]
            g.create_dataset(name, data=np.asarray(corr[i]))


def read_dataset(path: str, name: str) -> np.ndarray:
    with _h5py().File(path, "r") as f:
        return np.asarray(f[name])
