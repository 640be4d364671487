"""Shared inputs for the tests of the PyTorch port (tests/test_torch_*.py).

Every input is a numpy array made from a seed and handed to both tpuqcd
(JAX, on the CPU) and tpuqcd_torch, since jax.random and torch.Generator
streams differ.  The JAX side builds its packed fields with its own
fields / layout / packing functions, the port with its own.
"""
import jax.numpy as jnp
import numpy as np
import torch

from tpuqcd.fields import apply_boundary_phase, gauge_full_to_eo
from tpuqcd.lattice import Lattice as JLattice
from tpuqcd.ops.layout import gauge_to_device
from tpuqcd.utils.packed import pack_gauge
from tpuqcd_torch.lattice import Lattice

# the gate runs several pytest workers; keep each one's torch pool small
torch.set_num_threads(2)


def random_su3_np(rng: np.random.Generator, shape) -> np.ndarray:
    """iid random SU(3) [*shape, 3, 3] complex128 (Gram-Schmidt rows,
    row 2 = conj(row0 x row1))."""
    g = rng.standard_normal((4, *shape, 3))
    r0, r1 = g[0] + 1j * g[1], g[2] + 1j * g[3]
    r0 /= np.linalg.norm(r0, axis=-1, keepdims=True)
    r1 -= np.sum(r0.conj() * r1, axis=-1, keepdims=True) * r0
    r1 /= np.linalg.norm(r1, axis=-1, keepdims=True)
    return np.stack([r0, r1, np.cross(r0, r1).conj()], axis=-2)


def lattices(dims):
    return Lattice(dims), JLattice(dims)


def gauge_full(lat: Lattice, seed: int = 0) -> np.ndarray:
    """Random full-layout gauge [4, T, Z, Y, X, 3, 3] complex128, no phase."""
    return random_su3_np(np.random.default_rng(seed), (4, *lat.full_shape))


def jax_gauge_pk(u_full: np.ndarray, jlat: JLattice, antiperiodic_t=True,
                 dtype=jnp.float64):
    """tpuqcd's packed gauge [4, 2, 3, 3, 2, T, Z, S] from a full gauge."""
    u = apply_boundary_phase(jnp.asarray(u_full), jlat, antiperiodic_t=antiperiodic_t)
    return pack_gauge(gauge_to_device(gauge_full_to_eo(u, jlat), jlat), dtype)


def spinor_pk(lat: Lattice, seed: int, parities: int = 1) -> np.ndarray:
    """Random packed spinor [(2(par),) 2(ri), 4, 3, T, Z, S] float64."""
    lead = (2,) if parities == 2 else ()
    return np.random.default_rng(seed).standard_normal((*lead, 2, 4, 3, *lat.site_shape))


def t(a, dtype=None) -> torch.Tensor:
    """numpy (or jax) array -> contiguous CPU tensor, optionally cast."""
    x = torch.from_numpy(np.array(a, copy=True, order="C"))
    return x if dtype is None else x.to(dtype)


def n(x: torch.Tensor) -> np.ndarray:
    return x.detach().to(torch.float64).numpy() if x.dtype == torch.bfloat16 \
        else x.detach().numpy()


def tpuqcd_setup_gauge_phase_as_configured(monkeypatch) -> None:
    """Make tpuqcd's setup_gauge apply the boundary phase that its config
    asks for.  It calls apply_boundary_phase(u_full, lat,
    cfg.gauge.antiperiodic_t) (tpuqcd/cli/common.py:270), whose third
    parameter is ``eo`` (tpuqcd/fields.py:94): with antiperiodic_t true it
    indexes the z axis of the full layout, which drops the phase when Lz <
    Lt, and with false it applies the phase all the same.  The port applies
    it as configured (ROADMAP.md, Queue 3)."""
    import tpuqcd.fields as jfields
    real = jfields.apply_boundary_phase

    def as_configured(u, lat, antiperiodic_t=True):
        return real(u, lat, eo=False, antiperiodic_t=antiperiodic_t)
    monkeypatch.setattr(jfields, "apply_boundary_phase", as_configured)
