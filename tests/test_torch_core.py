"""The port's data model against tpuqcd: gamma tables, layouts, packing,
boundary phase, reconstruct-12, SU(3) helpers, plaquette, the state
carried over from numpy, and the rule that the port never imports jax.

Layout and packing conversions move numbers without arithmetic, so they
must agree exactly."""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuqcd.gammas as jg
from tpuqcd import su3 as jsu3
from tpuqcd.fields import eo_to_full as j_eo_to_full, full_to_eo as j_full_to_eo
from tpuqcd.ops.gauge_tools import plaquette as j_plaquette
from tpuqcd.ops.layout import gauge_to_device as j_gauge_to_device
from tpuqcd.phys.propagator import full_to_packed as j_full_to_packed
from tpuqcd.utils.packed import pack_gauge12 as j_pack_gauge12

import tpuqcd_torch.gammas as tg
from tpuqcd_torch import su3
from tpuqcd_torch.fields import (apply_boundary_phase, eo_to_full, full_to_eo,
                                 gauge_eo_to_full, gauge_full_to_eo)
from tpuqcd_torch.ops.gauge_tools import plaquette
from tpuqcd_torch.ops.layout import (gauge_from_device, gauge_to_device,
                                     spinor_from_device, spinor_to_device)
from tpuqcd_torch.phys.propagator import full_to_packed
from tpuqcd_torch.utils.convert import gauge_from_full, packed_from_numpy
from tpuqcd_torch.utils.packed import (pack_gauge, pack_gauge12, pack_spinor,
                                       unpack_gauge, unpack_spinor)

from _torch_inputs import gauge_full, jax_gauge_pk, lattices, n, random_su3_np, t

LAT, JLAT = lattices((4, 6, 4, 8))
ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["GAMMA", "GAMMA5", "HALF_PROJ_MINUS", "HALF_RECON_MINUS",
                                  "HALF_PROJ_PLUS", "HALF_RECON_PLUS"])
def test_gamma_tables_equal_tpuqcd(name):
    np.testing.assert_array_equal(getattr(tg, name).numpy(), getattr(jg, name))


def test_g5_diag_is_gamma5():
    np.testing.assert_array_equal(np.diag(tg.GAMMA5.numpy()), np.asarray(tg.G5_DIAG))


@pytest.mark.parametrize("antiperiodic_t", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gauge_from_full_matches_tpuqcd_packing(antiperiodic_t, dtype):
    """boundary phase -> eo split -> device layout -> pack, exactly."""
    u = gauge_full(LAT, seed=3)
    ref = np.asarray(jax_gauge_pk(u, JLAT, antiperiodic_t,
                                  jnp.float32 if dtype == torch.float32 else jnp.float64))
    got = gauge_from_full(u, LAT, antiperiodic_t, dtype)
    assert got.dtype == dtype and got.is_contiguous()
    np.testing.assert_array_equal(n(got), ref)
    # reconstruct-12: rows 0 and 1 of the same array, as a contiguous copy
    u12 = pack_gauge12(gauge_to_device(gauge_full_to_eo(
        apply_boundary_phase(t(u), LAT, antiperiodic_t=antiperiodic_t), LAT), LAT), dtype)
    assert u12.is_contiguous()
    np.testing.assert_array_equal(n(u12), ref[:, :, :2])


def test_pack_gauge12_matches_tpuqcd():
    u_dev = j_gauge_to_device(j_full_to_eo(jnp.asarray(gauge_full(LAT, 4)), JLAT, 1), JLAT)
    ref = np.asarray(j_pack_gauge12(u_dev, jnp.float32))
    np.testing.assert_array_equal(n(pack_gauge12(t(u_dev))), ref)


def test_full_to_packed_matches_tpuqcd():
    rng = np.random.default_rng(5)
    shape = (*LAT.full_shape, 4, 3)
    psi = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    ref = np.asarray(j_full_to_packed(jnp.asarray(psi), JLAT))
    np.testing.assert_array_equal(n(full_to_packed(t(psi), LAT)), ref)


def test_eo_split_matches_tpuqcd_and_round_trips():
    rng = np.random.default_rng(6)
    f = rng.standard_normal((*LAT.full_shape, 4, 3))
    eo = full_to_eo(t(f), LAT)
    np.testing.assert_array_equal(n(eo), np.asarray(j_full_to_eo(jnp.asarray(f), JLAT)))
    np.testing.assert_array_equal(n(eo_to_full(eo, LAT)), f)
    back = np.asarray(j_eo_to_full(jnp.asarray(n(eo)), JLAT))
    np.testing.assert_array_equal(back, f)


def test_device_layout_round_trips():
    u = t(gauge_full(LAT, 7))
    u_eo = gauge_full_to_eo(u, LAT)
    assert torch.equal(gauge_eo_to_full(gauge_from_device(gauge_to_device(u_eo, LAT), LAT),
                                        LAT), u)
    psi_eo = full_to_eo(t(np.random.default_rng(8).standard_normal((*LAT.full_shape, 4, 3))),
                        LAT)
    assert torch.equal(spinor_from_device(spinor_to_device(psi_eo, LAT), LAT), psi_eo)
    assert torch.equal(unpack_spinor(pack_spinor(spinor_to_device(psi_eo, LAT).to(
        torch.complex128), torch.float64)), spinor_to_device(psi_eo, LAT).to(torch.complex128))
    u_dev = gauge_to_device(u_eo, LAT)
    assert torch.equal(unpack_gauge(pack_gauge(u_dev, torch.float64)), u_dev)


def test_boundary_phase_eo_layout_matches_full_layout():
    u = t(gauge_full(LAT, 9))
    a = gauge_full_to_eo(apply_boundary_phase(u, LAT), LAT)
    b = apply_boundary_phase(gauge_full_to_eo(u, LAT), LAT, layout="eo")
    assert torch.equal(a, b) and not torch.equal(a, gauge_full_to_eo(u, LAT))
    c = apply_boundary_phase(gauge_to_device(gauge_full_to_eo(u, LAT), LAT), LAT,
                             layout="device")
    assert torch.equal(c, gauge_to_device(a, LAT))
    assert torch.equal(apply_boundary_phase(u, LAT, antiperiodic_t=False), u)


def test_su3_random_reconstruct_reunitarize():
    gen = torch.Generator().manual_seed(0)
    u = su3.random_su3((64,), gen, dtype=torch.complex128)
    eye = torch.eye(3, dtype=torch.complex128)
    torch.testing.assert_close(u @ u.mH, eye.expand(64, 3, 3), atol=1e-12, rtol=0)
    torch.testing.assert_close(torch.linalg.det(u), torch.ones(64, dtype=torch.complex128),
                               atol=1e-12, rtol=0)
    torch.testing.assert_close(su3.reconstruct12(su3.compress12(u)), u, atol=1e-12, rtol=0)
    m = random_su3_np(np.random.default_rng(10), (32,))
    np.testing.assert_allclose(n(su3.reconstruct12(t(m[..., :2, :]))),
                               np.asarray(jsu3.reconstruct12(jnp.asarray(m[..., :2, :]))),
                               atol=1e-14)
    noisy = m + 0.05 * np.random.default_rng(11).standard_normal(m.shape)
    np.testing.assert_allclose(n(su3.reunitarize(t(noisy))),
                               np.asarray(jsu3.reunitarize(jnp.asarray(noisy))), atol=1e-12)


def test_random_gauge_is_seeded():
    lat = lattices((4, 4, 4, 4))[0]
    a = su3.random_gauge(lat, torch.Generator().manual_seed(1))
    b = su3.random_gauge(lat, torch.Generator().manual_seed(1))
    assert a.shape == (4, 4, 4, 4, 4, 3, 3) and torch.equal(a, b)


def test_plaquette_matches_tpuqcd():
    u = gauge_full(LAT, 12)
    u_dev = gauge_to_device(gauge_full_to_eo(t(u), LAT), LAT)
    ref = float(j_plaquette(jnp.asarray(n(u_dev)), JLAT))
    assert abs(plaquette(u_dev, LAT) - ref) < 1e-12
    unit = torch.eye(3, dtype=torch.complex128).expand(4, 2, *LAT.site_shape, 3, 3)
    assert abs(plaquette(torch.movedim(unit, (-2, -1), (2, 3)), LAT) - 1.0) < 1e-14


@pytest.mark.parametrize("layout", ["spinor", "system", "doublet", "gauge", "gauge12"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_packed_from_numpy(layout, dtype):
    s = LAT.site_shape
    shape = {"spinor": (2, 4, 3, *s), "system": (2, 2, 4, 3, *s),
             "doublet": (2, 2, 2, 4, 3, *s),
             "gauge": (4, 2, 3, 3, 2, *s), "gauge12": (4, 2, 2, 3, 2, *s)}[layout]
    arr = np.random.default_rng(13).standard_normal(shape).astype(dtype)
    x = packed_from_numpy(arr, LAT, "cpu")
    assert x.is_contiguous() and x.dtype == torch.from_numpy(arr).dtype
    np.testing.assert_array_equal(x.numpy(), arr)


def test_packed_from_numpy_refuses_bad_input():
    with pytest.raises(ValueError, match="packed layout"):
        packed_from_numpy(np.zeros((2, 4, 3, 1, 1, 1), np.float32), LAT)
    with pytest.raises(ValueError, match="dtype"):
        packed_from_numpy(np.zeros((2, 4, 3, *LAT.site_shape), np.int32), LAT)
    with pytest.raises(ValueError, match="complex"):
        gauge_from_full(np.zeros((4, 1, 1, 1, 1, 3, 3)), LAT)


def test_port_never_imports_jax():
    """Importing every tpuqcd_torch module leaves jax (and tpuqcd) out."""
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  for p in (ROOT / "tpuqcd_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m.removesuffix('.__init__'))\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'tpuqcd'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "tpuqcd_torch.ops.dslash_cuda" in mods and "tpuqcd_torch.cli.run_invert" in mods


def test_port_sources_import_neither_jax_nor_tpuqcd():
    """No import statement of the port or of chip_smoke.py, those inside
    functions too (which importing the modules does not run), names jax or
    tpuqcd."""
    import re
    stmt = re.compile(r"^\s*(from|import)\s+(jax|tpuqcd)(\.|\s|$)", re.M)
    files = [*(ROOT / "tpuqcd_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
    bad = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}" for p in files
           for m in stmt.finditer(p.read_text())]
    assert not bad, bad
    assert len(files) > 50 and stmt.search("    from tpuqcd.cli import x\n")
    assert not stmt.search("from tpuqcd_torch.cli import x\n")
