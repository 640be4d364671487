"""Link smearing, Gaussian smearing and the propagator layouts of the
port against tpuqcd, on shared numpy inputs.

Tolerances: float32 results 1e-5 of the output's largest value (the two
packages sum in different orders; APE ends in the same SU(3) projection,
stout in the same 16-term series); layout maps are exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd.fields import gauge_full_to_eo as j_gauge_full_to_eo
from tpuqcd.ops import gauge_tools as jgt
from tpuqcd.ops.layout import gauge_to_device as j_gauge_to_device
from tpuqcd.phys import propagator as jprop
from tpuqcd.phys.smear import cov_laplace_3d_pk as j_cov_laplace_3d_pk
from tpuqcd.phys.smear import gaussian_smear_pk as j_gaussian_smear_pk
from tpuqcd.utils.packed import pack_gauge as j_pack_gauge

from tpuqcd_torch.ops.gauge_tools import (ape_smear, ape_smear_step, spatial_plaquette,
                                          stout_smear, stout_smear_step)
from tpuqcd_torch.phys.propagator import (assemble_propagator_pk, full_to_packed,
                                          packed_sources, packed_to_full, point_sources,
                                          propagator_columns, sink_smear_packed,
                                          sink_smear_prop_pk, smear_sources)
from tpuqcd_torch.phys.smear import cov_laplace_3d_pk, gaussian_smear_pk

from _torch_inputs import gauge_full, lattices, n, t

LAT, JLAT = lattices((4, 4, 4, 8))


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.fixture(scope="module")
def gauge():
    """The complex64 device-layout gauge without a boundary phase, as jax
    and torch arrays."""
    u = j_gauge_to_device(j_gauge_full_to_eo(jnp.asarray(gauge_full(LAT, 3)), JLAT), JLAT)
    u = u.astype(jnp.complex64)
    return u, t(u)


@pytest.fixture(scope="module")
def smeared(gauge):
    """APE 0.5 x 2 (examples/twop.yaml) on both sides, packed float32."""
    ju, tu = gauge
    j_sm = jgt.ape_smear(ju, JLAT, alpha=0.5, n_steps=2)
    return j_pack_gauge(j_sm), torch.stack([ape_smear(tu, LAT, 0.5, 2).real,
                                            ape_smear(tu, LAT, 0.5, 2).imag], dim=4).contiguous()


def _columns(seed=7, k=3):
    return np.random.default_rng(seed).standard_normal(
        (k, 2, 2, 4, 3, *LAT.site_shape)).astype(np.float32)


def test_spatial_plaquette_matches_tpuqcd(gauge):
    ju, tu = gauge
    assert spatial_plaquette(tu, LAT) == pytest.approx(float(jgt.spatial_plaquette(ju, JLAT)),
                                                       abs=1e-6)


@pytest.mark.parametrize("spatial_only", [True, False])
def test_ape_smear_matches_tpuqcd(gauge, spatial_only):
    """Two steps over the spatial links (the two-point run's smearing), one
    step over all four directions."""
    ju, tu = gauge
    if spatial_only:
        ref = jgt.ape_smear(ju, JLAT, alpha=0.5, n_steps=2)
        got = ape_smear(tu, LAT, 0.5, 2)
        np.testing.assert_array_equal(n(torch.view_as_real(got[3])),
                                      n(torch.view_as_real(tu[3])))
    else:
        ref = jgt.ape_smear_step(ju, JLAT, alpha=0.5, spatial_only=False)
        got = ape_smear_step(tu, LAT, 0.5, spatial_only=False)
    _close(torch.view_as_real(got), np.stack([ref.real, ref.imag], -1))
    # the links stay in SU(3)
    m = got.permute(0, 1, 4, 5, 6, 2, 3)
    eye = torch.eye(3, dtype=m.dtype)
    assert (m @ m.mH - eye).abs().max().item() < 1e-5
    assert (torch.linalg.det(m) - 1).abs().max().item() < 1e-5


@pytest.mark.parametrize("spatial_only", [True, False])
def test_stout_smear_matches_tpuqcd(gauge, spatial_only):
    ju, tu = gauge
    if spatial_only:
        ref = jgt.stout_smear(ju, JLAT, rho=0.1, n_steps=2, spatial_only=True)
        got = stout_smear(tu, LAT, 0.1, 2, spatial_only=True)
    else:
        ref = jgt.stout_smear_step(ju, JLAT, rho=0.1, spatial_only=False)
        got = stout_smear_step(tu, LAT, 0.1, spatial_only=False)
    _close(torch.view_as_real(got), np.stack([ref.real, ref.imag], -1))


def test_cov_laplace_matches_tpuqcd(smeared):
    j_sm, t_sm = smeared
    _close(n(t_sm), np.asarray(j_sm))
    x = _columns()[0]
    _close(n(cov_laplace_3d_pk(t_sm, t(x), LAT)), j_cov_laplace_3d_pk(j_sm, jnp.asarray(x), JLAT))


def test_gaussian_smear_matches_tpuqcd_single_and_batched(smeared):
    j_sm, t_sm = smeared
    x = _columns()
    got = gaussian_smear_pk(t_sm, t(x), LAT, 1.0, 4)
    assert got.shape == x.shape and got.dtype == torch.float32
    for i in range(x.shape[0]):
        ref = j_gaussian_smear_pk(j_sm, jnp.asarray(x[i]), JLAT, 1.0, 4)
        _close(n(got[i]), ref)
        _close(n(sink_smear_packed(t_sm, t(x[i]), LAT, 1.0, 4)), ref)
    # smearing is spatial: a field on one timeslice stays there
    one_t = np.zeros_like(x[0])
    one_t[..., 2, :, :] = x[0][..., 2, :, :]
    out = n(gaussian_smear_pk(t_sm, t(one_t), LAT, 1.0, 4))
    assert np.abs(np.delete(out, 2, axis=-3)).max() == 0.0
    assert gaussian_smear_pk(t_sm, t(x), LAT, 1.0, 0) is not None


def test_sink_smear_prop_matches_tpuqcd(smeared):
    j_sm, t_sm = smeared
    prop = np.random.default_rng(9).standard_normal(
        (2, 2, 4, 3, 4, 3, *LAT.site_shape)).astype(np.float32)
    ref = jprop.sink_smear_prop_pk(j_sm, jnp.asarray(prop), JLAT, 1.0, 3)
    _close(n(sink_smear_prop_pk(t_sm, t(prop), LAT, 1.0, 3)), ref)


def test_propagator_layouts_match_tpuqcd():
    cols = _columns(11, 12)
    ref = np.asarray(jprop.assemble_propagator_pk([jnp.asarray(c) for c in cols]))
    got = assemble_propagator_pk(t(cols))
    np.testing.assert_array_equal(n(got), ref)
    np.testing.assert_array_equal(n(assemble_propagator_pk(list(t(cols)))), ref)
    np.testing.assert_array_equal(n(propagator_columns(got)), cols)
    full = np.asarray(jprop.packed_to_full(jnp.asarray(cols[0]), JLAT))
    np.testing.assert_array_equal(n(packed_to_full(t(cols[0]), LAT)), full)
    np.testing.assert_array_equal(n(full_to_packed(t(full), LAT)), cols[0])


def test_sources_match_tpuqcd(gauge, smeared):
    ju, _ = gauge
    j_sm, t_sm = smeared
    pos = (1, 2, 0, 3)
    j_src = jprop.point_sources(JLAT, pos)
    src = point_sources(LAT, pos)
    np.testing.assert_array_equal(n(src), np.asarray(j_src))
    b = packed_sources(src, LAT)
    np.testing.assert_array_equal(n(b), np.asarray(jprop.packed_sources(j_src, JLAT)))
    # tpuqcd smears its full-layout sources on the complex gauge, one by one
    j_ape = jgt.ape_smear(ju, JLAT, alpha=0.5, n_steps=2)
    ref = jprop.packed_sources(jprop.smear_sources(j_ape, j_src, JLAT, 1.0, 4), JLAT)
    _close(n(smear_sources(t_sm, b, LAT, 1.0, 4)), ref)
