"""The port's quenched heatbath (ops/heatbath.py), staple sum and 3x3
algebra against tpuqcd and against physics, as in test_heatbath.py, and
the packing of cli/common.setup_gauge's two gauges.

torch and jax.random draw different numbers, so the heatbath is held to
the plaquette's known limits, not bitwise.  Overrelaxation has no
randomness: on a shared gauge it matches tpuqcd to 1e-10 in complex128.
(In complex64 each package lands about 5e-4 from the exact sweep on a
random gauge, where 1/k of a small SU(2) block norm amplifies rounding,
so a float32 comparison would test rounding, not the algorithm.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd.ops import heatbath as jhb
from tpuqcd.ops import mat3 as jmat3
from tpuqcd.ops.gauge_tools import _staple_sum as j_staple_sum
from tpuqcd.ops.layout import gauge_to_device as j_gauge_to_device
from tpuqcd.fields import gauge_full_to_eo as j_gauge_full_to_eo

from tpuqcd_torch import su3
from tpuqcd_torch.cli.common import setup_gauge
from tpuqcd_torch.fields import gauge_eo_to_full
from tpuqcd_torch.ops import mat3
from tpuqcd_torch.ops.layout import gauge_from_device
from tpuqcd_torch.ops.gauge_tools import (_staple_sum, gauge_from_sites, gauge_sites,
                                          neighbour_tables, plaquette)
from tpuqcd_torch.ops.heatbath import (_sample_h0, heatbath_sweep, overrelax_sweep,
                                       thermalize)
from tpuqcd_torch.utils.config import config_from_dict
from tpuqcd_torch.utils.convert import gauge_from_full

from _torch_inputs import gauge_full, jax_gauge_pk, lattices, t

LAT, JLAT = lattices((4, 4, 4, 8))


def _u_dev():
    """A shared random gauge in the complex64 device layout."""
    u = j_gauge_to_device(j_gauge_full_to_eo(jnp.asarray(gauge_full(LAT, 3)), JLAT), JLAT)
    return np.asarray(u).astype(np.complex64)


def _su3_violation(u_dev: torch.Tensor) -> float:
    m = u_dev.permute(0, 1, 4, 5, 6, 2, 3)
    eye = torch.eye(3, dtype=m.dtype)
    return max((mat3.mul(m, m, adag=True) - eye).abs().max().item(),
               (mat3.det(m) - 1).abs().max().item())


def test_staple_sum_matches_tpuqcd():
    u = _u_dev()
    u_sm = gauge_sites(t(u))
    tables = neighbour_tables(LAT)
    for mu, p, dirs in ((0, 0, (0, 1, 2, 3)), (3, 1, (0, 1, 2, 3)), (1, 0, (0, 1, 2))):
        want = np.asarray(j_staple_sum(jnp.asarray(u), mu, p, dirs, JLAT))   # [3, 3, T, Z, S]
        got = _staple_sum(u_sm, mu, p, dirs, tables)                          # [T*Z*S, 3, 3]
        np.testing.assert_allclose(got.permute(1, 2, 0).reshape(want.shape).numpy(), want,
                                   atol=1e-5, rtol=0)
    assert torch.equal(gauge_from_sites(u_sm, LAT), t(u))


def test_overrelax_sweep_matches_tpuqcd_and_stays_in_su3():
    u = _u_dev().astype(np.complex128)
    want = np.asarray(jhb.overrelax_sweep(jnp.asarray(u), JLAT))
    np.testing.assert_allclose(overrelax_sweep(t(u), LAT).numpy(), want, atol=1e-10, rtol=0)
    u = _u_dev()
    got = overrelax_sweep(t(u), LAT)
    assert got.dtype == torch.complex64 and _su3_violation(got) < 1e-5
    # overrelaxation is microcanonical: the action (plaquette) is kept
    assert abs(plaquette(got, LAT) - plaquette(t(u), LAT)) < 1e-5


def test_mat3_project_su3_matches_tpuqcd():
    rng = np.random.default_rng(4)
    m = (rng.standard_normal((6, 3, 3)) + 1j * rng.standard_normal((6, 3, 3))).astype(np.complex64)
    want = np.asarray(jmat3.project_su3(jnp.asarray(m.transpose(1, 2, 0)))).transpose(2, 0, 1)
    np.testing.assert_allclose(mat3.project_su3(t(m)).numpy(), want, atol=1e-5)
    np.testing.assert_allclose(mat3.det(t(m)).numpy(), np.linalg.det(m), rtol=1e-5)


def test_sample_h0_density():
    """h0 ~ sqrt(1 - h0^2) exp(xi h0) on [-1, 1]: the sample mean against
    the density's mean by quadrature, on both sides of the Creutz/KP
    switch at xi = 1 (4-sigma tolerance)."""
    gen = torch.Generator().manual_seed(5)
    h = np.linspace(-1, 1, 20001)
    for xi in (0.5, 4.0):
        h0, acc = _sample_h0(gen, torch.full((40000,), xi))
        assert acc.all() and (h0.abs() <= 1).all()
        w = np.sqrt(1 - h * h) * np.exp(xi * h)
        mean = (w * h).sum() / w.sum()
        sd = np.sqrt((w * h * h).sum() / w.sum() - mean ** 2)
        assert abs(h0.double().mean().item() - mean) < 4 * sd / 200


def test_plaquette_weak_and_strong_coupling():
    lat = lattices((4, 4, 4, 4))[0]
    u = thermalize(torch.Generator().manual_seed(0), lat, beta=12.0, n_sweeps=30)
    p_weak = plaquette(u, lat)
    assert 0.80 < p_weak < 0.85, p_weak          # perturbative 0.825
    assert _su3_violation(u) < 1e-5
    u = thermalize(torch.Generator().manual_seed(1), lat, beta=0.5, n_sweeps=60)
    p_strong = plaquette(u, lat)
    assert 0.005 < p_strong < 0.055, p_strong    # strong coupling 0.0278
    assert _su3_violation(u) < 1e-5


def test_heatbath_is_seeded_and_sweeps_keep_su3():
    lat = lattices((4, 4, 4, 4))[0]
    a = thermalize(torch.Generator().manual_seed(7), lat, 6.0, 3)
    b = thermalize(torch.Generator().manual_seed(7), lat, 6.0, 3)
    assert torch.equal(a, b) and a.dtype == torch.complex64
    c = heatbath_sweep(a, torch.Generator().manual_seed(8), 6.0, lat)
    assert not torch.equal(c, a) and _su3_violation(c) < 1e-5
    from tpuqcd import su3 as jsu3
    unit = su3.unit_gauge(lat)
    np.testing.assert_array_equal(unit.numpy(), np.asarray(jsu3.unit_gauge_dev(
        lattices((4, 4, 4, 4))[1])))
    assert plaquette(unit, lat) == pytest.approx(1.0, abs=1e-12)


def test_beta6_plaquette_matches_literature():
    """8^4 at beta = 6.0: within 0.01 of the large-volume 0.5937, as in
    test_heatbath.py:121-137.  Sweeps cut to fit the test budget: 40
    compound sweeps from a cold start (tpuqcd's test takes 150) and four
    measurements 10 sweeps apart; the plaquette settles within about 30
    compound sweeps at this volume."""
    lat = lattices((8, 8, 8, 8))[0]
    gen = torch.Generator().manual_seed(3)
    u = thermalize(gen, lat, 6.0, 40)
    ps = []
    for _ in range(4):
        ps.append(plaquette(u, lat))
        u = thermalize(gen, lat, 6.0, 10, u0=u)
    assert abs(np.mean(ps) - 0.5937) < 0.01, ps
    assert _su3_violation(u) < 1e-5


@pytest.mark.parametrize("antiperiodic_t", [True, False])
def test_setup_gauge_packing_matches_gauge_from_full_and_tpuqcd(antiperiodic_t):
    """setup_gauge's packed links, boundary phase in, exactly: the random
    gauge against utils/convert.gauge_from_full of the same draw, and
    the heatbath gauge against tpuqcd's packing of the same links."""
    lat, jlat = lattices((4, 4, 4, 4))

    def packed(**heatbath):
        cfg = config_from_dict({"gauge": {"dims": list(lat.dims), "random_seed": 5,
                                          "antiperiodic_t": antiperiodic_t, **heatbath},
                                "action": {"kappa": 0.12}})
        return setup_gauge(cfg, torch.device("cpu")).u_pk

    want = gauge_from_full(su3.random_gauge(lat, torch.Generator().manual_seed(5)), lat,
                           antiperiodic_t, torch.float32)
    assert torch.equal(packed(), want)
    got = packed(heatbath_beta=6.0, heatbath_sweeps=2)
    u_dev = thermalize(torch.Generator().manual_seed(5), lat, 6.0, 2)
    u_full = gauge_eo_to_full(gauge_from_device(u_dev, lat), lat).numpy()
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_gauge_pk(u_full, jlat, antiperiodic_t, jnp.float32)))
