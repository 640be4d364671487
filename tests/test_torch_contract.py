"""The port's hadron contractions and momentum projections against
tpuqcd on shared float32 propagators.

tpuqcd's device engine (phys/contract_dev.py) unrolls the Wick sums into
real plane products; the port contracts the same factored form with
complex einsums.  Tolerances: densities and correlators 1e-5 of the
reference's largest value (float32 products summed in another order);
the momentum projection of a given density 1e-6 (the port sums in
complex128); the contraction tables equal tpuqcd's entry for entry."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd import gammas as jg
from tpuqcd.phys import contract as jcontract
from tpuqcd.phys import contract_dev as jdev
from tpuqcd.phys import threep_dev as jthreep

from tpuqcd_torch import gammas as tg
from tpuqcd_torch.phys import contract_dev as tdev
from tpuqcd_torch.phys.contract_dev import (density_to_full, meson_2pt_dev, meson_2pt_site_dev,
                                            neutron_2pt_dev, prop_to_device, proton_2pt_dev,
                                            proton_2pt_site_dev)
from tpuqcd_torch.phys.threep_dev import (momentum_phases_pk, project_all_momenta_fft_pk,
                                          project_momenta_pk)

from _torch_inputs import lattices, n, t

LAT, JLAT = lattices((4, 4, 6, 8))
MOMENTA = np.array([[0, 0, 0], [1, 0, 0], [0, -1, 1], [2, 1, -1]])
SRC = (3, 1, 2, 1)                       # (t0, z0, y0, x0)


def _props():
    """Two random packed float32 propagators [2ri, 2par, 4, 3, 4, 3, T, Z, S]."""
    rng = np.random.default_rng(5)
    shape = (2, 2, 4, 3, 4, 3, *LAT.site_shape)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("name", ["CMAT", "CGAMMA5", "PARITY_PLUS", "PARITY_MINUS", "EPS3",
                                  "GAMMA_T", "ID4"])
def test_contraction_tables_equal_tpuqcd(name):
    np.testing.assert_array_equal(getattr(tg, name).numpy(), getattr(jg, name))


@pytest.mark.parametrize("table", ["PROJECTORS", "MESON_CHANNELS"])
def test_named_tables_equal_tpuqcd(table):
    mine, theirs = getattr(tg, table), getattr(jg, table)
    assert sorted(mine) == sorted(theirs)
    for key in theirs:
        np.testing.assert_array_equal(mine[key].numpy(), theirs[key], err_msg=key)
    np.testing.assert_array_equal(tg.gbar(tg.CGAMMA5).numpy(), jdev._gbar(jg.CGAMMA5))


@pytest.mark.parametrize("pname", sorted(jg.PROJECTORS))
def test_proton_density_matches_tpuqcd_for_every_projector(pname):
    su, sd = _props()
    ref = jdev.proton_2pt_site_dev(jnp.asarray(su), jnp.asarray(sd), jg.PROJECTORS[pname])
    got = proton_2pt_site_dev(t(su), t(sd), tg.PROJECTORS[pname])
    assert got.shape == (2, 2, *LAT.site_shape) and got.dtype == torch.float32
    _close(n(got), ref)


@pytest.mark.parametrize("chan", sorted(jg.MESON_CHANNELS))
def test_meson_density_matches_tpuqcd_for_every_channel(chan):
    s1, s2 = _props()
    ref = jdev.meson_2pt_site_dev(jnp.asarray(s1), jnp.asarray(s2), jg.MESON_CHANNELS[chan])
    _close(n(meson_2pt_site_dev(t(s1), t(s2), tg.MESON_CHANNELS[chan])), ref)


def test_chunked_contraction_equals_one_chunk(monkeypatch):
    su, sd = _props()
    whole = proton_2pt_site_dev(t(su), t(sd))
    monkeypatch.setattr(tdev, "SITE_CHUNK", 100)        # does not divide the site count
    np.testing.assert_allclose(n(proton_2pt_site_dev(t(su), t(sd))), n(whole), atol=1e-4,
                               rtol=1e-5)
    pion = meson_2pt_site_dev(t(su), t(su), tg.MESON_CHANNELS["pion"])
    assert n(pion[0]).min() > 0 and np.abs(n(pion[1])).max() <= 1e-4 * n(pion[0]).max()


def test_correlators_match_tpuqcd_device_engine_and_host_oracle():
    su, sd = _props()
    ref = jdev.proton_2pt_dev(jnp.asarray(su), jnp.asarray(sd), JLAT, MOMENTA, src_pos=SRC)
    got = proton_2pt_dev(t(su), t(sd), LAT, MOMENTA, src_pos=SRC)
    assert got.shape == (len(MOMENTA), LAT.Lt) and got.dtype == torch.complex128
    _close(n(got), ref)
    _close(n(neutron_2pt_dev(t(su), t(sd), LAT, MOMENTA, src_pos=SRC)),
           jdev.neutron_2pt_dev(jnp.asarray(su), jnp.asarray(sd), JLAT, MOMENTA, src_pos=SRC))
    g = jg.MESON_CHANNELS["rho_y"]
    _close(n(meson_2pt_dev(t(su), t(sd), tg.MESON_CHANNELS["rho_y"], LAT, MOMENTA, src_pos=SRC)),
           jdev.meson_2pt_dev(jnp.asarray(su), jnp.asarray(sd), g, JLAT, MOMENTA, src_pos=SRC))
    # the host oracle on the full-layout propagators (tpuqcd/phys/contract.py)
    fu, fd = (_to_full(p) for p in (su, sd))
    oracle = jcontract.proton_2pt(jnp.asarray(fu), jnp.asarray(fd), JLAT, MOMENTA, src_pos=SRC)
    _close(n(got), oracle, tol=2e-5)


def _to_full(prop_pk: np.ndarray) -> np.ndarray:
    """Packed device propagator -> complex [T, Z, Y, X, 4, 3, 4, 3], by
    inverting the port's prop_to_device on a complex128 probe."""
    c = prop_pk[0] + 1j * prop_pk[1]                            # [2par, 4, 3, 4, 3, T, Z, S]
    from tpuqcd_torch.fields import eo_to_full
    eo = t(c).reshape(2, 4, 3, 4, 3, LAT.Lt, LAT.Lz, LAT.Ly, LAT.Lx // 2)
    eo = torch.movedim(eo, (1, 2, 3, 4), (5, 6, 7, 8))
    return n(eo_to_full(eo, LAT))


def test_prop_to_device_matches_tpuqcd_and_round_trips():
    su, _ = _props()
    full = _to_full(su)
    ref = jdev.prop_to_device(jnp.asarray(full), JLAT)
    got = prop_to_device(t(full), LAT)
    np.testing.assert_array_equal(n(got), np.asarray(ref))
    np.testing.assert_array_equal(n(got), su)
    dens = np.random.default_rng(6).standard_normal((2, 2, *LAT.site_shape)).astype(np.float32)
    np.testing.assert_array_equal(n(density_to_full(t(dens), LAT)),
                                  jdev.density_to_full(jnp.asarray(dens), JLAT))


def test_momentum_projection_by_phases_and_by_fft():
    dens = np.random.default_rng(7).standard_normal((2, 2, *LAT.site_shape)).astype(np.float32)
    src = (SRC[3], SRC[2], SRC[1])                      # (x0, y0, z0)
    ref = jthreep.project_momenta_pk(jnp.asarray(dens), JLAT, MOMENTA, src)
    by_phases = project_momenta_pk(t(dens), LAT, MOMENTA, src)
    by_fft = project_momenta_pk(t(dens), LAT, MOMENTA, src, fft=True)
    _close(n(by_phases), ref, tol=1e-6)
    np.testing.assert_allclose(n(by_fft), n(by_phases), atol=1e-10 * np.abs(ref).max())
    np.testing.assert_allclose(n(momentum_phases_pk(LAT, MOMENTA, src)),
                               jthreep.momentum_phases_pk(JLAT, MOMENTA, src), atol=1e-6)
    grid = n(project_all_momenta_fft_pk(t(dens), LAT, src))
    _close(grid, jthreep.project_all_momenta_fft_pk(jnp.asarray(dens), JLAT, src), tol=1e-6)
    for i, (px, py, pz) in enumerate(MOMENTA):
        np.testing.assert_allclose(grid[:, pz % LAT.Lz, py % LAT.Ly, px % LAT.Lx],
                                   n(by_phases[i]), atol=1e-10 * np.abs(ref).max())
    # a long momentum list takes the FFT by default, and agrees with tpuqcd's
    many = np.array([(a, b, c) for a in range(-2, 2) for b in range(-1, 2) for c in range(3)])
    assert len(many) >= 32
    _close(n(project_momenta_pk(t(dens), LAT, many, src)),
           jthreep.project_momenta_pk(jnp.asarray(dens), JLAT, many, src), tol=1e-5)
