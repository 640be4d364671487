"""Landau and Coulomb gauge fixing of the port against tpuqcd's, and the
configuration checks of the gauge-input keys.

ops/gauge_fix.gauge_fix runs on the same complex128 gauge in both
packages (complex128: the overrelaxation amplifies float32 rounding, as
the heatbath's does), Landau until |dF| < 2e-3 (10 sweeps) and Coulomb
for its cap of 12 sweeps, so both pass a reprojection: the functional
after every sweep agrees to 1e-12 and the links to 1e-12.  setup_gauge
with gauge.fix reads one ILDG file in both packages and fixes its
complex64 links for 5 sweeps: the packed float32 links agree to 1e-5
(float32 rounding grown by the sweeps; 4.6e-6 measured), tpuqcd's call of
apply_boundary_phase patched to apply the configured phase (ROADMAP.md,
Queue 3).
The plaquette is unchanged by the fix.  About 35 s serial, nearly all
of it tpuqcd's eager sweeps."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd.cli.common import setup_gauge as j_setup_gauge
from tpuqcd.fields import gauge_full_to_eo as j_gauge_full_to_eo
from tpuqcd.io.lime import write_ildg_gauge as j_write_ildg_gauge
from tpuqcd.ops.gauge_fix import gauge_fix as j_gauge_fix
from tpuqcd.ops.layout import gauge_to_device as j_gauge_to_device
from tpuqcd.utils.config import load_config as j_load_config

from tpuqcd_torch.cli.common import setup_gauge
from tpuqcd_torch.fields import apply_boundary_phase, gauge_full_to_eo
from tpuqcd_torch.ops.gauge_fix import functional, gauge_fix
from tpuqcd_torch.ops.gauge_tools import plaquette
from tpuqcd_torch.ops.layout import gauge_to_device
from tpuqcd_torch.utils.config import ConfigError, config_from_dict, load_config
from tpuqcd_torch.utils.packed import unpack_gauge

from _torch_inputs import gauge_full, lattices, n, tpuqcd_setup_gauge_phase_as_configured

LAT, JLAT = lattices((4, 4, 4, 8))


def j_config_from_dict(raw: dict, tmp_path):
    """tpuqcd's RunConfig of ``raw``, through a YAML file as it loads them."""
    import yaml
    path = tmp_path / "j.yaml"
    path.write_text(yaml.safe_dump(raw))
    return j_load_config(str(path))


def _port_dev(u_full):
    return gauge_to_device(gauge_full_to_eo(torch.from_numpy(u_full), LAT), LAT)


@pytest.mark.parametrize("gauge,n_sweeps,tol,sweeps", [("landau", 12, 2e-3, 10),
                                                        ("coulomb", 12, 1e-9, 12)])
def test_gauge_fix_matches_tpuqcd_in_complex128(gauge, n_sweeps, tol, sweeps):
    u_full = gauge_full(LAT, 3)
    ju, jhist = j_gauge_fix(j_gauge_to_device(j_gauge_full_to_eo(jnp.asarray(u_full), JLAT),
                                              JLAT),
                            JLAT, gauge=gauge, n_sweeps=n_sweeps, tol=tol)
    u0 = _port_dev(u_full)
    keep = u0.clone()
    u, hist = gauge_fix(u0, LAT, gauge=gauge, n_sweeps=n_sweeps, tol=tol)
    assert torch.equal(u0, keep)                    # the input is not touched
    assert len(hist) == len(jhist) == sweeps
    np.testing.assert_allclose(hist, jhist, atol=1e-12, rtol=0)
    assert u.dtype == torch.complex128 and u.shape == u0.shape
    np.testing.assert_allclose(n(u), np.asarray(ju), atol=1e-12, rtol=0)
    # the functional rose; the plaquette, gauge invariant, did not move
    assert hist[-1] > functional(u0, LAT, gauge) + 0.1
    assert functional(u, LAT, gauge) == pytest.approx(hist[-1], abs=1e-12)
    assert plaquette(u, LAT) == pytest.approx(plaquette(u0, LAT), abs=1e-12)
    # the links stay in SU(3)
    m = u.permute(0, 1, 4, 5, 6, 2, 3).reshape(-1, 3, 3)
    eye = torch.eye(3, dtype=m.dtype).expand_as(m)
    assert (m @ m.mH - eye).abs().max().item() < 1e-12
    assert (torch.linalg.det(m) - 1).abs().max().item() < 1e-12


def test_gauge_fix_stops_when_the_functional_settles():
    u0 = _port_dev(gauge_full(LAT, 4))
    _, one = gauge_fix(u0, LAT, gauge="coulomb", n_sweeps=50, tol=1.0)
    _, capped = gauge_fix(u0, LAT, gauge="coulomb", n_sweeps=3, tol=1e-30)
    assert len(one) == 1 and len(capped) == 3 and capped[0] == one[0]
    with pytest.raises(ValueError, match="landau or coulomb"):
        gauge_fix(u0, LAT, gauge="axial")


@pytest.mark.parametrize("fix", ["landau", "coulomb"])
def test_setup_gauge_fix_matches_tpuqcds_setup_gauge(tmp_path, monkeypatch, fix):
    """The same ILDG file, fixed in setup_gauge by both packages (complex64
    links, 5 sweeps): the packed links with the boundary phase agree."""
    tpuqcd_setup_gauge_phase_as_configured(monkeypatch)
    path = str(tmp_path / "conf.lime")
    j_write_ildg_gauge(path, gauge_full(LAT, 5), JLAT)
    raw = {"gauge": {"dims": list(LAT.dims), "config_file": path, "fix": fix,
                     "fix_sweeps": 5}}
    _, _, j_u_pk, _ = j_setup_gauge(j_config_from_dict(raw, tmp_path))
    detail = {}
    g = setup_gauge(config_from_dict(raw), torch.device("cpu"), detail)
    assert g.u_pk.dtype == torch.float32
    np.testing.assert_allclose(n(g.u_pk), np.asarray(j_u_pk), atol=1e-5, rtol=0)
    assert detail["fix_sweeps"] == len(detail["fix_history"]) == 5
    assert detail["fix_history"][-1] > detail["fix_initial"]
    assert set(detail) >= {"take", "read", "checksum", "decode", "fix_seconds"}
    # gauge invariant: the fixed links' plaquette is the file's
    u_dev = apply_boundary_phase(unpack_gauge(g.u_pk), LAT, "device", True)
    assert plaquette(u_dev, LAT) == pytest.approx(g.plaquette, abs=1e-5)   # float32 links
    unfixed = setup_gauge(config_from_dict({"gauge": {**raw["gauge"], "fix": ""}}),
                          torch.device("cpu"))
    assert unfixed.plaquette == g.plaquette and not torch.equal(unfixed.u_pk, g.u_pk)


def test_config_rejects_bad_gauge_fix(tmp_path):
    cfgp = tmp_path / "bad.yaml"
    cfgp.write_text("gauge: {dims: [4, 4, 4, 8], fix: axial}\n")
    with pytest.raises(ConfigError, match="gauge.fix"):
        load_config(str(cfgp))
    cfgp.write_text("gauge: {dims: [4, 4, 4, 8], fix: coulomb, fix_sweeps: 7, "
                    "fix_tol: 1.0e-6}\n")
    g = load_config(str(cfgp)).gauge
    assert (g.fix, g.fix_sweeps, g.fix_tol) == ("coulomb", 7, 1e-6)


@pytest.mark.parametrize("gauge,match", [
    ({"config_files": ["a.lime"], "random_seeds": [1]}, "exclusive ensemble modes"),
    ({"config_file": "a.lime", "config_files": ["b.lime"]}, "single-config mode"),
    ({"config_file": "a.lime", "random_seeds": [1, 2]}, "single-config mode"),
    ({"heatbath_beta": 6.0, "heatbath_n_cfg": 2, "heatbath_skip": 0}, "heatbath_skip"),
    ({"heatbath_beta": 6.0, "heatbath_n_cfg": 2, "random_seeds": [1]}, "one Markov chain"),
    ({"heatbath_beta": 6.0, "config_files": ["a.lime"]}, "exclusive with config_file"),
], ids=["files-seeds", "file-files", "file-seeds", "skip", "chain-seeds", "beta-files"])
def test_validate_config_refuses_what_tpuqcd_refuses(tmp_path, gauge, match):
    raw = {"gauge": {"dims": [4, 4, 4, 8], **gauge}}
    with pytest.raises(ConfigError, match=match):
        config_from_dict(raw)
    with pytest.raises(ValueError):                  # tpuqcd's ConfigError too
        j_config_from_dict(raw, tmp_path)


def test_every_gauge_key_of_tpuqcd_is_parsed():
    from tpuqcd.utils.config import GaugeParams as JGaugeParams

    from tpuqcd_torch.utils.config import GaugeParams
    names = [f.name for f in dataclasses.fields(JGaugeParams)]
    assert names == [f.name for f in dataclasses.fields(GaugeParams)]
    assert GaugeParams() == GaugeParams(**{k: getattr(JGaugeParams(), k) for k in names})


def test_tpuqcds_setup_gauge_drops_the_phase_the_port_applies(tmp_path, monkeypatch):
    """tpuqcd's setup_gauge hands antiperiodic_t to apply_boundary_phase's
    eo parameter (ROADMAP.md, Queue 3): at Lz < Lt its links carry no phase.
    The port's carry the configured one, and equal tpuqcd's exactly once
    tpuqcd's call is patched to the intended one."""
    path = str(tmp_path / "conf.lime")
    j_write_ildg_gauge(path, gauge_full(LAT, 6), JLAT)
    raw = {"gauge": {"dims": list(LAT.dims), "config_file": path}}
    port = n(setup_gauge(config_from_dict(raw), torch.device("cpu")).u_pk)
    _, _, unpatched, _ = j_setup_gauge(j_config_from_dict(raw, tmp_path))
    unpatched = np.asarray(unpatched)
    last_t = (3, Ellipsis, LAT.Lt - 1, slice(None), slice(None))
    np.testing.assert_array_equal(unpatched[last_t], -port[last_t])
    np.testing.assert_array_equal(np.delete(unpatched, LAT.Lt - 1, axis=5),
                                  np.delete(port, LAT.Lt - 1, axis=5))
    tpuqcd_setup_gauge_phase_as_configured(monkeypatch)
    _, _, patched, _ = j_setup_gauge(j_config_from_dict(raw, tmp_path))
    np.testing.assert_array_equal(np.asarray(patched), port)
