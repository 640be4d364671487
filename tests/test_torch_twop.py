"""The two-point slice of the port as a whole against tpuqcd, the HDF5
writer, the configuration and the scope checks.

The whole: one numpy gauge at 4x4x4x8 with the action and physics of
examples/twop.yaml through tpuqcd's functions (smeared_gauge,
smear_sources, twelve sequential solves per flavor, sink_smear_propagator,
the host oracles phys/contract.proton_2pt and meson_2pt) and through the
port's run_twop.measure on the CPU.  Correlators agree within rtol 1e-4
and atol 1e-6 of their largest value: float32 smearing and float32
propagators on both sides, solves certified to 1e-8."""
import glob
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd import gammas as jg
from tpuqcd.cli.common import make_solver as j_make_solver, smeared_gauge as j_smeared_gauge
from tpuqcd.fields import gauge_full_to_eo as j_gauge_full_to_eo
from tpuqcd.ops.layout import gauge_to_device as j_gauge_to_device
from tpuqcd.phys import contract as jcontract
from tpuqcd.phys import propagator as jprop
from tpuqcd.utils.config import load_config as j_load_config
from tpuqcd.utils.packed import pack_gauge as j_pack_gauge

from tpuqcd_torch.cli import run_twop
from tpuqcd_torch.cli.common import Gauge, Solver, check_in_slice, make_solver, smeared_gauge
from tpuqcd_torch.io import hdf5io
from tpuqcd_torch.ops.gauge_tools import plaquette
from tpuqcd_torch.utils.config import ConfigError, config_from_dict, load_config
from tpuqcd_torch.utils.packed import unpack_gauge

from _torch_inputs import gauge_full, jax_gauge_pk, lattices, n, t

ROOT = Path(__file__).resolve().parents[1]
LAT, JLAT = lattices((4, 4, 4, 8))
TAG = "sx0sy0sz0st0"


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(tpuqcd's correlators by dataset group, the port's TwopResult, cfg)."""
    out = str(tmp_path_factory.mktemp("twop") / "twop.h5")
    cfg = load_config(str(ROOT / "examples/twop.yaml"))
    jcfg = j_load_config(str(ROOT / "examples/twop.yaml"))
    assert tuple(cfg.gauge.dims) == LAT.dims
    u_full = gauge_full(LAT, 2)
    # --- tpuqcd: its own functions, sequential solves, host contractions
    u_dev = j_gauge_to_device(j_gauge_full_to_eo(jnp.asarray(u_full), JLAT), JLAT)
    u_dev = u_dev.astype(jnp.complex64)
    u_pk = jax_gauge_pk(u_full, JLAT, True, jnp.float32)
    u_sm = j_smeared_gauge(jcfg, JLAT, u_dev)
    solve = j_make_solver(jcfg, JLAT, u_pk, None)
    ph = jcfg.physics
    srcs = jprop.smear_sources(u_sm, jprop.point_sources(JLAT, (0, 0, 0, 0)), JLAT,
                               ph.smear_alpha_gauss, ph.smear_n_gauss)
    props = {}
    for name, flavor in (("u", +1), ("d", -1)):
        cols = jnp.stack([solve(srcs[s, c], flavor=flavor) for s in range(4) for c in range(3)])
        cols = cols.reshape(4, 3, *JLAT.full_shape, 4, 3)
        p = jnp.transpose(cols, (2, 3, 4, 5, 6, 7, 0, 1)).astype(jnp.complex64)
        props[name] = jprop.sink_smear_propagator(u_sm, p, JLAT, ph.smear_alpha_gauss,
                                                  ph.smear_n_gauss)
    mom = np.asarray(ph.momenta)
    ref = {f"twop/proton/P+/{TAG}": jcontract.proton_2pt(props["u"], props["d"], JLAT, mom),
           f"twop/neutron/P+/{TAG}": jcontract.proton_2pt(props["d"], props["u"], JLAT, mom)}
    for chan in ph.meson_channels:
        ref[f"twop/{chan}/{TAG}"] = jcontract.meson_2pt(props["u"], props["u"],
                                                         jg.MESON_CHANNELS[chan], JLAT, mom)
    # --- the port: the same gauge through run_twop.measure on the CPU
    tu = t(jax_gauge_pk(u_full, JLAT, True, jnp.float32))
    gauge = Gauge(LAT, tu, plaquette(unpack_gauge(t(j_pack_gauge(u_dev))), LAT), 0.0)
    import dataclasses
    cfg = dataclasses.replace(cfg, physics=dataclasses.replace(cfg.physics, output=out))
    res = run_twop.measure(cfg, torch.device("cpu"), gauge, keep_fields=True)
    return {k: np.asarray(v) for k, v in ref.items()}, res, cfg


def test_correlators_match_tpuqcd(both):
    ref, res, _ = both
    assert sorted(res.correlators) == sorted(ref)
    for group, want in ref.items():
        got = res.correlators[group]
        assert got.shape == want.shape == (2, LAT.Lt) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * np.abs(want).max(),
                                   err_msg=group)
    pion = res.correlators[f"twop/pion/{TAG}"][0]
    assert pion.real.min() > 0 and np.abs(pion.imag).max() <= 1e-6 * pion.real.max()


def test_every_column_is_certified_and_timed(both):
    _, res, cfg = both
    assert sum(r["columns"] for r in res.solves) == 24
    assert all(max(r["relres"]) <= cfg.solver.tol for r in res.solves)
    # rhs_batch 12 with the gate: a probe column, then the other 11, per flavor
    assert [(r["flavor"], r["first_column"], r["columns"]) for r in res.solves] == [
        (1, 0, 1), (1, 1, 11), (-1, 0, 1), (-1, 1, 11)]
    assert res.solves[0]["gate_rechunked"] is False and res.solves[0]["probe"]
    assert set(res.seconds) == {"gauge", "smearing", "sources", "solves_u", "solves_d",
                                "sink_smearing", "contractions", "projection"}
    assert res.fields[TAG]["b"].shape == (12, 2, 2, 4, 3, *LAT.site_shape)
    assert res.solves[1]["x_first"].dtype == torch.float64


def test_write_twop_datasets_and_round_trip(both):
    h5py = pytest.importorskip("h5py")
    _, res, cfg = both
    run_twop.write(cfg, res)
    with h5py.File(cfg.physics.output, "r") as f:
        names = []
        f.visititems(lambda k, v: names.append(k) if isinstance(v, h5py.Dataset) else None)
        attrs = dict(f[f"twop/proton/P+/{TAG}"].attrs)
    want = [f"{g}/mom_{p[0]}_{p[1]}_{p[2]}" for g in res.correlators for p in res.momenta]
    assert sorted(names) == sorted(want)
    assert list(attrs["src_pos"]) == [0, 0, 0, 0] and attrs["kappa"] == cfg.action.kappa
    for group, corr in res.correlators.items():
        np.testing.assert_array_equal(
            hdf5io.read_dataset(cfg.physics.output, f"{group}/mom_1_0_0"), corr[1])
    # writing again replaces the datasets
    hdf5io.write_twop(cfg.physics.output, "twop/pion/" + TAG, np.zeros((2, LAT.Lt)),
                      res.momenta, (0, 0, 0, 0))
    assert not hdf5io.read_dataset(cfg.physics.output, f"twop/pion/{TAG}/mom_0_0_0").any()


def test_missing_h5py_raises_an_import_error(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_h5py(name, *a, **k):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="h5py package"):
        hdf5io.write_twop("x.h5", "g", np.zeros((1, 2)), np.zeros((1, 3), int), (0, 0, 0, 0))


def test_run_twop_cli_cpu(tmp_path, monkeypatch):
    pytest.importorskip("h5py")
    monkeypatch.chdir(tmp_path)
    run_twop.main(["--config", str(ROOT / "examples/twop.yaml"), "--device", "cpu"])
    pion = hdf5io.read_dataset("twop_demo.h5", f"twop/pion/{TAG}/mom_0_0_0")
    assert pion.shape == (8,) and pion.real.min() > 0
    for group in ("twop/proton/P+", "twop/neutron/P+", "twop/rho_x", "twop/rho_y", "twop/rho_z"):
        assert hdf5io.read_dataset("twop_demo.h5", f"{group}/{TAG}/mom_1_0_0").shape == (8,)


@pytest.mark.parametrize("path", sorted(glob.glob(str(ROOT / "examples/twop*.yaml"))),
                         ids=lambda p: Path(p).name)
def test_every_twop_example_loads_as_in_tpuqcd(path):
    cfg, jcfg = load_config(path), j_load_config(path)
    for key in ("source_positions", "momenta", "projectors", "meson_channels", "smear_type",
                "smear_alpha_ape", "smear_n_ape", "smear_alpha_gauss", "smear_n_gauss", "output"):
        assert getattr(cfg.physics, key) == getattr(jcfg.physics, key), key
    for key in ("rhs_batch", "rhs_batch_gate_iters", "rhs_batch_gate_chunk", "tol"):
        assert getattr(cfg.solver, key) == getattr(jcfg.solver, key), key


def test_physics_validation_and_momentum_generation():
    cfg = config_from_dict({"physics": {"mom_max_sq": 2}})
    assert len(cfg.physics.momenta) == 19 and (1, 1, 0) in cfg.physics.momenta
    for bad in ({"physics": {"meson_channels": ["eta"]}}, {"physics": {"projectors": ["P0"]}},
                {"physics": {"smear_type": "hyp"}}, {"solver": {"rhs_batch": 0}},
                {"physics": {"source_positions": [[99, 0, 0, 0]]}},
                {"physics": {"momenta": [[1, 0]]}},
                {"physics": {"mom_max_sq": 1, "momenta": [[0, 0, 0]]}}):
        with pytest.raises(ConfigError):
            config_from_dict(bad)


@pytest.mark.parametrize("raw,match", [
    ({"solver": {"solver": "eigcg"}}, "eigcg"),
    ({"mesh": {"nt": 2}}, "mesh"),
    ({"gauge": {"config_file": "conf.1000"}}, "ILDG"),
    ({"gauge": {"random_seeds": [1, 2]}}, "ensemble"),
])
def test_make_solver_refuses_what_is_not_ported(raw, match):
    cfg = config_from_dict(raw)
    if match == "eigcg":     # in the slice since the loop run came: one eigCG solver a flavor
        check_in_slice(cfg)
        assert make_solver(cfg, LAT, torch.zeros(1)).eigcg == {}
        return
    if match in ("ILDG", "ensemble"):   # in the slice since the gauge input came
        check_in_slice(cfg)
        assert isinstance(make_solver(cfg, LAT, torch.zeros(1)), Solver)
        return
    if match == "mesh":   # every program takes a mesh since the loop run came to it
        check_in_slice(cfg)
        check_in_slice(config_from_dict({**raw, "physics": {"t_sinks": [2]}}), threep=True)
        # the solver takes the mesh and asks for its ranks (tests/test_torch_twop_mesh.py
        # runs them under torchrun)
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_solver(cfg, LAT, torch.zeros(1))
        return
    with pytest.raises(NotImplementedError, match=match):
        check_in_slice(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_solver(cfg, LAT, torch.zeros(1))
    with pytest.raises(NotImplementedError, match="doublet"):
        make_solver(config_from_dict({"action": {"epsbar": 0.1, "mubar": 0.2}}), LAT,
                    torch.zeros(1))


def test_solver_gate_rechunks_and_mg_branch_batches():
    """A gate of one matvec sends the other columns through in chunks of
    rhs_batch_gate_chunk; the MG branch solves chunks of rhs_batch in
    lockstep and builds a flavor's hierarchy when first asked."""
    u = t(jax_gauge_pk(gauge_full(LAT, 2), JLAT, True, jnp.float32))
    b = t(np.random.default_rng(3).standard_normal(
        (5, 2, 2, 4, 3, *LAT.site_shape)).astype(np.float32))
    cfg = config_from_dict({"gauge": {"dims": list(LAT.dims)}, "solver": {
        "tol": 1e-8, "rhs_batch": 4, "rhs_batch_gate_iters": 1, "rhs_batch_gate_chunk": 2}})
    solve = make_solver(cfg, LAT, u)
    assert isinstance(solve, Solver) and solve.lmesh is None
    xs = solve.packed_src_batch(b)
    assert xs.shape == b.shape and xs.dtype == torch.float32
    assert [(r["first_column"], r["columns"]) for r in solve.records] == [(0, 1), (1, 2), (3, 2)]
    assert solve.records[0]["gate_rechunked"] is True
    one = solve.packed_src(b[3])
    assert (xs[3] - one).abs().max().item() <= 1e-6 * one.abs().max().item()
    mg_cfg = config_from_dict({"gauge": {"dims": list(LAT.dims)}, "action": {"kappa": 0.15, "mu": 0.1},
                               "solver": {"tol": 1e-8, "inner_tol": 1e-4, "rhs_batch": 2},
                               "mg": {"enabled": True, "n_vec": [4], "block": [[2, 2, 2, 2]],
                                      "setup_iters": 20}})
    mg_solve = make_solver(mg_cfg, LAT, u)
    xs = mg_solve.packed_src_batch(b[:3], flavor=-1)
    assert [(r["first_column"], r["columns"]) for r in mg_solve.records] == [(0, 2), (2, 1)]
    assert all(max(r["relres"]) <= 1e-8 for r in mg_solve.records)
    assert list(mg_solve.mg.hierarchies) == [-1] and xs.shape == b[:3].shape


def test_smeared_gauge_takes_the_phase_off_and_picks_the_smearing():
    u_full = gauge_full(LAT, 2)
    u = t(jax_gauge_pk(u_full, JLAT, True, jnp.float32))
    plain = t(jax_gauge_pk(u_full, JLAT, False, jnp.float32))
    none = config_from_dict({"physics": {"smear_n_ape": 0}})
    np.testing.assert_array_equal(n(smeared_gauge(none, LAT, u)), n(plain))
    ape = smeared_gauge(config_from_dict({"physics": {"smear_n_ape": 1}}), LAT, u)
    stout = smeared_gauge(config_from_dict({"physics": {"smear_n_ape": 1,
                                                        "smear_type": "stout"}}), LAT, u)
    assert ape.shape == stout.shape == u.shape and not torch.equal(ape, stout)
    np.testing.assert_array_equal(n(ape[3]), n(plain[3]))       # t links untouched
