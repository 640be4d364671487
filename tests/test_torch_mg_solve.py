"""The port's MG solve against tpuqcd on the CPU: a hierarchy set up by
tpuqcd and dumped with its save_device_mg is loaded into the port
(utils/checkpoint.load_device_mg), so both packages run the same null
vectors, Linv and Galerkin links.  On it: one V-cycle against tpuqcd's
precondition, the certified solve against tpuqcd's, the port's own
setup (its own generator), the dumps in both directions, the CLI and the
MG configuration.

Tolerances, on |port - tpuqcd| / |tpuqcd|: 1e-4 for a V-cycle with the
float32 smoother (float32 sums in another order, through a 12-step
coarse GCR); 1e-2 with the bfloat16 smoother (about 2 bfloat16 ulp),
whose MR steps round every field update to bfloat16 where XLA may keep
intermediates in float32; 1e-6 for certified solutions (both within
1e-10 of the same system)."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd.mg import device as jdevice
from tpuqcd.mg.dsolve import DeviceMGParams as JParams
from tpuqcd.utils import checkpoint as jcheckpoint
from tpuqcd.utils.config import MGParamsCfg as JMGParamsCfg, MG_PRESETS as J_MG_PRESETS

from tpuqcd_torch.cli import run_invert
from tpuqcd_torch.cli.common import MGSolver, check_in_slice, mg_params
from tpuqcd_torch.mg.device import DeviceFineLevel
from tpuqcd_torch.mg.dsolve import DeviceMG, DeviceMGParams
from tpuqcd_torch.solve import solve_tm_mg
from tpuqcd_torch.utils.checkpoint import load_device_mg, save_device_mg
from tpuqcd_torch.utils.config import (ConfigError, MGParamsCfg, MG_PRESETS, config_from_dict,
                                       load_config)

from _torch_inputs import gauge_full, jax_gauge_pk, lattices, n, t

LAT, JLAT = lattices((4, 4, 4, 8))
KAPPA, MU = 0.15, 0.1
ROOT = Path(__file__).resolve().parents[1]
PARAMS = dict(n_vec=(4,), block=((2, 2, 2, 2),), setup_iters=20, smoother_iters=3,
              coarse_iters=12, restart=6)


def _gauge():
    return jax_gauge_pk(gauge_full(LAT, 0), JLAT, True, jnp.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _source(seed=41):
    return np.random.default_rng(seed).standard_normal(
        (2, 2, 4, 3, *LAT.site_shape)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_hierarchy(tmp_path_factory):
    """tpuqcd's hierarchy on the shared gauge, and its npz dump."""
    from tpuqcd.mg.dsolve import DeviceMG as JDeviceMG
    jl = jdevice.DeviceFineLevel(JLAT, _gauge(), KAPPA, MU, backend="xla")
    jmg = JDeviceMG(jl, JParams(**PARAMS))
    path = str(tmp_path_factory.mktemp("mg") / "jax_mg.npz")
    jcheckpoint.save_device_mg(path, jmg)
    return jmg, path


def _port_fine(u=None):
    return DeviceFineLevel(LAT, t(_gauge() if u is None else u), KAPPA, MU)


def test_vcycle_matches_tpuqcd_on_a_loaded_hierarchy(jax_hierarchy):
    jmg, path = jax_hierarchy
    mg = load_device_mg(path, _port_fine(), DeviceMGParams(**PARAMS))
    assert mg.sloppy_fine is None and len(mg.levels) == 2
    np.testing.assert_array_equal(n(mg.levels[1].links_pk()), np.asarray(jmg.levels[1].links))
    b = _source()
    assert _rel(n(mg.precondition(t(b))), jmg.precondition(jnp.asarray(b))) <= 1e-4


def test_vcycle_bf16_smoother_matches_tpuqcd(jax_hierarchy):
    """tpuqcd's bfloat16 smoother needs its Pallas fine level (interpret
    mode here); the port's runs the kernel's bfloat16 storage."""
    _, path = jax_hierarchy
    params = dict(PARAMS, smoother_dtype="bfloat16")
    jl = jdevice.DeviceFineLevel(JLAT, _gauge(), KAPPA, MU, backend="pallas", interpret=True)
    jmg = jcheckpoint.load_device_mg(path, jl, JParams(**params))
    mg = load_device_mg(path, _port_fine(), DeviceMGParams(**params))
    assert mg.sloppy_fine.u12.dtype == torch.bfloat16
    b = _source(42)
    got = mg.precondition(t(b))
    assert got.dtype == torch.float32
    assert _rel(n(got), jmg.precondition(jnp.asarray(b))) <= 1e-2


def test_certified_solve_matches_tpuqcd(jax_hierarchy):
    jmg, path = jax_hierarchy
    mg = load_device_mg(path, _port_fine(), DeviceMGParams(**PARAMS))
    b = _source(43)
    res = mg.solve_certified(t(b), tol=1e-10, inner_tol=1e-4, max_refine=20)
    assert res.relres <= 1e-10 and res.x.dtype == torch.float64 and res.refinements >= 2
    x_j, rel_j, _ = jmg.solve_certified(jnp.asarray(b), tol=1e-10, inner_tol=1e-4,
                                        max_refine=20)
    assert rel_j <= 1e-10
    assert _rel(n(res.x), x_j) <= 1e-6
    # tpuqcd's float64 operator certifies the port's solution independently
    r = jnp.asarray(b, jnp.float64) - jmg.levels[0].as_hp().apply(jnp.asarray(n(res.x)))
    assert float(jnp.linalg.norm(r) / jnp.linalg.norm(jnp.asarray(b, jnp.float64))) <= 1e-10


@pytest.mark.parametrize("setup_solver", ["bicgstab", "cgne"])
def test_port_setup_certifies(setup_solver):
    gen = torch.Generator().manual_seed(11)
    mg = DeviceMG(_port_fine(), DeviceMGParams(**PARAMS, setup_solver=setup_solver),
                  generator=gen)
    assert set(mg.setup_seconds) == {"nulls0", "galerkin0"}
    b = _source(44)
    res = mg.solve_certified(t(b), tol=1e-10, inner_tol=1e-4, max_refine=20)
    assert res.relres <= 1e-10
    jl = jdevice.DeviceFineLevel(JLAT, _gauge(), KAPPA, MU, backend="xla")
    r = jnp.asarray(b, jnp.float64) - jl.as_hp().apply(jnp.asarray(n(res.x)))
    assert float(jnp.linalg.norm(r) / jnp.linalg.norm(jnp.asarray(b, jnp.float64))) <= 1e-10


def test_dumps_round_trip_between_the_packages(jax_hierarchy, tmp_path):
    jmg, path = jax_hierarchy
    mg = load_device_mg(path, _port_fine(), DeviceMGParams(**PARAMS))
    out = str(tmp_path / "port_mg.npz")
    save_device_mg(out, mg)
    z_j, z_t = np.load(path), np.load(out)
    assert sorted(z_j.files) == sorted(z_t.files)
    for key in z_j.files:
        np.testing.assert_allclose(z_t[key], z_j[key], atol=1e-6, rtol=0, err_msg=key)
    # the port's dump loads into tpuqcd and preconditions as its own
    jl = jdevice.DeviceFineLevel(JLAT, _gauge(), KAPPA, MU, backend="xla")
    back = jcheckpoint.load_device_mg(out, jl, JParams(**PARAMS))
    b = jnp.asarray(_source(45))
    assert _rel(back.precondition(b), jmg.precondition(b)) <= 1e-5


def test_bf16_links_in_a_dump_are_read_as_bf16(jax_hierarchy, tmp_path):
    """tpuqcd dumps bfloat16 coarse links (coarse_dtype bfloat16) as
    2-byte void arrays; the port reads the bfloat16 bits."""
    import dataclasses
    jmg, _ = jax_hierarchy
    jmg16 = type(jmg).__new__(type(jmg))
    jmg16.transfers = jmg.transfers
    jmg16.levels = [jmg.levels[0]] + [dataclasses.replace(lv, links=lv.links.astype(jnp.bfloat16))
                                      for lv in jmg.levels[1:]]
    path = str(tmp_path / "bf16.npz")
    jcheckpoint.save_device_mg(path, jmg16)
    assert np.load(path)["c0_links"].dtype.kind == "V"
    mg = load_device_mg(path, _port_fine(), DeviceMGParams(**PARAMS))
    want = np.asarray(jmg16.levels[1].links.astype(jnp.float32))
    np.testing.assert_array_equal(n(mg.levels[1].links_pk()), want)


def test_solve_tm_mg_parity_first_layout():
    mg = DeviceMG(_port_fine(), DeviceMGParams(**PARAMS), generator=torch.Generator().manual_seed(3))
    b = t(np.random.default_rng(46).standard_normal((2, 2, 4, 3, *LAT.site_shape)))
    res = solve_tm_mg(mg, b, tol=1e-10, inner_tol=1e-4)
    assert res.relres <= 1e-10 and res.x.shape == b.shape and res.x.dtype == torch.float64
    # the same solution as the ri-first solve of the transposed source
    again = mg.solve_certified(b.float().transpose(0, 1).contiguous(), tol=1e-10, inner_tol=1e-4)
    torch.testing.assert_close(res.x, again.x.transpose(0, 1), atol=0, rtol=0)
    with pytest.raises(NotImplementedError, match="float64"):
        mg.solve_certified(b[0].float(), hp="df64")


def test_run_invert_mg_cli_cpu(capsys):
    run_invert.main(["--config", str(ROOT / "examples/invert_mg.yaml"), "--device", "cpu"])
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("RESULT ")]
    assert len(line) == 1
    fields = dict(kv.split("=", 1) for kv in re.findall(r"\w+=\S+", line[0]))
    assert float(fields["relres"]) <= 1e-10 and float(fields["solve_seconds"]) > 0


def test_mg_solver_builds_a_flavor_on_first_use_and_dumps(tmp_path):
    cfg = config_from_dict({"gauge": {"dims": [4, 4, 4, 8], "random_seed": 1},
                            "action": {"kappa": 0.12, "mu": 0.03},
                            "mg": {"enabled": True, "n_vec": [4], "block": [[2, 2, 2, 2]],
                                   "setup_iters": 10,
                                   "vec_outfile": str(tmp_path / "h")}})
    from tpuqcd_torch.cli.common import setup_gauge, random_source
    lat, u_pk, _, _ = setup_gauge(cfg, torch.device("cpu"))
    solver = MGSolver(cfg, lat, u_pk)
    assert solver.hierarchies == {}
    b = random_source(lat, torch.device("cpu"))
    res = solver(b, -1)
    assert list(solver.hierarchies) == [-1] and res.relres <= 1e-10
    assert (tmp_path / "h.f-1.npz").exists() and not (tmp_path / "h.f+1.npz").exists()
    cfg_in = config_from_dict({**{"gauge": {"dims": [4, 4, 4, 8], "random_seed": 1},
                                  "action": {"kappa": 0.12, "mu": 0.03}},
                               "mg": {"enabled": True, "n_vec": [4], "block": [[2, 2, 2, 2]],
                                      "vec_infile": str(tmp_path / "h")}})
    loaded = MGSolver(cfg_in, lat, u_pk)
    again = loaded(b, -1)
    torch.testing.assert_close(again.x, res.x, atol=0, rtol=0)


@pytest.mark.parametrize("raw", [
    # the sharded multigrid, twisted mass and clover, is in every program's slice; its
    # vector files stay single-card, as in tpuqcd
    {"mg": {"enabled": True}, "action": {"csw": 1.0}, "mesh": {"nt": 2}},
    {"mg": {"enabled": True}, "mesh": {"nt": 2}},
    {"gauge": {"heatbath_beta": 6.0, "heatbath_n_cfg": 2}},
], ids=["mg-csw", "mg-mesh", "heatbath_n_cfg"])
def test_unported_mg_configurations_raise(raw):
    raw = {**raw, "gauge": {"dims": [8, 8, 8, 8], **raw.get("gauge", {})}}
    if "heatbath_n_cfg" in raw["gauge"]:
        # the heatbath chain is in the slice since the gauge input came; with MG on a
        # mesh it is run_invert's, not the physics programs'
        check_in_slice(config_from_dict(raw))
        raw = {**raw, "mg": {"enabled": True}, "mesh": {"nt": 2}}
    cfg = config_from_dict(raw)
    check_in_slice(cfg)
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.parallel.mesh import LatticeMesh
    lat = Lattice(tuple(raw["gauge"]["dims"]))
    files = config_from_dict({**raw, "mg": {**raw["mg"], "vec_outfile": "h"}})
    with pytest.raises(NotImplementedError, match="single-card"):
        MGSolver(files, lat, torch.zeros(1), LatticeMesh(lat, 2))


def test_mg_config_mirrors_tpuqcd():
    import dataclasses
    names = {f.name for f in dataclasses.fields(MGParamsCfg)}
    assert names == {f.name for f in dataclasses.fields(JMGParamsCfg)}
    assert MG_PRESETS == J_MG_PRESETS
    cfg = load_config(str(ROOT / "examples/invert_mg_heatbath.yaml"))
    assert cfg.mg.setup_solver == "cgne" and cfg.mg.restart == 24 and cfg.gauge.heatbath_sweeps == 200
    p = mg_params(cfg)
    near = DeviceMGParams.near_critical()
    for f in ("n_vec", "block", "setup_iters", "smoother_iters", "coarse_iters", "restart",
              "mu_factor", "smoother_dtype", "setup_solver", "coarse_dtype"):
        assert getattr(p, f) == getattr(near, f), f
    assert dataclasses.asdict(near) == dataclasses.asdict(JParams.near_critical())
    check_in_slice(cfg)
    # explicit keys win over the preset
    raw = {"gauge": {"dims": [8, 8, 8, 8]}, "mg": {"enabled": True, "preset": "near_critical",
                                                    "restart": 8}}
    assert config_from_dict(raw).mg.restart == 8
    # {"n_vec": [4, 4]} is a ConfigError only because block keeps one entry: n_vec
    # and block need one entry a coarsening (three levels: tests/test_torch_mg3.py)
    for bad in ({"preset": "nope"}, {"n_vec": [4, 4]}, {"block": [[3, 2, 2, 2]]},
                {"block": [[2, 2, 2, 3]]}, {"smoother_dtype": "half"},
                {"setup_solver": "gmres"}):
        with pytest.raises(ConfigError):
            config_from_dict({"gauge": {"dims": [8, 8, 8, 8]}, "mg": {"enabled": True, **bad}})
