"""The three-level hierarchy (two n_vec entries) against tpuqcd on the CPU,
at 8^4 with blocks 2^4 and 2^4 (levels 8^4 -> 4^4 -> 2^4): a hierarchy
set up by tpuqcd and dumped with its save_device_mg is loaded into the
port (both coarse levels and both transfers), and on it the port's V-cycle
with the float32 and the bfloat16 smoother and its certified solve are held
to tpuqcd's; then the port's own three-level setup, the coarsest-level mu
boost and bfloat16 rounding, the memory sum of a batch, and the
examples/invert_mg3_24cube.yaml configuration in both packages.

Tolerances as tests/test_torch_mg_solve.py's: 1e-4 for a float32 V-cycle,
1e-2 with the bfloat16 smoother, 1e-6 for certified solutions.  Cost:
about 60 s serial, most of it tpuqcd's setup (built once) and its bfloat16
smoother in Pallas interpret mode."""
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd.mg import device as jdevice
from tpuqcd.mg.dsolve import DeviceMG as JDeviceMG, DeviceMGParams as JParams
from tpuqcd.utils import checkpoint as jcheckpoint
from tpuqcd.utils.config import load_config as j_load_config

from tpuqcd_torch.cli.common import check_in_slice, mg_params
from tpuqcd_torch.mg.device import DeviceFineLevel
from tpuqcd_torch.mg.dsolve import DeviceMG, DeviceMGParams
from tpuqcd_torch.utils.checkpoint import load_device_mg
from tpuqcd_torch.utils.config import load_config

from _torch_inputs import gauge_full, jax_gauge_pk, lattices, n, t

LAT, JLAT = lattices((8, 8, 8, 8))
KAPPA, MU = 0.15, 0.1
ROOT = Path(__file__).resolve().parents[1]
PARAMS = dict(n_vec=(4, 4), block=((2, 2, 2, 2), (2, 2, 2, 2)), setup_iters=10,
              smoother_iters=3, coarse_iters=12, restart=6)


def _gauge():
    return jax_gauge_pk(gauge_full(LAT, 70), JLAT, True, jnp.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _source(seed):
    return np.random.default_rng(seed).standard_normal(
        (2, 2, 4, 3, *LAT.site_shape)).astype(np.float32)


def _port_fine():
    return DeviceFineLevel(LAT, t(_gauge()), KAPPA, MU)


@pytest.fixture(scope="module")
def jax_hierarchy(tmp_path_factory):
    """tpuqcd's three-level hierarchy on the shared gauge, and its npz dump."""
    jl = jdevice.DeviceFineLevel(JLAT, _gauge(), KAPPA, MU, backend="xla")
    jmg = JDeviceMG(jl, JParams(**PARAMS))
    path = str(tmp_path_factory.mktemp("mg3") / "jax_mg3.npz")
    jcheckpoint.save_device_mg(path, jmg)
    return jmg, path


def test_three_level_vcycle_matches_tpuqcd_on_a_loaded_hierarchy(jax_hierarchy):
    jmg, path = jax_hierarchy
    mg = load_device_mg(path, _port_fine(), DeviceMGParams(**PARAMS))
    assert [lv.dims for lv in mg.levels[1:]] == [(4, 4, 4, 4), (2, 2, 2, 2)]
    assert [tr.n_vec for tr in mg.transfers] == [4, 4] and mg.levels[2].n == 8
    for got, want in zip(mg.levels[1:], jmg.levels[1:]):
        np.testing.assert_array_equal(n(got.links_pk()), np.asarray(want.links))
    b = _source(71)
    assert _rel(n(mg.precondition(t(b))), jmg.precondition(jnp.asarray(b))) <= 1e-4


def test_three_level_vcycle_bf16_smoother_matches_tpuqcd(jax_hierarchy):
    """The bfloat16 smoother on the fine level; the coarse levels smooth in
    float32 (tpuqcd's Pallas fine level in interpret mode)."""
    _, path = jax_hierarchy
    params = dict(PARAMS, smoother_dtype="bfloat16")
    jl = jdevice.DeviceFineLevel(JLAT, _gauge(), KAPPA, MU, backend="pallas", interpret=True)
    jmg = jcheckpoint.load_device_mg(path, jl, JParams(**params))
    mg = load_device_mg(path, _port_fine(), DeviceMGParams(**params))
    assert mg.sloppy_fine.u12.dtype == torch.bfloat16
    b = _source(72)
    got = mg.precondition(t(b))
    assert got.dtype == torch.float32
    assert _rel(n(got), jmg.precondition(jnp.asarray(b))) <= 1e-2


def test_three_level_certified_solve_matches_tpuqcd(jax_hierarchy):
    jmg, path = jax_hierarchy
    mg = load_device_mg(path, _port_fine(), DeviceMGParams(**PARAMS))
    b = _source(73)
    res = mg.solve_certified(t(b), tol=1e-10, inner_tol=1e-4, max_refine=20)
    assert res.relres <= 1e-10 and res.x.dtype == torch.float64
    x_j, rel_j, _ = jmg.solve_certified(jnp.asarray(b), tol=1e-10, inner_tol=1e-4,
                                        max_refine=20)
    assert rel_j <= 1e-10
    assert _rel(n(res.x), x_j) <= 1e-6
    r = jnp.asarray(b, jnp.float64) - jmg.levels[0].as_hp().apply(jnp.asarray(n(res.x)))
    assert float(jnp.linalg.norm(r) / jnp.linalg.norm(jnp.asarray(b, jnp.float64))) <= 1e-10


@pytest.mark.parametrize("dtypes", [("float32", "float32"), ("bfloat16", "bfloat16")],
                         ids=["f32", "bf16"])
def test_port_three_level_setup_certifies(dtypes):
    """A fresh three-level hierarchy from the port's own generator: every
    stage timed, every coarse level rounded to bfloat16 with coarse_dtype,
    and a solve certified to 1e-10 (also by tpuqcd's float64 operator)."""
    smoother, coarse = dtypes
    mg = DeviceMG(_port_fine(), DeviceMGParams(**PARAMS, smoother_dtype=smoother,
                                               coarse_dtype=coarse),
                  generator=torch.Generator().manual_seed(12))
    assert set(mg.setup_seconds) == {"nulls0", "galerkin0", "nulls1", "galerkin1"}
    for lv in mg.levels[1:]:
        lc = torch.view_as_real(lv.links_c)
        assert torch.equal(lc, lc.to(torch.bfloat16).float()) == (coarse == "bfloat16")
    b = _source(74)
    res = mg.solve_certified(t(b), tol=1e-10, inner_tol=1e-4, max_refine=20)
    assert res.relres <= 1e-10
    jl = jdevice.DeviceFineLevel(JLAT, _gauge(), KAPPA, MU, backend="xla")
    r = jnp.asarray(b, jnp.float64) - jl.as_hp().apply(jnp.asarray(n(res.x)))
    assert float(jnp.linalg.norm(r) / jnp.linalg.norm(jnp.asarray(b, jnp.float64))) <= 1e-10
    # two columns in lockstep, each certified
    batch = mg.solve_certified_batch(torch.stack([t(b), t(_source(75))]), tol=1e-10,
                                     inner_tol=1e-4)
    assert max(batch.relres) <= 1e-10


def test_mu_boost_lands_on_the_coarsest_level_only():
    """mu_factor adds i delta g5_c to the coarsest level's diagonal, delta =
    2 kappa mu (mu_factor - 1); the middle level keeps the Galerkin links."""
    kw = dict(PARAMS, setup_iters=4)
    plain = DeviceMG(_port_fine(), DeviceMGParams(**kw, mu_factor=1.0),
                     generator=torch.Generator().manual_seed(13))
    boosted = DeviceMG(_port_fine(), DeviceMGParams(**kw, mu_factor=6.0),
                       generator=torch.Generator().manual_seed(13))
    assert torch.equal(plain.levels[1].links_c, boosted.levels[1].links_c)
    delta = 2.0 * KAPPA * MU * 5.0
    torch.testing.assert_close(boosted.levels[2].links_c,
                               plain.levels[2].boosted(delta).links_c, atol=0, rtol=0)
    assert not torch.equal(plain.levels[2].links_c, boosted.levels[2].links_c)


def test_batch_bytes_count_every_level():
    """The memory a lockstep batch holds sums the fine level's fields and
    every coarse level's."""
    mg2 = DeviceMG(_port_fine(), DeviceMGParams(**dict(PARAMS, n_vec=(4,),
                                                       block=((2, 2, 2, 2),), setup_iters=2)),
                   generator=torch.Generator().manual_seed(14))
    mg3 = DeviceMG(_port_fine(), DeviceMGParams(**dict(PARAMS, setup_iters=2)),
                   generator=torch.Generator().manual_seed(14))
    restart = PARAMS["restart"]
    coarse = [4 * 2 * lv.n * lv.Vc for lv in mg3.levels[1:]]
    fine = 4 * 2 * 2 * 12 * LAT.half_volume

    def per_columns(mg):                      # what 3 columns add to the once terms
        return mg.batch_bytes(3) - mg.batch_bytes(0)
    assert per_columns(mg3) == 3 * ((2 * restart + 16) * fine
                                    + (2 * restart + 23) * sum(coarse))
    assert per_columns(mg2) == 3 * ((2 * restart + 16) * fine + (2 * restart + 23) * coarse[0])


def test_mg3_example_parses_to_near_critical_levels_3_in_both_packages():
    """examples/invert_mg3_24cube.yaml: the near_critical preset with a
    second 2^4 coarsening, read by both packages into the same parameters
    as DeviceMGParams.near_critical(levels=3)."""
    path = str(ROOT / "examples/invert_mg3_24cube.yaml")
    cfg, jcfg = load_config(path), j_load_config(path)
    check_in_slice(cfg)
    assert dataclasses.asdict(cfg.mg) == dataclasses.asdict(jcfg.mg)
    p = mg_params(cfg)
    jm = jcfg.mg
    # tpuqcd/cli/common.py:386-397, its config -> DeviceMGParams
    jp = JParams(n_vec=tuple(jm.n_vec), block=tuple(jm.block), setup_iters=jm.setup_iters,
                 smoother_iters=jm.smoother_iters, coarse_iters=jm.coarse_maxiter,
                 restart=jm.restart, mu_factor=jm.mu_factor, setup_solver=jm.setup_solver,
                 smoother_dtype=jm.smoother_dtype, coarse_dtype=jm.coarse_dtype,
                 gcr_dtype=jm.gcr_dtype, vec_dtype=jm.vec_dtype)
    near = DeviceMGParams.near_critical(levels=3)
    assert dataclasses.asdict(near) == dataclasses.asdict(JParams.near_critical(levels=3))
    for f in ("n_vec", "block", "setup_iters", "smoother_iters", "coarse_iters", "restart",
              "mu_factor", "smoother_dtype", "setup_solver", "coarse_dtype"):
        assert getattr(p, f) == getattr(near, f) == getattr(jp, f), f
    assert p.n_vec == (16, 16) and p.block == ((4, 4, 4, 4), (2, 2, 2, 2))
    assert cfg.gauge.dims == (24, 24, 24, 48) and cfg.solver.inner_tol == near.inner_tol
