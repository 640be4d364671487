"""The port's eigCG on a LatticeMesh (solve.ShardedEigCGSolver: eigCG's
float64 dots, its Rayleigh-Ritz step and the space's absorb summed over
the ranks, the deflation basis sharded) on gloo ranks: three columns in
sequence, on (t), (t, z) and (t, y) meshes.

References: the port's one-card EigCGSolver and tpuqcd's one-device
EigCGSolver on the same numpy columns.  Solves to 1e-12 agree to 1e-10;
the iterations and the space's size of the sharded run are those of the
one-card run (the sums differ in order only).  Cost: about 50 s serial."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd.solve import EigCGSolver as JEigCG

from tpuqcd_torch.parallel.mesh import LatticeMesh
from tpuqcd_torch.solve import EigCGSolver, ShardedEigCGSolver

from _torch_inputs import n, t
from _torch_mesh import JLAT, KAPPA, LAT, MESHES, MU, inputs, run_worker

CASES = [("t", "fused"), ("tz", "overlap"), ("ty", "overlap")]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def ranks(request, tmp_path_factory):
    mesh, policy = request.param
    return run_worker(tmp_path_factory.mktemp(f"eig{mesh}"), inputs(True), MESHES[mesh], policy,
                      ["eigcg"])


@functools.lru_cache(maxsize=None)
def _one_card():
    inp = inputs(True)
    es = EigCGSolver(t(inp["u"]), LAT, kappa=KAPPA, mu=MU)
    runs = [es.solve(c, tol=1e-12) for c in t(inp["cols"])]
    return [n(r.x) for r in runs], [r.iters for r in runs], es.space.k


@functools.lru_cache(maxsize=None)
def _tpuqcd():
    inp = inputs(True)
    es = JEigCG(jnp.asarray(inp["u"]), JLAT, kappa=KAPPA, mu=MU, backend="xla")
    return [np.asarray(es.solve(jnp.asarray(c), tol=1e-12).x) for c in inp["cols"]]


def test_sharded_eigcg_matches_one_card(ranks):
    xs, iters, k = _one_card()
    assert (ranks["eig_relres"] <= 1e-12).all()
    for i, x in enumerate(xs):
        np.testing.assert_allclose(ranks["eig_x"][i], x, atol=1e-10, rtol=0)
    assert list(ranks["eig_iters"]) == iters
    assert ranks["eig_space"][-1] == k


def test_sharded_eigcg_matches_tpuqcd(ranks):
    for i, x in enumerate(_tpuqcd()):
        np.testing.assert_allclose(ranks["eig_x"][i], x, atol=1e-10, rtol=0)


def test_one_rank_sharded_eigcg_is_the_one_card_run():
    """On a one-rank mesh (the halo kernel with the shard's own faces)
    every column's x, count and the space equal the one-card run's."""
    inp = inputs(True)
    es = ShardedEigCGSolver(t(inp["u"]), LAT, LatticeMesh(LAT, 1), kappa=KAPPA, mu=MU)
    xs, iters, k = _one_card()
    for i, c in enumerate(t(inp["cols"])):
        res = es.solve(c, tol=1e-12)
        np.testing.assert_array_equal(n(res.x), xs[i])
        assert res.iters == iters[i]
    assert es.space.k == k
