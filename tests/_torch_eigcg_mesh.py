"""The port's eigCG on a LatticeMesh (solve.ShardedEigCGSolver: eigCG's
float64 dots, its Rayleigh-Ritz step and the space's absorb summed over
the ranks, the deflation basis sharded) on gloo ranks: three columns in
sequence, on (t), (t, z) and (t, y) meshes: test_torch_eigcg_mesh.py,
_tz.py and _ty.py, one torchrun launch a file (so that --dist loadfile
spreads them over workers), with the tests defined here.

References: the port's one-card EigCGSolver and tpuqcd's one-device
EigCGSolver on the same numpy columns.  Solves to 1e-12 agree to 1e-10;
the iterations and the space's size of the sharded run are those of the
one-card run (the sums differ in order only)."""
import functools

import jax.numpy as jnp
import numpy as np

from tpuqcd.solve import EigCGSolver as JEigCG

from tpuqcd_torch.solve import EigCGSolver

from _torch_inputs import n, t
from _torch_mesh import JLAT, KAPPA, LAT, MESHES, MU, inputs, run_worker

#: each file's mesh and policy
CASES = {"t": "fused", "tz": "overlap", "ty": "overlap"}


def ranks_of(mesh: str, tmp_path_factory) -> dict:
    """The worker's eigCG task on MESHES[mesh] under its policy."""
    return run_worker(tmp_path_factory.mktemp(f"eig{mesh}"), inputs(True), MESHES[mesh],
                      CASES[mesh], ["eigcg"])


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
