"""The port's eigCG on the (t) mesh of gloo ranks under the fused
policy: the worker's three columns in sequence held by the tests of
tests/_torch_eigcg_mesh.py (which describes them), one torchrun launch
in this file; and on a one-rank mesh against the one-card run.
Cost: about 60 s serial."""
import numpy as np
import pytest

from tpuqcd_torch.parallel.mesh import LatticeMesh
from tpuqcd_torch.solve import ShardedEigCGSolver

from _torch_inputs import n, t
from _torch_eigcg_mesh import (_one_card, ranks_of,  # noqa: F401
                               test_sharded_eigcg_matches_one_card,
                               test_sharded_eigcg_matches_tpuqcd)
from _torch_mesh import KAPPA, LAT, MU, inputs


@pytest.fixture(scope="module", params=["t"], ids=lambda m: f"{m}-fused")
def ranks(request, tmp_path_factory):
    return ranks_of(request.param, tmp_path_factory)


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
