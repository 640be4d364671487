"""The sharded multigrid of tests/test_torch_mg_mesh.py on the (t, y) mesh:
four gloo ranks, the overlap engine (the only policy of a y-sharded
mesh), the same checks (tests/_torch_mg_mesh.py), in a file of its own so
that each file stays near two minutes serial.  Cost: about 90 s serial
(one torchrun launch, tpuqcd's two solves)."""
import pytest

from _torch_mesh import MESHES, inputs, run_worker
from _torch_mg_mesh import (IDS, NAMES, check_builds_the_one_rank_hierarchy,
                            check_matches_one_rank, check_matches_tpuqcd_solution)


@pytest.fixture(scope="module", params=[("ty", "overlap")], ids=lambda c: f"{c[0]}-{c[1]}")
def ranks(request, tmp_path_factory):
    mesh, policy = request.param
    return run_worker(tmp_path_factory.mktemp(f"mg{mesh}"), inputs(True), MESHES[mesh], policy,
                      ["mg"])


@pytest.mark.parametrize("name", NAMES, ids=IDS)
def test_sharded_mg_matches_one_rank(ranks, name):
    check_matches_one_rank(ranks, name)


@pytest.mark.parametrize("name", NAMES, ids=IDS)
def test_sharded_mg_builds_the_one_rank_hierarchy(ranks, name):
    check_builds_the_one_rank_hierarchy(ranks, name)


@pytest.mark.parametrize("name", NAMES, ids=IDS)
def test_sharded_mg_matches_tpuqcd_solution(ranks, name):
    check_matches_tpuqcd_solution(ranks, name)
