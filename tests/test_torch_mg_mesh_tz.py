"""The sharded multigrid of tests/test_torch_mg_mesh.py on the (t, z) mesh:
four gloo ranks under the overlap policy, twisted mass and twisted
clover and the bfloat16 solver buffers (task "mgbf"), the same checks
(tests/_torch_mg_mesh.py), in a file of its own (one torchrun launch a
file, so that --dist loadfile spreads the meshes over workers).  Cost:
about 75 s serial (one torchrun launch, tpuqcd's two solves)."""
import pytest

from _torch_mesh import MESHES, inputs, run_worker
from _torch_mg_mesh import (IDS, NAMES, check_bf16_buffers_match_one_rank,
                            check_builds_the_one_rank_hierarchy, check_matches_one_rank,
                            check_matches_tpuqcd_solution)


@pytest.fixture(scope="module", params=[("tz", "overlap")], ids=lambda c: f"{c[0]}-{c[1]}")
def ranks(request, tmp_path_factory):
    mesh, policy = request.param
    return run_worker(tmp_path_factory.mktemp(f"mg{mesh}"), inputs(True), MESHES[mesh], policy,
                      ["mg", "mgbf"])


@pytest.mark.parametrize("name", NAMES, ids=IDS)
def test_sharded_mg_matches_one_rank(ranks, name):
    check_matches_one_rank(ranks, name)


@pytest.mark.parametrize("name", NAMES, ids=IDS)
def test_sharded_mg_builds_the_one_rank_hierarchy(ranks, name):
    check_builds_the_one_rank_hierarchy(ranks, name)


@pytest.mark.parametrize("name", NAMES, ids=IDS)
def test_sharded_mg_matches_tpuqcd_solution(ranks, name):
    check_matches_tpuqcd_solution(ranks, name)


def test_sharded_bf16_buffers_match_one_rank(ranks):
    check_bf16_buffers_match_one_rank(ranks)
