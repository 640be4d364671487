"""The port's multigrid on a LatticeMesh (mg/shard.py: ShardedFineLevel and
its transfer, the replicated coarse level) on gloo ranks: twisted mass and
twisted clover, here on the (t) mesh under the fused policy; the (t, z)
mesh under overlap is tests/test_torch_mg_mesh_tz.py, the (t, y) mesh
test_torch_mg_mesh_y.py (one torchrun launch a file), the checks
tests/_torch_mg_mesh.py; the one-rank sharded level and the config gate
on shard-local aggregates, test_torch_mg_shard.py.

Every rank draws the null vectors' random starts whole from the same
generator and keeps its shard, so the sharded hierarchy is the one-rank
hierarchy up to the order of the sums.  References: the port's one-rank
MG from the same seed (x, inner iterations, coarse links); tpuqcd's
one-device solve_tm of the same system (jax.random and torch draw
different null vectors, so MG is held to tpuqcd through its certified
solution).  Both solves to 1e-12 agree to 1e-10.  The same launches run
the twisted-mass MG with bfloat16 solver buffers (mg.gcr_dtype and
vec_dtype, task "mgbf") against its one-rank twin.  Cost: about 75 s
serial (one torchrun launch, tpuqcd's two solves; the bfloat16 task
about 5 s of the launch)."""
import pytest

from _torch_mesh import MESHES, inputs, run_worker
from _torch_mg_mesh import (IDS, NAMES, check_bf16_buffers_match_one_rank,
                            check_builds_the_one_rank_hierarchy, check_matches_one_rank,
                            check_matches_tpuqcd_solution)


@pytest.fixture(scope="module", params=[("t", "fused")], ids=lambda c: f"{c[0]}-{c[1]}")
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
