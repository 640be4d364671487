"""The port's multigrid on a LatticeMesh (mg/shard.py: ShardedFineLevel and
its transfer, the replicated coarse level) on gloo ranks: twisted mass and
twisted clover, on (t) and (t, z) meshes, under both communication
policies; the (t, y) mesh is tests/test_torch_mg_mesh_y.py, the checks
tests/_torch_mg_mesh.py.

Every rank draws the null vectors' random starts whole from the same
generator and keeps its shard, so the sharded hierarchy is the one-rank
hierarchy up to the order of the sums.  References: the port's one-rank
MG from the same seed (x, inner iterations, coarse links); tpuqcd's
one-device solve_tm of the same system (jax.random and torch draw
different null vectors, so MG is held to tpuqcd through its certified
solution).  Both solves to 1e-12 agree to 1e-10.  Cost: about 120 s
serial (two torchrun launches, tpuqcd's two solves)."""
import pytest
import torch

from tpuqcd_torch.mg.dsolve import DeviceMG, DeviceMGParams
from tpuqcd_torch.mg.shard import ShardedFineLevel
from tpuqcd_torch.parallel.mesh import LatticeMesh
from tpuqcd_torch.utils.config import ConfigError, config_from_dict

from _torch_inputs import t
from _torch_mesh import KAPPA, LAT, MESHES, MU, inputs, run_worker
from _torch_mesh_worker import MG_PARAMS
from _torch_mg_mesh import (IDS, NAMES, check_builds_the_one_rank_hierarchy,
                            check_matches_one_rank, check_matches_tpuqcd_solution)

CASES = [("t", "fused"), ("tz", "overlap")]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
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


def test_one_rank_sharded_level_draws_what_one_card_draws():
    """On a one-rank mesh the sharded fine level applies and draws what the
    one-card level does, so the hierarchy's coarse links are the same."""
    from tpuqcd_torch.mg.device import DeviceFineLevel
    inp = inputs(True)
    u = t(inp["u"], torch.float32)
    lv = ShardedFineLevel.build(LatticeMesh(LAT, 1), u, KAPPA, MU)
    one = DeviceFineLevel(LAT, u, KAPPA, MU)
    v = torch.randn((2, 2, 4, 3, *LAT.site_shape), generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(lv.apply(v), one.apply(v), atol=0, rtol=0)
    torch.testing.assert_close(lv.apply_hop_all(v), one.apply_hop_all(v), atol=0, rtol=0)
    params = DeviceMGParams(**MG_PARAMS)
    a, b = DeviceMG(lv, params), DeviceMG(one, params)
    torch.testing.assert_close(a.levels[1].links_c, b.levels[1].links_c, atol=0, rtol=0)


@pytest.mark.parametrize("mesh,block", [({"nt": 2}, [8, 2, 2, 2]),
                                        ({"nt": 2, "nz": 2}, [2, 4, 2, 2]),
                                        ({"nt": 2, "ny": 2}, [2, 2, 4, 2])],
                         ids=["t", "z", "y"])
def test_a_block_straddling_a_shard_is_refused(mesh, block):
    raw = {"gauge": {"dims": [4, 4, 4, 8]}, "mesh": mesh,
           "mg": {"enabled": True, "n_vec": [4], "block": [block]}}
    with pytest.raises(ConfigError, match="aggregates must stay shard-local"):
        config_from_dict(raw)
    raw["mg"]["block"] = [[2, 2, 2, 2]]
    config_from_dict(raw)
