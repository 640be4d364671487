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
solution).  Both solves to 1e-12 agree to 1e-10.  The same launches run
the twisted-mass MG with bfloat16 solver buffers (mg.gcr_dtype and
vec_dtype, task "mgbf") against its one-rank twin.  Cost: about 130 s
serial (two torchrun launches, tpuqcd's two solves; the bfloat16 task
about 5 s of each launch)."""
import functools

import numpy as np
import pytest
import torch

from tpuqcd_torch.mg.dsolve import DeviceMG, DeviceMGParams
from tpuqcd_torch.mg.shard import ShardedFineLevel
from tpuqcd_torch.parallel.mesh import LatticeMesh
from tpuqcd_torch.utils.config import ConfigError, config_from_dict

from _torch_inputs import n, t
from _torch_mesh import KAPPA, LAT, MESHES, MU, inputs, run_worker
from _torch_mesh_worker import MG_PARAMS, MGBF_PARAMS, mg_solve
from _torch_mg_mesh import (IDS, NAMES, check_builds_the_one_rank_hierarchy,
                            check_matches_one_rank, check_matches_tpuqcd_solution)

CASES = [("t", "fused"), ("tz", "overlap")]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
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


@functools.lru_cache(maxsize=None)
def one_rank_bf16():
    """The one-rank MG with bfloat16 buffers: (x, inner iterations, links)."""
    inp = inputs(True)
    x, relres, iters, (links,) = mg_solve(LatticeMesh(LAT, 1), t(inp["u"], torch.float32),
                                          None, KAPPA, MU, t(inp["b"]), "fused",
                                          params=MGBF_PARAMS)
    assert relres <= 1e-12
    return n(x), iters, n(torch.view_as_real(links).double())


def test_sharded_bf16_buffers_match_one_rank(ranks):
    """The bfloat16 GCR basis and null-vector bank on the ranks: the same
    inner iterations as the one-rank hierarchy from the same seed, x within
    1e-10 (both certified to 1e-12), and the replicated coarse links within
    1e-3 of their largest value.  The ranks round the same null vectors to
    bfloat16 (their float32 values summed over the ranks in another order,
    1e-7 apart); where one falls on the other side of a rounding midpoint,
    an element moves by a bfloat16 ulp (2^-8 of itself), which float32
    summation order's 3e-5 does not cover."""
    x, iters, want = one_rank_bf16()
    assert ranks["mgbf_relres"] <= 1e-12
    assert ranks["mgbf_iters"] == iters
    np.testing.assert_allclose(ranks["mgbf_x"], x, atol=1e-10, rtol=0)
    scale = np.abs(want).max()
    np.testing.assert_allclose(ranks["mgbf_links"] / scale, want / scale, atol=1e-3, rtol=0)


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
