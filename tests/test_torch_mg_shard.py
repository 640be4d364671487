"""The sharded multigrid without a launch: on a one-rank mesh the sharded
fine level (mg/shard.ShardedFineLevel) applies and draws what the one-card
level does, and the configuration refuses an aggregate that straddles a
shard (the gloo-mesh runs: tests/test_torch_mg_mesh.py, _tz.py, _y.py).
Cost: about 5 s serial."""
import pytest
import torch

from tpuqcd_torch.mg.dsolve import DeviceMG, DeviceMGParams
from tpuqcd_torch.mg.shard import ShardedFineLevel
from tpuqcd_torch.parallel.mesh import LatticeMesh
from tpuqcd_torch.utils.config import ConfigError, config_from_dict

from _torch_inputs import t
from _torch_mesh import KAPPA, LAT, MU, inputs
from _torch_mesh_worker import MG_PARAMS


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
