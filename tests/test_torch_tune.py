"""utils/tune.tune_comm_policy and the operands cli/common hands it (the
counterpart of tests/test_tune.py): on two gloo ranks a miss times both
policies on every rank, the slowest rank's time decides and rank 0 alone
stores the winner; a hit reads rank 0's entry and broadcasts it, whatever
the other ranks' caches hold, and times nothing.  In one process: the
cache's key and entry, and the operators the tuner times, named by the
cache tag.  Cost: about 20 s serial (two torchrun launches)."""
import json
import time

import numpy as np
import pytest
import torch

from tpuqcd_torch.cli.common import _tuning
from tpuqcd_torch.lattice import Lattice
from tpuqcd_torch.parallel.dist import local_shard
from tpuqcd_torch.parallel.mesh import LatticeMesh
from tpuqcd_torch.parallel.sharded import (ShardedTMCloverOperatorPC, ShardedTMOperatorPC,
                                           clover_fields_to, extend_gauge)
from tpuqcd_torch.solve import make_clover_fields
from tpuqcd_torch.utils import tune
from tpuqcd_torch.utils.config import config_from_dict

from _torch_inputs import t
from _torch_mesh import KAPPA, LAT, MU, inputs, torchrun
from _torch_tune_worker import DIMS


def _key(mesh="2x1x1", tag="test"):
    return f"comm_policy/{Lattice(DIMS).dims}/{mesh}/{tag}/cpu"


def _ranks(tmp_path):
    torchrun(2, "tests/_torch_tune_worker.py", "--cache-root", str(tmp_path), "--out",
             str(tmp_path))
    return [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in (0, 1)]


def test_two_ranks_take_the_slowest_ranks_winner_and_rank_0s_cache(tmp_path):
    miss = _ranks(tmp_path)
    assert [m["winner"] for m in miss] == ["overlap", "overlap"]
    for m in miss:     # one warm-up and two rounds of NITER each
        assert m["calls"] == dict.fromkeys(tune.POLICIES, 1 + 2 * tune.NITER)
    entry = json.loads((tmp_path / "rank0" / "torch_tunecache.json").read_text())[_key()]
    assert entry["policy"] == "overlap"
    us = entry["us_per_apply"]
    assert us["fused"] >= 30e3 and 10e3 <= us["overlap"] < us["fused"]
    assert not (tmp_path / "rank1" / "torch_tunecache.json").exists()
    # rank 1's own cache says fused: rank 0's entry is broadcast, nothing is timed
    (tmp_path / "rank1").mkdir()
    (tmp_path / "rank1" / "torch_tunecache.json").write_text(
        json.dumps({_key(): {"policy": "fused"}}))
    hit = _ranks(tmp_path)
    assert [h["winner"] for h in hit] == ["overlap", "overlap"]
    assert [h["calls"] for h in hit] == [dict.fromkeys(tune.POLICIES, 0)] * 2


def test_one_process_times_on_a_miss_and_reads_on_a_hit(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUQCD_RESOURCE_PATH", str(tmp_path))
    lat = Lattice(DIMS)
    lmesh = LatticeMesh(lat, 1)
    calls = dict.fromkeys(tune.POLICIES, 0)

    def fns(slow):
        def make(p):
            def fn(b):
                calls[p] += 1
                if p == slow:
                    time.sleep(0.002)
                return b
            return fn
        return {p: make(p) for p in tune.POLICIES}
    b = torch.zeros(1)
    assert tune.tune_comm_policy(lat, lmesh, fns("fused"), b, tag="op") == "overlap"
    assert calls == dict.fromkeys(tune.POLICIES, 1 + 2 * tune.NITER)
    cache = json.loads((tmp_path / "torch_tunecache.json").read_text())
    assert cache[_key("1x1x1", "op")]["policy"] == "overlap"
    assert tune.tune_comm_policy(lat, lmesh, fns("overlap"), b, tag="op") == "overlap"
    assert calls == dict.fromkeys(tune.POLICIES, 1 + 2 * tune.NITER)


@pytest.mark.parametrize("csw", [0.0, 1.2], ids=["tm", "clover"])
def test_tuner_times_the_operator_its_tag_names(csw):
    """_tuning's operands are the action's sloppy operator (twisted clover
    with action.csw) under each policy, tagged by it; on a one-rank mesh
    both policies apply what the operator does."""
    cfg = config_from_dict({"gauge": {"dims": list(LAT.dims)},
                            "action": {"kappa": KAPPA, "mu": MU, "csw": csw}})
    lmesh = LatticeMesh(LAT, 1)
    u = t(inputs(True)["u"], torch.float32)
    ug = extend_gauge(lmesh, local_shard(u.double(), lmesh))
    fns, b, tag = _tuning(cfg, lmesh, lambda: ug, u)()
    assert tag == ("clover" if csw else "tm") and b.dtype == torch.float32
    psi = torch.from_numpy(np.random.default_rng(5).standard_normal(tuple(b.shape))).float()
    kw = dict(kappa=KAPPA, mu=MU, t_boundary=-1, lmesh=lmesh)
    if csw:
        cl = make_clover_fields(u, LAT, kappa=KAPPA, mu=MU, csw=csw)
        want = ShardedTMCloverOperatorPC(LAT, **kw).apply(
            clover_fields_to((ug, *cl), torch.float32, rows=2), psi)
    else:
        want = ShardedTMOperatorPC(LAT, **kw).apply(ug.to(torch.float32, rows=2), psi)
    for p in tune.POLICIES:
        torch.testing.assert_close(fns[p](psi), want, atol=0, rtol=0)
