"""One gloo rank of utils/tune.tune_comm_policy, for tests/test_torch_tune.py.
It imports tpuqcd_torch only:

    python -m torch.distributed.run --nproc_per_node 2 tests/_torch_tune_worker.py \\
        --cache-root DIR --out DIR

Each rank keeps its cache under DIR/rank<r> (TPUQCD_RESOURCE_PATH) and
times two stand-in applies that sleep: on rank 0 fused is the faster
(2 ms against 10 ms), on rank 1 overlap (30 ms against 10 ms), so the
slowest rank's times pick overlap where rank 0's alone would pick fused.
Each rank writes {"winner": ..., "calls": {policy: applies}} to
DIR/rank<r>.json."""
import argparse
import json
import os
import time

import torch

from tpuqcd_torch.lattice import Lattice
from tpuqcd_torch.parallel.dist import init_distributed, rank
from tpuqcd_torch.parallel.mesh import LatticeMesh
from tpuqcd_torch.utils import tune

#: seconds an apply sleeps, by rank and policy
DELAY = ({"fused": 0.002, "overlap": 0.010}, {"fused": 0.030, "overlap": 0.010})
DIMS = (4, 4, 4, 8)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache-root", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    init_distributed("cpu")
    r = rank()
    os.environ["TPUQCD_RESOURCE_PATH"] = os.path.join(args.cache_root, f"rank{r}")
    lat = Lattice(DIMS)
    lmesh = LatticeMesh.make(lat, 2)
    calls = dict.fromkeys(tune.POLICIES, 0)

    def apply(policy):
        def fn(b):
            calls[policy] += 1
            time.sleep(DELAY[r][policy])
            return b
        return fn
    winner = tune.tune_comm_policy(lat, lmesh, {p: apply(p) for p in tune.POLICIES},
                                   torch.zeros(1), tag="test")
    with open(os.path.join(args.out, f"rank{r}.json"), "w") as f:
        json.dump({"winner": winner, "calls": calls}, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
