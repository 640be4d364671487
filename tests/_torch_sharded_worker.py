"""One rank of the port's sharded operators and solve on the CPU (gloo),
for tests/test_torch_sharded.py.  It imports tpuqcd_torch only:

    python -m torch.distributed.run --nproc_per_node 4 tests/_torch_sharded_worker.py \\
        --inputs in.npz --out out.npz --nt 2 --nz 2

Every rank loads the same global inputs and keeps its shard; rank 0
gathers each result and writes them to --out:

    tm_<prec>_<method>, ndeg_<prec>_<method>   prec f32 (reconstruct-12
        float32 operator) or f64; method apply, apply_dagger, prepare,
        reconstruct
    solve_x, solve_relres, solve_iters          solve_ndeg_tm_sharded to 1e-12
    faces_err                                   max |exchange_faces - cut_halo|
"""
import argparse

import numpy as np
import torch

from tpuqcd_torch.lattice import Lattice
from tpuqcd_torch.parallel.dist import init_distributed, local_shard
from tpuqcd_torch.parallel.mesh import LatticeMesh
from tpuqcd_torch.parallel.sharded import (ShardedNdegTMOperatorPC, ShardedTMOperatorPC,
                                           cut_halo, exchange_faces)
from tpuqcd_torch.solve import solve_ndeg_tm_sharded


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--nt", type=int, default=1)
    ap.add_argument("--nz", type=int, default=1)
    args = ap.parse_args()
    init_distributed("cpu")
    torch.set_num_threads(1)
    inp = np.load(args.inputs)
    lat = Lattice(tuple(int(d) for d in inp["dims"]))
    kappa, mu, mubar, epsbar = (float(inp[k]) for k in ("kappa", "mu", "mubar", "epsbar"))
    lmesh = LatticeMesh.make(lat, args.nt, args.nz)
    out = {}

    def keep(name, x_loc):
        x = lmesh.gather(x_loc)
        if x is not None:
            out[name] = x.double().numpy()

    u64 = torch.from_numpy(inp["u"]).double()
    tm = ShardedTMOperatorPC(lat, kappa=kappa, mu=mu, lmesh=lmesh)
    nd = ShardedNdegTMOperatorPC(lat, kappa=kappa, mubar=mubar, epsbar=epsbar, lmesh=lmesh)
    ug = tm.extend_gauge(local_shard(u64, lmesh))
    fields = {"f32": ug.to(torch.float32, rows=2), "f64": ug.to(torch.float64)}
    for name, op, even, full in (("tm", tm, "psi", "b"), ("ndeg", nd, "chi", "bd")):
        for prec, fl in fields.items():
            dt = fl.u.dtype
            x = local_shard(torch.from_numpy(inp[even]).to(dt), lmesh)
            b = local_shard(torch.from_numpy(inp[full]).to(dt), lmesh)
            keep(f"{name}_{prec}_apply", op.apply(fl, x))
            keep(f"{name}_{prec}_apply_dagger", op.apply_dagger(fl, x))
            keep(f"{name}_{prec}_prepare", op.prepare(fl, b))
            keep(f"{name}_{prec}_reconstruct", op.reconstruct(fl, x, b))
    bd = local_shard(torch.from_numpy(inp["bd"]), lmesh)
    res = solve_ndeg_tm_sharded(nd, fields["f32"], fields["f64"], bd, tol=1e-12)
    keep("solve_x", res.x)
    out["solve_relres"], out["solve_iters"] = res.relres, res.iters

    # the exchanged faces are the ones cut from the global field
    psi = torch.from_numpy(inp["psi"])
    err = 0.0
    for half in (True, False):
        for dagger in (False, True):
            got = exchange_faces(lmesh, local_shard(psi, lmesh), dagger, half)
            _, _, want = cut_halo(lmesh, u64, psi, 0, dagger, half)
            err = max(err, *((g - w).abs().max().item() for g, w in zip(got, want[:4])))
            got_u = (ug.u_t[0], ug.u_z[0])
            err = max(err, *((g - w).abs().max().item() for g, w in zip(got_u, want[4:6])))
    errs = torch.tensor([err])
    torch.distributed.all_reduce(errs, op=torch.distributed.ReduceOp.MAX)
    out["faces_err"] = errs.item()
    if lmesh.rank == 0:
        np.savez(args.out, **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
