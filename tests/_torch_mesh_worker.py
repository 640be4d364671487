"""One rank of the port's sharded twisted-mass and twisted-clover
operators, solves, multigrid and eigCG on the CPU (gloo), for
tests/test_torch_sharded_clover.py, test_torch_mg_mesh.py and
test_torch_eigcg_mesh.py.  It imports tpuqcd_torch only:

    python -m torch.distributed.run --nproc_per_node 4 tests/_torch_mesh_worker.py \\
        --inputs in.npz --out out.npz --mesh 2 1 2 --policy overlap --tasks ops solve

Every rank loads the same global inputs and keeps its shard; rank 0
gathers each result and writes them to --out:

    ops     tm_<prec>_<method>, clover_<prec>_<method>: prec f32
            (reconstruct-12 float32 gauge, float32 clover) or f64; method
            apply, apply_dagger, prepare, reconstruct (flavor +1), and
            clover_f64_apply_m (flavor -1)
    solve   tm_x, tm_relres, tm_iters, clover_x, ...: solve_tm_sharded to 1e-12
    mg      mg_x, mg_relres, mg_iters, mg_links (the coarse links), mgc_x,
            ...: the sharded MG (twisted mass; twisted clover), null vectors
            from the seed-7 generator, certified to 1e-12
    eigcg   eig_x (three columns), eig_relres, eig_iters, eig_space
    musweep sweep_x (the multishift stage's x_i), sweep_relres, sweep_iters,
            cert_x, cert_relres, cert_iters: solve_tm_musweep of MUSWEEP_MU to
            1e-6, then certify_musweep to 1e-10
    mg3     mg3_x, mg3_relres, mg3_iters, mg3_links1, mg3_links2: the sharded
            three-level MG (MG3_PARAMS), certified to 1e-12
    mgbf    mgbf_x, mgbf_relres, mgbf_iters, mgbf_links: the sharded MG with
            bfloat16 solver buffers (MGBF_PARAMS), twisted mass, certified to
            1e-12

ops, solve and mg read the clover fields cl, clp, clm and psi from the
inputs; eigcg the columns cols; the others u, b, dims, kappa, mu and
t_boundary only.
"""
import argparse

import numpy as np
import torch

from tpuqcd_torch.lattice import Lattice
from tpuqcd_torch.parallel.dist import init_distributed, local_shard
from tpuqcd_torch.parallel.mesh import LatticeMesh
from tpuqcd_torch.parallel.sharded import (ShardedTMCloverOperatorPC, ShardedTMOperatorPC,
                                           clover_fields_to, extend_gauge)

#: the MG hierarchy of the tests: one coarsening, small and quick
MG_PARAMS = dict(n_vec=(4,), block=((2, 2, 2, 2),), setup_iters=20, mu_factor=1.0)
#: the three-level hierarchy (an 8^4 lattice: 4^4, then 2^4), with the
#: coarsest level's mu boost
MG3_PARAMS = dict(n_vec=(4, 4), block=((2, 2, 2, 2), (2, 2, 2, 2)), setup_iters=10)
#: MG_PARAMS with the bfloat16 GCR basis and null-vector bank
MGBF_PARAMS = dict(MG_PARAMS, gcr_dtype="bfloat16", vec_dtype="bfloat16")
#: the masses of the sweep, unsorted
MUSWEEP_MU = (0.2, 0.05, 0.1)


def mg_solve(lmesh, u, cl, kappa, mu, b, policy, tol=1e-12, params=None):
    """The sharded MG solve of the two-parity source b (global) with
    ``params`` (default MG_PARAMS) -> (x local, relres, inner iterations,
    the links of every coarse level, which are global and the same on
    every rank)."""
    from tpuqcd_torch.mg.dsolve import DeviceMG, DeviceMGParams
    from tpuqcd_torch.mg.shard import ShardedFineLevel
    from tpuqcd_torch.solve import solve_tm_mg
    lv = ShardedFineLevel.build(lmesh, local_shard(u, lmesh), kappa, mu,
                                comm_policy=policy,
                                clover_pk=None if cl is None else local_shard(cl, lmesh))
    mg = DeviceMG(lv, DeviceMGParams(**(MG_PARAMS if params is None else params)))
    res = solve_tm_mg(mg, local_shard(b, lmesh), tol=tol, inner_tol=1e-6)
    return res.x, res.relres, res.iters, [lvl.links_c for lvl in mg.levels[1:]]


def musweep(lmesh, u, b, kappa, t_boundary, policy):
    """The sweep of MUSWEEP_MU on the mesh (global u and b, every rank) ->
    (stage x_i local, stage relres, iterations, the certifications)."""
    from tpuqcd_torch.solve import certify_musweep, solve_tm_musweep
    u_loc, b_loc = local_shard(u, lmesh), local_shard(b, lmesh)
    kw = dict(kappa=kappa, mu_list=MUSWEEP_MU, t_boundary=t_boundary, lmesh=lmesh,
              comm_policy=policy)
    xs, rel, iters = solve_tm_musweep(u_loc, b_loc, lmesh.lat, tol=1e-6, **kw)
    return xs, rel, iters, certify_musweep(u_loc, b_loc, lmesh.lat, xs, tol=1e-10, **kw)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--mesh", type=int, nargs=3, default=(1, 1, 1))
    ap.add_argument("--policy", default="fused")
    ap.add_argument("--tasks", nargs="+", default=["ops"])
    args = ap.parse_args()
    init_distributed("cpu")
    torch.set_num_threads(1)
    inp = np.load(args.inputs)
    lat = Lattice(tuple(int(d) for d in inp["dims"]))
    kappa, mu = float(inp["kappa"]), float(inp["mu"])
    tb = int(inp["t_boundary"])
    lmesh = LatticeMesh.make(lat, *args.mesh)
    pol = args.policy
    out = {}

    def keep(name, x_loc):
        x = lmesh.gather(x_loc)
        if x is not None:
            out[name] = x.double().numpy()

    u64 = torch.from_numpy(inp["u"]).double()
    b64 = torch.from_numpy(inp["b"])
    if {"ops", "solve", "mg"} & set(args.tasks):
        clover = tuple(torch.from_numpy(inp[k]).double() for k in ("cl", "clp", "clm"))
        ug = extend_gauge(lmesh, local_shard(u64, lmesh))
        tm = {f: ShardedTMOperatorPC(lat, kappa=kappa, mu=mu, flavor=f, t_boundary=tb,
                                     lmesh=lmesh, comm_policy=pol) for f in (1, -1)}
        cl = {f: ShardedTMCloverOperatorPC(lat, kappa=kappa, mu=mu, flavor=f, t_boundary=tb,
                                           lmesh=lmesh, comm_policy=pol) for f in (1, -1)}
        f64 = cl[1].extend_fields(ug.u, *(local_shard(c, lmesh) for c in clover))
        fields = {"tm": {"f32": ug.to(torch.float32, rows=2), "f64": ug.to(torch.float64)},
                  "clover": {"f32": clover_fields_to(f64, torch.float32, rows=2),
                             "f64": clover_fields_to(f64, torch.float64)}}
        ops = {"tm": tm, "clover": cl}

    if "ops" in args.tasks:
        for name in ("tm", "clover"):
            op = ops[name][1]
            for prec, fl in fields[name].items():
                dt = torch.float64 if prec == "f64" else torch.float32
                x = local_shard(torch.from_numpy(inp["psi"]).to(dt), lmesh)
                b = local_shard(b64.to(dt), lmesh)
                keep(f"{name}_{prec}_apply", op.apply(fl, x))
                keep(f"{name}_{prec}_apply_dagger", op.apply_dagger(fl, x))
                keep(f"{name}_{prec}_prepare", op.prepare(fl, b))
                keep(f"{name}_{prec}_reconstruct", op.reconstruct(fl, x, b))
        x = local_shard(torch.from_numpy(inp["psi"]), lmesh)
        keep("clover_f64_apply_m", cl[-1].apply(fields["clover"]["f64"], x))

    if "solve" in args.tasks:
        from tpuqcd_torch.solve import solve_tm_sharded
        for name in ("tm", "clover"):
            res = solve_tm_sharded(ops[name][1], fields[name]["f32"], fields[name]["f64"],
                                   local_shard(b64, lmesh), tol=1e-12)
            keep(f"{name}_x", res.x)
            out[f"{name}_relres"], out[f"{name}_iters"] = res.relres, res.iters

    if "mg" in args.tasks:
        for name, c in (("mg", None), ("mgc", clover[0].float())):
            x, relres, iters, (links,) = mg_solve(lmesh, u64.float(), c, kappa, mu, b64, pol)
            keep(f"{name}_x", x)
            out[f"{name}_relres"], out[f"{name}_iters"] = relres, iters
            out[f"{name}_links"] = torch.view_as_real(links).double().numpy()

    if "mgbf" in args.tasks:
        x, relres, iters, (links,) = mg_solve(lmesh, u64.float(), None, kappa, mu, b64, pol,
                                              params=MGBF_PARAMS)
        keep("mgbf_x", x)
        out.update(mgbf_relres=relres, mgbf_iters=iters)
        out["mgbf_links"] = torch.view_as_real(links).double().numpy()

    if "eigcg" in args.tasks:
        from tpuqcd_torch.solve import ShardedEigCGSolver
        es = ShardedEigCGSolver(local_shard(u64, lmesh), lat, lmesh, kappa=kappa, mu=mu,
                                t_boundary=tb, comm_policy=pol)
        xs, rel, its, space = [], [], [], []
        for col in torch.from_numpy(inp["cols"]):
            res = es.solve(local_shard(col, lmesh), tol=1e-12)
            xs.append(res.x)
            rel.append(res.relres)
            its.append(res.iters)
            space.append(es.space.k)
        keep("eig_x", torch.stack(xs))
        out.update(eig_relres=np.array(rel), eig_iters=np.array(its),
                   eig_space=np.array(space))

    if "musweep" in args.tasks:
        xs, rel, iters, certs = musweep(lmesh, u64.float(), b64, kappa, tb, pol)
        keep("sweep_x", xs)
        keep("cert_x", torch.stack([c.x for c in certs]))
        out.update(sweep_relres=np.array(rel), sweep_iters=iters,
                   cert_relres=np.array([c.relres for c in certs]),
                   cert_iters=np.array([c.iters for c in certs]))

    if "mg3" in args.tasks:
        x, relres, iters, links = mg_solve(lmesh, u64.float(), None, kappa, mu, b64, pol,
                                           params=MG3_PARAMS)
        keep("mg3_x", x)
        out.update(mg3_relres=relres, mg3_iters=iters)
        for i, lc in enumerate(links, 1):
            out[f"mg3_links{i}"] = torch.view_as_real(lc).double().numpy()

    if lmesh.rank == 0:
        np.savez(args.out, **out)
    if lmesh.size > 1:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
