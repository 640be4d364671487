"""One gloo rank of the two- and three-point programs on a mesh, for
tests/test_torch_twop_mesh.py and test_torch_threep_mesh.py.  It imports
tpuqcd_torch only:

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        tests/_torch_physics_mesh_worker.py --mesh 2 2 1 --out out.npz \\
        --pieces in.npz --main run_twop --config cfg.yaml

--pieces: every rank loads the same global inputs, keeps its block, runs
the sharded pieces and rank 0 gathers each result into --out (the gather
is the test's, not the programs'):

    twop    smear_f64, smear_f32 (Gaussian smearing of two-parity columns),
            laplace (one hop), sources (point sources, packed), proj
            (phase-sum projection), proj_fft (FFT; on a mesh with nz or
            ny > 1 the string "refused" when fft=True raises)
    threep  seq_u, seq_d (sequential sources), seq_smear (their timeslice
            smearing), shift_<nu><+|-><c|n>, deriv_f32_<nu> (covariant
            shifts and derivatives), ultralocal, onederiv (insertions,
            projected)

--main run_twop | run_threeptwop: then the program's main on --config,
with every gather of a field made to raise (forbid_gathers), measure's
result kept; each rank writes to --out's stem + ".<rank>.npz" its solver
records (relres, columns), its stages and how many datasets it wrote.
"""
import argparse
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from tpuqcd_torch.lattice import Lattice
from tpuqcd_torch.parallel.dist import init_distributed, local_shard
from tpuqcd_torch.parallel.mesh import LatticeMesh

#: the tests' physics: Gaussian smearing, the source (t, z, y, x) off the
#: origin on a rank other than 0 of every mesh of the tests, the sink time
#: on another t-block, a sink momentum
ALPHA, N_GAUSS = 1.0, 3
SRC = (5, 3, 3, 2)
T_SINK = 1
SNK_MOM = (0, 1, 1)


def momenta() -> np.ndarray:
    """33 momenta: the FFT path's list length (>= FFT_MOM_THRESHOLD)."""
    m = [(x, y, z) for x in (-1, 0, 1) for y in (-1, 0, 1) for z in (-1, 0, 1)]
    return np.array(m + [(2, 0, 0), (0, 2, 0), (0, 0, 2), (-2, 0, 0), (0, -2, 0), (0, 0, -2)])


def twop_pieces(lmesh: LatticeMesh, inp, keep) -> None:
    from tpuqcd_torch.parallel.sharded import ghost_block
    from tpuqcd_torch.phys.propagator import packed_sources, point_sources
    from tpuqcd_torch.phys.smear import SMEAR_AXES, cov_laplace_3d_pk, gaussian_smear_pk
    from tpuqcd_torch.phys.threep_dev import project_momenta_pk
    lat = lmesh.lat
    u_sm = torch.from_numpy(inp["u_sm"])
    cols = torch.from_numpy(inp["cols"])
    for dt, name in ((torch.float64, "smear_f64"), (torch.float32, "smear_f32")):
        u_blk = ghost_block(lmesh, u_sm.to(dt), SMEAR_AXES)
        keep(name, gaussian_smear_pk(u_blk, local_shard(cols.to(dt), lmesh), lat, ALPHA,
                                     N_GAUSS, lmesh))
    u_blk = ghost_block(lmesh, u_sm, SMEAR_AXES)
    keep("laplace", cov_laplace_3d_pk(u_blk, local_shard(cols, lmesh), lat, lmesh))
    keep("sources", packed_sources(point_sources(lat, SRC, lmesh=lmesh), lmesh.local_lat))
    dens = local_shard(torch.from_numpy(inp["dens"]), lmesh)
    mom, xyz = momenta(), (SRC[3], SRC[2], SRC[1])
    keep("proj", project_momenta_pk(dens, lat, mom, xyz, fft=False, lmesh=lmesh), whole=True)
    try:
        keep("proj_fft", project_momenta_pk(dens, lat, mom, xyz, fft=True, lmesh=lmesh),
             whole=True)
    except ValueError:
        keep("proj_fft", "refused", whole=True)


def threep_pieces(lmesh: LatticeMesh, inp, keep) -> None:
    from tpuqcd_torch.gammas import INSERTION_GAMMAS, PROJECTORS
    from tpuqcd_torch.parallel.sharded import ghost_block
    from tpuqcd_torch.phys.propagator import sink_smear_timeslice_pk
    from tpuqcd_torch.phys.smear import SMEAR_AXES
    from tpuqcd_torch.phys.threep_dev import (cov_deriv_sym_pk, cov_shift_pk,
                                              proton_seq_source_pk, threep_one_derivative_all_pk,
                                              threep_ultralocal_pk)
    lat = lmesh.lat
    u = torch.from_numpy(inp["u"])
    su, sd = (local_shard(torch.from_numpy(inp[k]), lmesh) for k in ("su", "sd"))
    xyz = (SRC[3], SRC[2], SRC[1])
    for leg in ("u", "d"):
        seq = proton_seq_source_pk(su, sd, T_SINK, leg, lat, PROJECTORS["P5z"], SNK_MOM, xyz,
                                   lmesh)
        keep(f"seq_{leg}", seq)
    u_blk = ghost_block(lmesh, torch.from_numpy(inp["u_sm"]), SMEAR_AXES)
    keep("seq_smear", sink_smear_timeslice_pk(u_blk, seq, lat, T_SINK, ALPHA, N_GAUSS, lmesh))
    for nu in range(4):
        for sign in (1, -1):
            for conj in (False, True):
                keep(f"shift_{nu}{'+' if sign > 0 else '-'}{'c' if conj else 'n'}",
                     cov_shift_pk(u, su, nu, sign, lat, conj, lmesh))
        keep(f"deriv_f32_{nu}", cov_deriv_sym_pk(u.float(), su.float(), nu, lat, lmesh=lmesh))
    mom = momenta()[:3]
    c3 = threep_ultralocal_pk(sd, su, INSERTION_GAMMAS, lat, mom, SRC, lmesh=lmesh)
    keep("ultralocal", torch.stack(list(c3.values())), whole=True)
    c3 = threep_one_derivative_all_pk(sd, su, u, lat, mom, SRC, lmesh=lmesh)
    keep("onederiv", torch.stack(list(c3.values())), whole=True)


def forbid_gathers() -> None:
    """Make every gather of a field raise: the mesh path gathers none.  The
    one all_gather left is the sharded multigrid's restriction
    (mg/shard.py), which gathers a coarse vector for the coarse levels that
    every rank holds whole (as in run_invert and in tpuqcd)."""
    def refuse(*args, **kwargs):
        raise AssertionError("a field was gathered on the mesh path")
    all_gather = dist.all_gather

    def coarse_only(*args, **kwargs):
        if not sys._getframe(1).f_code.co_filename.endswith(os.path.join("mg", "shard.py")):
            refuse()
        return all_gather(*args, **kwargs)
    LatticeMesh.all_gather = refuse
    LatticeMesh.gather = refuse
    for name in ("gather", "all_gather_into_tensor", "broadcast", "scatter"):
        setattr(dist, name, refuse)
    dist.all_gather = coarse_only


def run_main(program: str, config: str, stem: str, rank: int) -> None:
    import importlib
    mod = importlib.import_module(f"tpuqcd_torch.cli.{program}")
    results, written = [], []
    measure = mod.measure

    def kept(*args, **kwargs):
        results.append(measure(*args, **kwargs))
        return results[-1]
    mod.measure = kept
    for name in ("write_twop", "write_threep"):
        if hasattr(mod, name):
            real = getattr(mod, name)
            setattr(mod, name, lambda *a, real=real, **k: (written.append(a[1]), real(*a, **k)))
    forbid_gathers()
    mod.main(["--config", config, "--device", "cpu"])
    (res,) = results
    np.savez(f"{stem}.{rank}.npz", relres=np.concatenate([r["relres"] for r in res.solves]),
             columns=np.array([r["columns"] for r in res.solves]), written=len(written),
             stages=np.array(sorted(res.seconds)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", type=int, nargs=3, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--pieces", help="the pieces' inputs (npz); their kind is in 'kind'")
    ap.add_argument("--main", choices=("run_twop", "run_threeptwop"))
    ap.add_argument("--config")
    args = ap.parse_args()
    init_distributed("cpu")
    torch.set_num_threads(1)
    rank = dist.get_rank() if dist.is_initialized() else 0
    if args.pieces:
        inp = np.load(args.pieces)
        lmesh = LatticeMesh.make(Lattice(tuple(int(d) for d in inp["dims"])), *args.mesh)
        out = {}

        def keep(name, x, whole=False):
            if isinstance(x, str):
                out[name] = np.array(x)
                return
            x = x if whole else lmesh.gather(x.contiguous())
            if x is not None:
                out[name] = x.numpy()
        {"twop": twop_pieces, "threep": threep_pieces}[str(inp["kind"])](lmesh, inp, keep)
        if rank == 0:
            np.savez(args.out, **out)
    if args.main:
        run_main(args.main, args.config, args.out[:-len(".npz")], rank)
    elif dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
