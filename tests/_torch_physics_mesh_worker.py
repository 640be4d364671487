"""One gloo rank of the physics programs on a mesh, for
tests/test_torch_twop_mesh.py, test_torch_threep_mesh.py,
test_torch_loops_mesh.py and test_torch_run_loops_mesh.py.  It imports
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
    loops   noise (two Z4 noises of seed 17), dilute_t3 (the first one's
            time dilution in 3 classes), deflate (the projector Q on
            float64 columns), oneend_<phase|fft>, oneend_der_<phase|fft>
            (the one-end loops of float64 rows; the FFT where each rank
            holds whole timeslices, else "refused"), lanczos_evals,
            lanczos_evecs (run_loops.deflation_basis), eig_read (a basis
            written by save_eigenpairs from the blocks to the input's
            eig_path, then read back on the mesh)

--chain-failures cfg.yaml: before --main, cli/common._heatbath_chain_members
on the heatbath chain of cfg.yaml twice, made to fail on one rank: first
as given (its gauge.heatbath_dir one that rank 0 cannot create), then into
a writable directory with rank 1's plaquette raising; each rank writes
the class of what each attempt raised to --out's stem + ".failures.<rank>.npz".

--main run_twop | run_threeptwop | run_loops: then the program's main on
each --config in turn, with every gather of a field made to raise
(forbid_gathers) but those of the eigenpair file's write, measure's
result kept; each rank writes to --out's stem + ".<rank>.npz"
(".<i>.<rank>.npz" for the i-th of several) its solver records (relres,
columns) over every ensemble member, its stages, how many datasets it
wrote, how many members it measured and how many fields the eigenpair
write gathered.
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


def loops_pieces(lmesh: LatticeMesh, inp, keep) -> None:
    from tpuqcd_torch.cli.run_loops import NOISE_SEED, deflation_basis
    from tpuqcd_torch.gammas import INSERTION_GAMMAS
    from tpuqcd_torch.phys.loops_dev import (_loop_all, _one_end_mats, diluted_sources_pk,
                                             make_deflate_pk, z4_noises)
    from tpuqcd_torch.utils.checkpoint import load_eigenpairs, save_eigenpairs
    from tpuqcd_torch.utils.config import config_from_dict
    lat = lmesh.lat
    noise = torch.stack(list(z4_noises(NOISE_SEED, 2, lat, lmesh=lmesh)))
    keep("noise", noise)
    keep("dilute_t3", diluted_sources_pk(noise[0], 3, lmesh=lmesh))
    evecs, cols = (local_shard(torch.from_numpy(inp[k]), lmesh) for k in ("evecs", "cols"))
    keep("deflate", make_deflate_pk(evecs, lmesh)(cols))
    u, psis = torch.from_numpy(inp["u"]), local_shard(torch.from_numpy(inp["psis"]), lmesh)
    mats = _one_end_mats(INSERTION_GAMMAS, float(inp["kappa"]), float(inp["mu"]))
    for fft in (False, True):
        tag = "fft" if fft else "phase"
        try:
            est = _loop_all(psis, psis, mats, lat, momenta(), fft, lmesh=lmesh)
        except ValueError:
            keep(f"oneend_{tag}", "refused", whole=True)
            continue
        der = _loop_all(psis, psis, mats, lat, momenta(), fft, u, (0, 1, 2, 3), lmesh)
        keep(f"oneend_{tag}", torch.stack(list(est.values())), whole=True)
        keep(f"oneend_der_{tag}", torch.stack(list(der.values())), whole=True)
    cfg = config_from_dict({"gauge": {"dims": list(lat.dims)},
                            "action": {"kappa": float(inp["kappa"]), "mu": float(inp["mu"])},
                            "physics": {"n_deflate": int(inp["n_deflate"])}})
    evals, lz = deflation_basis(cfg, lat, u.float(), lmesh,
                                "overlap" if lmesh.ny > 1 else "fused")
    keep("lanczos_evals", torch.from_numpy(evals), whole=True)
    keep("lanczos_evecs", lz)
    path = str(inp["eig_path"])
    save_eigenpairs(path, inp["basis_evals"], local_shard(torch.from_numpy(inp["basis"]), lmesh),
                    "packed", lmesh)
    dist.barrier()
    _, back = load_eigenpairs(path, "packed", len(inp["basis"]), lmesh)
    keep("eig_read", torch.stack(back))


#: one entry a field that the eigenpair write gathered (forbid_gathers lets it)
GATHERED = []


def _in_eigenpair_write() -> bool:
    """Whether utils/checkpoint.save_eigenpairs is on the call stack."""
    f = sys._getframe(2)
    while f is not None:
        code = f.f_code
        if code.co_name == "save_eigenpairs" and code.co_filename.endswith(
                os.path.join("utils", "checkpoint.py")):
            return True
        f = f.f_back
    return False


def forbid_gathers() -> None:
    """Make every gather of a field raise: the mesh path gathers none.  The
    all_gathers left are the sharded multigrid's restriction (mg/shard.py),
    which gathers a coarse vector for the coarse levels that every rank
    holds whole (as in run_invert and in tpuqcd); the gathers left are the
    eigenpair file's (utils/checkpoint.save_eigenpairs, a vector at a time
    to rank 0, which writes the file; counted in GATHERED)."""
    def refuse(*args, **kwargs):
        raise AssertionError("a field was gathered on the mesh path")
    all_gather, gather, mesh_gather = dist.all_gather, dist.gather, LatticeMesh.gather

    def coarse_only(*args, **kwargs):
        if not sys._getframe(1).f_code.co_filename.endswith(os.path.join("mg", "shard.py")):
            refuse()
        return all_gather(*args, **kwargs)

    def eigenpairs_only(real, count):
        def call(*args, **kwargs):
            if not _in_eigenpair_write():
                refuse()
            GATHERED.extend([1] * count)
            return real(*args, **kwargs)
        return call
    LatticeMesh.all_gather = refuse
    LatticeMesh.gather = eigenpairs_only(mesh_gather, 1)
    for name in ("all_gather_into_tensor", "broadcast", "scatter"):
        setattr(dist, name, refuse)
    dist.gather = eigenpairs_only(gather, 0)
    dist.all_gather = coarse_only


def run_main(program: str, configs, stem: str, rank: int) -> None:
    """The program's main on each of ``configs`` in turn, in one process
    group (only the last main leaves it); the record of the i-th goes to
    stem.<rank>.npz for one configuration, stem.<i>.<rank>.npz for
    several."""
    import importlib

    from tpuqcd_torch.parallel import dist as tdist
    mod = importlib.import_module(f"tpuqcd_torch.cli.{program}")
    shutdown = tdist.shutdown
    results, written = [], []
    measure = mod.measure

    def kept(*args, **kwargs):
        results.append(measure(*args, **kwargs))
        return results[-1]
    mod.measure = kept
    for name in ("write_twop", "write_threep", "write_loops"):
        if hasattr(mod, name):
            real = getattr(mod, name)
            setattr(mod, name, lambda *a, real=real, **k: (written.append(a[1]), real(*a, **k)))
    forbid_gathers()
    for i, config in enumerate(configs):
        for kept_list in (results, written, GATHERED):
            kept_list.clear()
        tdist.shutdown = shutdown if i == len(configs) - 1 else (lambda: None)
        mod.main(["--config", config, "--device", "cpu"])
        solves = [r for res in results for r in res.solves]
        out = f"{stem}.{rank}.npz" if len(configs) == 1 else f"{stem}.{i}.{rank}.npz"
        np.savez(out, relres=np.concatenate([r["relres"] for r in solves]),
                 columns=np.array([r["columns"] for r in solves]), written=len(written),
                 stages=np.array(sorted(results[0].seconds)), members=len(results),
                 gathered=len(GATHERED))


def chain_failures(config: str, stem: str, rank: int) -> None:
    """_heatbath_chain_members made to fail on rank 0 (its directory), then
    on rank 1 (a member's plaquette): what each rank raised, by class."""
    import dataclasses

    from tpuqcd_torch.cli import common
    from tpuqcd_torch.utils.config import load_config
    cfg = load_config(config)
    cpu = torch.device("cpu")
    raised = {}

    def attempt(key, c):
        try:
            common._heatbath_chain_members(c, cpu)
            raised[key] = "nothing"
        except Exception as e:
            raised[key] = type(e).__name__
    attempt("dir", cfg)
    plaquette = common.plaquette

    def failing(*args, **kwargs):
        raise ValueError("a rank's own failure")
    common.plaquette = failing if rank == 1 else plaquette
    attempt("member", dataclasses.replace(cfg, gauge=dataclasses.replace(
        cfg.gauge, heatbath_dir=f"{stem}.writable")))
    common.plaquette = plaquette
    np.savez(f"{stem}.failures.{rank}.npz", **raised)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", type=int, nargs=3, help="the pieces' mesh")
    ap.add_argument("--out", required=True)
    ap.add_argument("--pieces", help="the pieces' inputs (npz); their kind is in 'kind'")
    ap.add_argument("--main", choices=("run_twop", "run_threeptwop", "run_loops"))
    ap.add_argument("--config", nargs="+", help="the configurations --main runs, in turn")
    ap.add_argument("--chain-failures", help="a heatbath chain's configuration to fail")
    args = ap.parse_args()
    init_distributed("cpu")
    torch.set_num_threads(1)
    rank = dist.get_rank() if dist.is_initialized() else 0
    if args.chain_failures:
        chain_failures(args.chain_failures, args.out[:-len(".npz")], rank)
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
        {"twop": twop_pieces, "threep": threep_pieces,
         "loops": loops_pieces}[str(inp["kind"])](lmesh, inp, keep)
        if rank == 0:
            np.savez(args.out, **out)
    if args.main:
        run_main(args.main, args.config, args.out[:-len(".npz")], rank)
    elif dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
