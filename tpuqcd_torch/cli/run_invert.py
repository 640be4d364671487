"""One certified twisted-mass, twisted-clover or non-degenerate doublet
solve against a random source, with the iteration count, the certified
full-system residual and GFLOP/s.

    python -m tpuqcd_torch.cli.run_invert --config examples/invert.yaml
    python -m tpuqcd_torch.cli.run_invert --config examples/invert_mg.yaml --device cpu
    torchrun --nproc_per_node 2 -m tpuqcd_torch.cli.run_invert --config cfg.yaml

Counterpart of ``tpuqcd/cli/run_invert.py``: with ``mg.enabled`` the
MG-preconditioned solve (its hierarchy set up before the timed solve),
else the direct even-odd packed path; ``action.csw`` != 0 solves the
twisted-clover system on either (the clover construction of the direct
path is built before the timed solve).  Prints the same
``RESULT solve_seconds=... relres=... gflops=...`` line; relres is an
independent float64 |b - M x| / |b| of the two-parity system, with the
clover term when csw != 0.  gflops counts the twisted-mass Dslash flops
of the sloppy matvecs, as tpuqcd does, for clover too.

With a mesh of more than one rank (``mesh.nt/nz/ny``; torchrun, one
process per card, NCCL, or gloo with ``--device cpu``) every solve runs
sharded (cli/common.Solver's mesh branch: solve_tm_sharded on the sharded
twisted-mass or clover operator, the sharded MG fine level, or the
sharded eigCG with ``solver: eigcg``), under the communication policy of
``solver.comm_policy`` (fused, overlap; auto times both on the cards; a
y-sharded mesh takes overlap).  Rank 0 gathers x, computes the
independent float64 residual with the unsharded operator and alone
prints the RESULT line, with ``mesh=... comm_policy=...`` added.

    torchrun --nproc_per_node 2 -m tpuqcd_torch.cli.run_invert \
        --config examples/invert_mesh.yaml --device cpu

``action.epsbar`` != 0 solves the non-degenerate doublet (tpuqcd's
_main_ndeg) for a two-column source from seed 99, by CG inside the f64
defect correction; on a mesh on the sharded doublet operator, after
which rank 0 gathers x.  Rank 0 computes the independent float64 doublet
residual with the unsharded kernel and alone prints ``RESULT
solve_seconds=... relres=... dims=... tol=... ndeg=1``.

``action.mu_list`` runs the quark-mass sweep (tpuqcd's _main_musweep): one
seed-99 source, one multishift CG Krylov space for every mass
(solve.solve_tm_musweep, iterated to solver.inner_tol), then each mass
certified to solver.tol by a solve_tm warm-started from its x_i
(solve.certify_musweep); on a mesh the sharded fine level and
solve_tm_sharded, rank 0 gathering the x_i.  The ``RESULT
solve_seconds=... multishift_iters=... mu=... relres=... refine_iters=...``
line lists the masses in mu_list order with their independent float64
full-system residuals.

    python -m tpuqcd_torch.cli.run_invert --config examples/invert_musweep.yaml --device cpu

With gauge.config_files, gauge.random_seeds or a heatbath chain
(gauge.heatbath_n_cfg > 1) it solves once per ensemble member
(common.ensemble_members).
"""
from __future__ import annotations

import dataclasses

import torch

from ..parallel import dist as tdist
from ..parallel.dist import local_shard
from ..parallel.mesh import LatticeMesh
from ..parallel.sharded import ShardedNdegTMOperatorPC, extend_gauge
from ..solve import (certify_musweep, full_system_relres, make_clover_fields, ndeg_full_relres,
                     solve_ndeg_tm, solve_ndeg_tm_sharded, solve_tm, solve_tm_musweep)
from ..utils.config import RunConfig
from ..utils.profile import Profile, solve_flops, sync
from .common import (Gauge, MGSolver, _tuning, check_in_slice, comm_policy,
                     ensemble_members, is_mesh, log, make_solver, parse_args, random_source,
                     setup_gauge)


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """A mass sweep's results, each list in mu_list order."""
    mu_list: tuple
    #: the certified solutions [n_mu, 2(par), 2(ri), 4, 3, T, Z, S] float64;
    #: None on the ranks other than 0 of a mesh
    xs: torch.Tensor | None
    relres: list              # independent float64 full-system |b - M(mu_i) x_i| / |b|
    solver_relres: list       # each certification's own (even-odd system)
    multishift_relres: list   # the multishift stage's x_i, float64 full-system
    multishift_iters: int     # the steps of the one Krylov space
    refine_iters: list        # each certification's sloppy matvecs
    refinements: list         # and its defect-correction passes
    #: "multishift", "refinement" and their sum "total" (host clock, synchronised)
    seconds: dict


@dataclasses.dataclass(frozen=True)
class InvertResult:
    seconds: float         # solve wallclock, host clock, device synchronised
    relres: float          # certified full-system |b - M x| / |b|, float64
    solver_relres: float   # the solver's certified residual (eo system for CG)
    iters: int             # sloppy matvecs (CG) or inner GCR iterations (MG)
    refinements: int
    gflops: float          # 0.0 for MG and ndeg, whose flops are not counted (as in tpuqcd)
    #: solution [2(par), 2(ri), 4, 3, T, Z, S] float64 ([2(fl), 2(par), ...]
    #: for the doublet); None on the ranks other than 0 of a mesh
    x: torch.Tensor | None
    plaquette: float
    #: seconds of the stages before the solve: "gauge", for MG the
    #: hierarchy's "nulls0", "galerkin0", ... and their sum "mg_setup", for
    #: a direct clover solve the clover construction "clover", on a mesh the
    #: solver's set-up "halo" (the gauge face exchange, the policy, and the
    #: clover construction of a direct clover solve)
    setup_seconds: dict
    u_pk: torch.Tensor     # the packed float32 gauge the solve ran on
    b_pk: torch.Tensor     # the packed float32 source
    #: the multigrid hierarchy of an MG solve, else None
    mg: object = None
    #: a mass sweep's per-mass results (then x, relres and solver_relres are
    #: the first mass's solution and the largest residuals, iters the
    #: multishift steps, refinements the sum over the masses), else None
    sweep: SweepResult | None = None


def main(argv=None):
    cfg, device = parse_args(__doc__, argv)
    try:
        for ctag, c in ensemble_members(cfg, device):
            if ctag:
                log.info("=== ensemble member %s ===", ctag)
            invert(c, device)
    finally:
        tdist.shutdown()


def invert(cfg: RunConfig, device: torch.device, gauge: Gauge | None = None) -> InvertResult:
    """The solve of ``cfg`` on ``device``; ``gauge``, what setup_gauge(cfg,
    device) returned before, saves generating it again."""
    check_in_slice(cfg)
    log.info("solver.backend=%s selects nothing in the port: the tensors' device "
             "(%s) runs the CUDA kernel or, on the CPU, its plain version",
             cfg.solver.backend, device)
    lat, u_pk, plaq, gauge_seconds = setup_gauge(cfg, device) if gauge is None else gauge
    setup_seconds = {"gauge": gauge_seconds}
    if cfg.action.epsbar != 0.0:
        return _invert_ndeg(cfg, device, lat, u_pk, plaq, setup_seconds)
    if cfg.action.mu_list:
        return _invert_musweep(cfg, device, lat, u_pk, plaq, setup_seconds)
    if is_mesh(cfg):
        return _invert_mesh(cfg, device, lat, u_pk, plaq, setup_seconds)
    b_pk = random_source(lat, device)
    kappa, mu, csw = cfg.action.kappa, cfg.action.mu, cfg.action.csw
    prof = Profile()
    mg = None
    if cfg.mg.enabled:
        solver = MGSolver(cfg, lat, u_pk)
        with prof.phase("mg_setup"):
            mg = solver.setup(+1)
            sync(device)
        setup_seconds.update(mg.setup_seconds, mg_setup=prof.times["mg_setup"])
        with prof.phase("solve"):
            res = solver(b_pk, +1)
            sync(device)
        clover_pk = mg.levels[0].clover_pk if csw != 0.0 else None
    else:
        sloppy = torch.bfloat16 if cfg.solver.sloppy_dtype == "bfloat16" else torch.float32
        clover = None
        if csw != 0.0:
            with prof.phase("clover"):
                clover = make_clover_fields(u_pk, lat, kappa=kappa, mu=mu, csw=csw)
                sync(device)
            setup_seconds["clover"] = prof.times["clover"]
            log.info("clover term csw=%g and its twisted inverses: %.3f s", csw,
                     setup_seconds["clover"])
        with prof.phase("solve"):
            res = solve_tm(u_pk, b_pk, lat, kappa=kappa, mu=mu, tol=cfg.solver.tol,
                           maxiter=cfg.solver.maxiter, inner_tol=cfg.solver.inner_tol,
                           solver=cfg.solver.solver, sloppy_dtype=sloppy,
                           t_boundary=-1 if cfg.gauge.antiperiodic_t else 1, csw=csw,
                           clover=clover)
            sync(device)
        prof.add_flops("solve", solve_flops(lat, res.iters))
        clover_pk = clover[0] if clover is not None else None
    t = prof.times["solve"]
    log.info("solver: relres=%.2e iters=%d refinements=%d", res.relres, res.iters,
             res.refinements)
    rel = full_system_relres(u_pk, b_pk, res.x, lat, kappa=kappa, mu=mu, csw=csw,
                             clover_pk=clover_pk)
    gf = prof.flops["solve"] / t / 1e9
    log.info("wallclock %.3f s (%.1f GFLOP/s), certified |r|/|b| = %.3e", t, gf, rel)
    print(f"RESULT solve_seconds={t:.3f} relres={rel:.3e} gflops={gf:.1f} "
          f"dims={lat.dims} tol={cfg.solver.tol}")
    return InvertResult(seconds=t, relres=rel, solver_relres=res.relres, iters=res.iters,
                        refinements=res.refinements, gflops=gf, x=res.x, plaquette=plaq,
                        setup_seconds=setup_seconds, u_pk=u_pk, b_pk=b_pk, mg=mg)


def _invert_mesh(cfg: RunConfig, device: torch.device, lat, u_pk, plaq,
                 setup_seconds) -> InvertResult:
    """The twisted-mass or twisted-clover solve, direct, MG or eigCG, on the
    mesh of cfg.mesh (cli/common.Solver's mesh branch): every rank solves
    its shard of the seed-99 source, rank 0 gathers x and computes the
    independent float64 residual with the unsharded operator."""
    a = cfg.action
    if not tdist.all_processes_agree(plaq, "plaquette"):
        raise RuntimeError("the ranks built different gauges")
    b_pk = random_source(lat, device)
    prof = Profile()
    with prof.phase("halo"):
        solver = make_solver(cfg, lat, u_pk)
        sync(device)
    setup_seconds["halo"] = prof.times["halo"]
    lmesh, mg = solver.lmesh, None
    if solver.mg is not None:
        with prof.phase("mg_setup"):
            mg = solver.mg.setup(+1)
            sync(device)
        setup_seconds.update(mg.setup_seconds, mg_setup=prof.times["mg_setup"])
    with prof.phase("solve"):
        res = solver.solve_local(local_shard(b_pk, lmesh), +1)
        sync(device)
    direct = solver.sharded is not None
    if direct:
        prof.add_flops("solve", solve_flops(lat, res.iters))
    t = prof.times["solve"]
    log.info("solver: relres=%.2e iters=%d refinements=%d", res.relres, res.iters,
             res.refinements)
    x = lmesh.gather(res.x)
    rel = float("nan")
    if x is not None:
        clover_pk = None
        if a.csw != 0.0:
            clover_pk = solver.clover[0] if solver.clover is not None else None
        rel = full_system_relres(u_pk, b_pk, x, lat, kappa=a.kappa, mu=a.mu, csw=a.csw,
                                 clover_pk=clover_pk)
    rel = tdist.broadcast_float(rel, device)
    gf = prof.flops["solve"] / t / 1e9 if direct else 0.0
    if tdist.rank() == 0:
        log.info("wallclock %.3f s (%.1f GFLOP/s), certified |r|/|b| = %.3e", t, gf, rel)
        print(f"RESULT solve_seconds={t:.3f} relres={rel:.3e} gflops={gf:.1f} "
              f"dims={lat.dims} tol={cfg.solver.tol} mesh={lmesh.nt}x{lmesh.nz}x{lmesh.ny} "
              f"comm_policy={solver.policy}")
    return InvertResult(seconds=t, relres=rel, solver_relres=res.relres, iters=res.iters,
                        refinements=res.refinements, gflops=gf, x=x, plaquette=plaq,
                        setup_seconds=setup_seconds, u_pk=u_pk, b_pk=b_pk, mg=mg)


def _invert_musweep(cfg: RunConfig, device: torch.device, lat, u_pk, plaq,
                    setup_seconds) -> InvertResult:
    """The quark-mass sweep of action.mu_list (tpuqcd/cli/run_invert.py:97-143),
    on one device or the mesh of cfg.mesh: the multishift stage to
    solver.inner_tol (what float32 reaches), then every mass certified to
    solver.tol from its x_i; rank 0 gathers the certified x_i and computes
    each mass's independent float64 residual with the unsharded operator."""
    a, sv = cfg.action, cfg.solver
    mu_list = tuple(float(m) for m in a.mu_list)
    sloppy = torch.bfloat16 if sv.sloppy_dtype == "bfloat16" else torch.float32
    b_pk = random_source(lat, device)
    prof = Profile()
    lmesh, policy, u_in, b_in = None, "fused", u_pk, b_pk
    if is_mesh(cfg):
        if not tdist.all_processes_agree(plaq, "plaquette"):
            raise RuntimeError("the ranks built different gauges")
        m = cfg.mesh
        lmesh = LatticeMesh.make(lat, m.nt, m.nz, m.ny)
        with prof.phase("halo"):
            policy = comm_policy(cfg, lmesh, device, _tuning(
                cfg, lmesh, lambda: extend_gauge(lmesh, local_shard(u_pk.double(), lmesh)),
                u_pk))
            sync(device)
        setup_seconds["halo"] = prof.times["halo"]
        log.info("musweep lattice mesh: %d x %d x %d ranks over (T, Z, Y), comm_policy %s -> "
                 "%s", m.nt, m.nz, m.ny, sv.comm_policy, policy)
        u_in, b_in = local_shard(u_pk, lmesh), local_shard(b_pk, lmesh)
    kw = dict(kappa=a.kappa, mu_list=mu_list, t_boundary=-1 if cfg.gauge.antiperiodic_t else 1,
              lmesh=lmesh, comm_policy=policy)
    with prof.phase("multishift"):
        xs, ms_rel, ms_iters = solve_tm_musweep(u_in, b_in, lat, tol=sv.inner_tol,
                                                maxiter=sv.maxiter, **kw)
        sync(device)
    with prof.phase("refinement"):
        certs = certify_musweep(u_in, b_in, lat, xs, tol=sv.tol, maxiter=sv.maxiter,
                                inner_tol=sv.inner_tol, sloppy_dtype=sloppy, **kw)
        sync(device)
    del xs
    seconds = {k: prof.times[k] for k in ("multishift", "refinement")}
    seconds["total"] = seconds["multishift"] + seconds["refinement"]
    x_all = torch.stack([c.x for c in certs])
    if lmesh is not None:
        x_all = lmesh.gather(x_all)
    rels = [float("nan")] * len(mu_list)
    if x_all is not None:
        rels = [full_system_relres(u_pk, b_pk, x, lat, kappa=a.kappa, mu=mu)
                for x, mu in zip(x_all, mu_list)]
    rels = [tdist.broadcast_float(r, device) for r in rels]
    sweep = SweepResult(mu_list=mu_list, xs=x_all, relres=rels,
                        solver_relres=[c.relres for c in certs], multishift_relres=ms_rel,
                        multishift_iters=ms_iters, refine_iters=[c.iters for c in certs],
                        refinements=[c.refinements for c in certs], seconds=seconds)
    if tdist.rank() == 0:
        for i, mu in enumerate(mu_list):
            log.info("musweep mu=%g: multishift relres %.2e, certified relres %.2e after %d "
                     "sloppy matvecs in %d refinements", mu, ms_rel[i], rels[i],
                     sweep.refine_iters[i], sweep.refinements[i])
        log.info("musweep: %d masses, %d multishift iterations (one Krylov space) %.3f s, "
                 "certification %.3f s", len(mu_list), ms_iters, seconds["multishift"],
                 seconds["refinement"])

        def csv(vals, fmt):
            return ",".join(format(v, fmt) for v in vals)
        mesh = "" if lmesh is None else \
            f" mesh={lmesh.nt}x{lmesh.nz}x{lmesh.ny} comm_policy={policy}"
        print(f"RESULT solve_seconds={seconds['total']:.3f} multishift_iters={ms_iters} "
              f"mu={csv(mu_list, 'g')} relres={csv(rels, '.3e')} "
              f"refine_iters={csv(sweep.refine_iters, 'd')} "
              f"multishift_relres={csv(ms_rel, '.3e')} dims={lat.dims} tol={sv.tol}{mesh}")
    return InvertResult(seconds=seconds["total"], relres=max(rels),
                        solver_relres=max(sweep.solver_relres), iters=ms_iters,
                        refinements=sum(sweep.refinements), gflops=0.0,
                        x=None if x_all is None else x_all[0], plaquette=plaq,
                        setup_seconds=setup_seconds, u_pk=u_pk, b_pk=b_pk, sweep=sweep)


def _invert_ndeg(cfg: RunConfig, device: torch.device, lat, u_pk, plaq,
                 setup_seconds) -> InvertResult:
    """The non-degenerate doublet solve (tpuqcd/cli/run_invert.py:146-249),
    on one device or on the mesh of cfg.mesh."""
    a, m = cfg.action, cfg.mesh
    # the phase the links carry (tpuqcd's run_invert.py:210-216 leaves the default)
    tb = -1 if cfg.gauge.antiperiodic_t else 1
    sloppy = torch.bfloat16 if cfg.solver.sloppy_dtype == "bfloat16" else torch.float32
    solver_kw = dict(tol=cfg.solver.tol, maxiter=cfg.solver.maxiter,
                     inner_tol=cfg.solver.inner_tol)
    b_pk = random_source(lat, device, columns=2)          # [2(fl), 2(par), 2(ri), ...]
    prof = Profile()
    if m.nt * m.nz * m.ny > 1:
        lmesh = LatticeMesh.make(lat, m.nt, m.nz, m.ny)
        if not tdist.all_processes_agree(plaq, "plaquette"):
            raise RuntimeError("the ranks built different gauges")
        with prof.phase("halo"):
            ug = extend_gauge(lmesh, local_shard(u_pk, lmesh))
            fields_s, fields_hp = ug.to(sloppy, rows=2), ug.to(torch.float64)

            def make_op(policy):
                return ShardedNdegTMOperatorPC(lat, kappa=a.kappa, mubar=a.mubar,
                                               epsbar=a.epsbar, t_boundary=tb, lmesh=lmesh,
                                               comm_policy=policy)

            def tune_operands():
                """The doublet operator's apply under either policy."""
                b = torch.ones((2, 2, 4, 3, *lmesh.local_lat.site_shape), dtype=sloppy,
                               device=device)
                return ({p: (lambda x, op=make_op(p): op.apply(fields_s, x))
                         for p in ("fused", "overlap")}, b, "ndeg")
            policy = comm_policy(cfg, lmesh, device, tune_operands)
            op = make_op(policy)
            sync(device)
        log.info("ndeg lattice mesh: %d x %d x %d ranks over (T, Z, Y), comm_policy %s -> "
                 "%s", m.nt, m.nz, m.ny, cfg.solver.comm_policy, policy)
        setup_seconds["halo"] = prof.times["halo"]
        with prof.phase("solve"):
            res = solve_ndeg_tm_sharded(op, fields_s, fields_hp, local_shard(b_pk, lmesh),
                                        **solver_kw)
            sync(device)
        x = lmesh.gather(res.x)
    else:
        with prof.phase("solve"):
            res = solve_ndeg_tm(u_pk, b_pk, lat, kappa=a.kappa, mubar=a.mubar, epsbar=a.epsbar,
                                sloppy_dtype=sloppy, t_boundary=tb, **solver_kw)
            sync(device)
        x = res.x
    t = prof.times["solve"]
    log.info("ndeg solve: relres=%.2e iters=%d refinements=%d", res.relres, res.iters,
             res.refinements)
    rel = float("nan")
    if x is not None:
        rel = ndeg_full_relres(u_pk, b_pk, x, lat, kappa=a.kappa, mubar=a.mubar,
                               epsbar=a.epsbar)
    rel = tdist.broadcast_float(rel, device)
    if tdist.rank() == 0:
        log.info("wallclock %.3f s, certified doublet |r|/|b| = %.3e", t, rel)
        print(f"RESULT solve_seconds={t:.3f} relres={rel:.3e} dims={lat.dims} "
              f"tol={cfg.solver.tol} ndeg=1")
    return InvertResult(seconds=t, relres=rel, solver_relres=res.relres, iters=res.iters,
                        refinements=res.refinements, gflops=0.0, x=x, plaquette=plaq,
                        setup_seconds=setup_seconds, u_pk=u_pk, b_pk=b_pk)


if __name__ == "__main__":
    main()
