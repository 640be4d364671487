"""One certified twisted-mass or twisted-clover solve against a random
source, with the iteration count, the certified full-system residual and
GFLOP/s.

    python -m tpuqcd_torch.cli.run_invert --config examples/invert.yaml
    python -m tpuqcd_torch.cli.run_invert --config examples/invert_mg.yaml --device cpu

Counterpart of ``tpuqcd/cli/run_invert.py``: with ``mg.enabled`` the
MG-preconditioned solve (its hierarchy set up before the timed solve),
else the direct even-odd packed path; ``action.csw`` != 0 solves the
twisted-clover system on either (the clover construction of the direct
path is built before the timed solve).  Prints the same
``RESULT solve_seconds=... relres=... gflops=...`` line; relres is an
independent float64 |b - M x| / |b| of the two-parity system, with the
clover term when csw != 0.  gflops counts the twisted-mass Dslash flops
of the sloppy matvecs, as tpuqcd does, for clover too.
"""
from __future__ import annotations

import dataclasses

import torch

from ..solve import full_system_relres, make_clover_fields, solve_tm
from ..utils.config import RunConfig
from ..utils.profile import Profile, solve_flops, sync
from .common import (Gauge, MGSolver, check_in_slice, log, parse_args, random_source,
                     setup_gauge)


@dataclasses.dataclass(frozen=True)
class InvertResult:
    seconds: float         # solve wallclock, host clock, device synchronised
    relres: float          # certified full-system |b - M x| / |b|, float64
    solver_relres: float   # the solver's certified residual (eo system for CG)
    iters: int             # sloppy matvecs (CG) or inner GCR iterations (MG)
    refinements: int
    gflops: float          # 0.0 for MG, whose flops are not counted (as in tpuqcd)
    x: torch.Tensor        # solution [2(par), 2(ri), 4, 3, T, Z, S] float64
    plaquette: float
    #: seconds of the stages before the solve: "gauge", for MG the
    #: hierarchy's "nulls0", "galerkin0", ... and their sum "mg_setup", for
    #: a direct clover solve the clover construction "clover"
    setup_seconds: dict
    u_pk: torch.Tensor     # the packed float32 gauge the solve ran on
    b_pk: torch.Tensor     # the packed float32 source


def main(argv=None):
    cfg, device = parse_args(__doc__, argv)
    invert(cfg, device)


def invert(cfg: RunConfig, device: torch.device, gauge: Gauge | None = None) -> InvertResult:
    """The solve of ``cfg`` on ``device``; ``gauge``, what setup_gauge(cfg,
    device) returned before, saves generating it again."""
    check_in_slice(cfg)
    log.info("solver.backend=%s selects nothing in the port: the tensors' device "
             "(%s) runs the CUDA kernel or, on the CPU, its plain version",
             cfg.solver.backend, device)
    lat, u_pk, plaq, gauge_seconds = setup_gauge(cfg, device) if gauge is None else gauge
    b_pk = random_source(lat, device)
    kappa, mu, csw = cfg.action.kappa, cfg.action.mu, cfg.action.csw
    setup_seconds = {"gauge": gauge_seconds}
    prof = Profile()
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
                        setup_seconds=setup_seconds, u_pk=u_pk, b_pk=b_pk)


if __name__ == "__main__":
    main()
