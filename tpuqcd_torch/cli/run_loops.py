"""Disconnected-loop production run (BASELINE config 5's disconnected part).

Counterpart of ``tpuqcd/cli/run_loops.py``'s device estimator path
(``_run_device``, :115-238): gauge -> with physics.n_deflate > 0 the
deflation basis (packed Lanczos on M_d M_d^dag, or the eigenpairs of
physics.eig_infile; physics.eig_outfile keeps them) -> per Z4 noise its
time and spin-colour dilution classes, deflated, solved as one batch with
(M_d^dag)^{-1} = g5 M_u^{-1} g5 -> the one-end loops of the 16 ultra-local
and the 64 one-derivative insertions -> with physics.tsm_cheap > 0 the
truncated solves of tsm_cheap cheap noises and of the same noises, E =
E_cheap + (E_full - E_cheap, on the same noises) -> with deflation the
exact low-mode part from the solves w_i = (M_d^dag)^{-1} v_i -> HDF5; once
per member of an ensemble (common.ensemble_members), each into its own
physics.output.  The low-mode part is solved, not taken as diag(1/lambda),
so the estimate is unbiased for any orthonormal basis: eigenpairs of
physics.eig_infile from another member's gauge deflate less, and change
no expectation value.

    python -m tpuqcd_torch.cli.run_loops --config examples/loops.yaml
    python -m tpuqcd_torch.cli.run_loops --config examples/loops_strange.yaml --device cpu

With a mesh of more than one rank (``mesh.nt/nz/ny``; torchrun, one
process per card, NCCL, or gloo with ``--device cpu``) each rank holds
only its block of every noise, source, solution and eigenvector: the
noises and the Lanczos start vector are drawn whole on every rank and
cut, the Lanczos sums and the deflation coefficients are summed over the
ranks, the columns go one at a time through the sharded solver, the
truncated TSM solves through solve_tm_sharded, the covariant derivative
reads a ghost layer and the projections' [n_mom, T] partial sums are
summed over the ranks.  The one field gathered is the basis of
physics.eig_outfile, a vector at a time to rank 0, which writes it in the
one-card file's format; rank 0 alone writes the loops.

    torchrun --nproc_per_node 2 -m tpuqcd_torch.cli.run_loops \\
        --config examples/loops_mesh.yaml --device cpu

Strange and charm loops (Osterwalder-Seiler) are the same run at the
heavy twisted mass (examples/loops_strange.yaml).  The noise, the cheap
noise and the Lanczos start vector come from CPU generators seeded 17, 23
and 9 (tpuqcd's integers, on torch's stream).  tpuqcd's host path is its
oracle and is not ported: the port's one path runs on the card, or on the
CPU through the kernel's plain version.  Datasets, as tpuqcd names them,
each insertion complex [n_mom, T]:

    loops/oneend/<insertion>
    loops/oneend_der/<insertion>_D<nu>
    loops/oneend_lowmode/<insertion>                (n_deflate > 0)
    loops/oneend_lowmode_der/<insertion>_D<nu>      (n_deflate > 0)
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ..gammas import G5_DIAG, INSERTION_GAMMAS
from ..io.hdf5io import write_loops
from ..parallel import dist as tdist
from ..phys.loops_dev import (make_deflate_pk, oneend_lowmode_exact_pk, stochastic_oneend_pk,
                              z4_noises)
from ..utils.config import RunConfig
from ..utils.profile import Profile
from .common import (Gauge, check_in_slice, ensemble_members, log, make_solver, parse_args,
                     setup_gauge)
from .run_twop import mesh_of, stage_timer

#: seeds of the noise, the cheap TSM noise and the Lanczos start vector
#: (tpuqcd/cli/run_loops.py:69-71, :191-194)
NOISE_SEED, CHEAP_SEED, LANCZOS_SEED = 17, 23, 9


@dataclasses.dataclass(frozen=True)
class LoopsResult:
    #: dataset ("loops/oneend", ...) -> {insertion: complex128 [n_mom, T]}
    loops: dict
    #: the attributes of every dataset (tpuqcd's)
    meta: dict
    #: seconds by stage, host clock, device synchronised: gauge, lanczos,
    #: tsm_cheap, solves, solves_correction, lowmode, loops, derivatives
    #: (and write, once written)
    seconds: dict
    #: one entry per solver call of the full and low-mode solves
    #: (cli/common.Solver.records); the cheap solves are not certified
    solves: list
    momenta: np.ndarray
    plaquette: float
    #: the deflation basis' eigenvalues: Rayleigh quotients on M_d M_d^dag,
    #: or those of eig_infile (None without deflation)
    evals: np.ndarray | None
    #: with TSM, the ultra-local loops of the correction noises from the
    #: full ("full") and the cheap ("cheap") solves
    tsm: dict | None
    #: kept only with keep_fields: the packed float32 gauge and the basis
    #: in the MG layout of eig_outfile, [n, 2(ri), 2(par), 4, 3, T, Z, S]
    #: (on a mesh this rank's blocks)
    u_pk: torch.Tensor | None = None
    evecs: torch.Tensor | None = None


def _g5(device) -> torch.Tensor:
    return torch.tensor(G5_DIAG, dtype=torch.float32, device=device).view(4, 1, 1, 1, 1)


def deflation_basis(cfg: RunConfig, lat, u_pk: torch.Tensor, lmesh=None,
                    comm_policy: str = "fused"):
    """(evals, evecs [n_deflate, 2(ri), 2(par), 4, 3, T, Z, S] float32): read
    from physics.eig_infile, or the packed Lanczos on M_d M_d^dag =
    M_d (g5 M_u g5) on the fine level of the action (n_iter = max(40, 3
    n_deflate)), saved to physics.eig_outfile when set.  On a mesh
    (``lmesh``) evecs are this rank's blocks: the fine level is
    mg/shard.ShardedFineLevel under ``comm_policy``, the start vector is
    drawn whole and cut, every rank reads eig_infile and keeps its blocks,
    and eig_outfile gets the basis gathered to rank 0 (save_eigenpairs)."""
    from ..solvers.lanczos import lanczos_lowest_pk
    from ..utils.checkpoint import load_eigenpairs, save_eigenpairs
    from .common import _mg_fine_level
    ph, device = cfg.physics, u_pk.device
    if ph.eig_infile:
        evals, evecs = load_eigenpairs(ph.eig_infile, expect_layout="packed",
                                       n_expect=ph.n_deflate, lmesh=lmesh)
        log.info("loaded %d deflation eigenpairs from %s", len(evecs), ph.eig_infile)
        return np.asarray(evals, np.float64), torch.stack(evecs).to(device)
    lv_p, lv_m = (_mg_fine_level(cfg, lat, u_pk, f, lmesh, comm_policy) for f in (+1, -1))
    g5 = _g5(device)[None]                 # MG layout [2(ri), 2(par), 4, 3, T, Z, S]

    def apply_mmdag(v):
        return lv_m.apply(g5 * lv_p.apply(g5 * v))

    gen = torch.Generator().manual_seed(LANCZOS_SEED)
    v0 = torch.randn((2, 2, 4, 3, *lat.site_shape), generator=gen)
    v0 = (v0 if lmesh is None else lmesh.shard(v0)).to(device)
    log.info("packed Lanczos deflation: %d modes", ph.n_deflate)
    evals, evecs = lanczos_lowest_pk(apply_mmdag, v0, ph.n_deflate,
                                     n_iter=max(40, 3 * ph.n_deflate), lmesh=lmesh)
    log.info("deflation basis ready (lowest Ritz value %.3e)", evals[0])
    if ph.eig_outfile:
        save_eigenpairs(ph.eig_outfile, evals, evecs, layout="packed", lmesh=lmesh)
        log.info("wrote deflation eigenpairs -> %s", ph.eig_outfile)
    return evals, evecs


def _tsm_combine(a, b_full, b_cheap):
    """E[full] = E_cheap[truncated] + E_corr[full - truncated], per dataset."""
    return {k: a[k] + (b_full[k] - b_cheap[k]) for k in a}


def measure(cfg: RunConfig, device: torch.device, gauge: Gauge | None = None,
            keep_fields: bool = False, audit=None, lmesh=None) -> LoopsResult:
    """The loop measurement of ``cfg`` on ``device``.  ``gauge``, what
    setup_gauge(cfg, device) returned before, saves generating it again;
    ``audit`` goes to the solver (Solver.audit: every full and low-mode
    column, its source g5 b and float64 solution).  On the mesh of
    cfg.mesh, or ``lmesh`` (a LatticeMesh; one rank runs the mesh path
    too), the fields, kept ones included, are this rank's blocks and every
    rank returns the whole loops."""
    check_in_slice(cfg)
    ph, a = cfg.physics, cfg.action
    lat, u_pk, plaq, gauge_seconds = setup_gauge(cfg, device) if gauge is None else gauge
    solve = make_solver(cfg, lat, u_pk, lmesh)
    solve.audit = audit
    lmesh = mesh_of(solve, plaq)
    momenta = np.asarray(ph.momenta)
    prof = Profile()
    prof.times["gauge"] = gauge_seconds
    stage = stage_timer(prof, device)
    g5 = _g5(device)

    def solve_ddag_batch(b_pks):
        """(M_d^dag)^{-1} b = g5 M_u^{-1} g5 b, batched."""
        return solve.packed_src_batch(b_pks * g5, flavor=+1) * g5

    def cheap_batch(b_pks):
        """The truncated TSM solve, uncertified by design (run_loops.py:134-154)."""
        return solve.truncated_batch(b_pks * g5, +1, ph.tsm_tol, ph.tsm_maxiter_cheap) * g5

    evals = evecs = deflate = None
    if ph.n_deflate > 0:
        with stage("lanczos"):
            evals, evecs = deflation_basis(cfg, lat, u_pk, lmesh, solve.policy)
            evecs_solver = evecs.transpose(1, 2).contiguous()     # -> [n, 2(par), 2(ri), ...]
            deflate = make_deflate_pk(evecs_solver, lmesh)

    def timed(name, fn):
        def run(*args):
            with stage(name):
                return fn(*args)
        return run

    def estimate(seed, n, name, solve_fn):
        return stochastic_oneend_pk(
            z4_noises(seed, n, lat, device, lmesh), timed(name, solve_fn), INSERTION_GAMMAS,
            lat, momenta, a.kappa, a.mu, u_pk=u_pk, derivs=True, dilute_t=ph.dilute_t,
            dilute_sc=bool(ph.dilute_sc),
            deflate_fn=None if deflate is None else timed(name, deflate),
            timer=stage, lmesh=lmesh)

    tsm = None
    if ph.tsm_cheap > 0:
        log.info("TSM: %d cheap + %d correction noises", ph.tsm_cheap, ph.n_noise)
        est_c, der_c = estimate(CHEAP_SEED, ph.tsm_cheap, "tsm_cheap", cheap_batch)
        est_f, der_f = estimate(NOISE_SEED, ph.n_noise, "solves", solve_ddag_batch)
        est_fc, der_fc = estimate(NOISE_SEED, ph.n_noise, "solves_correction", cheap_batch)
        est, der = _tsm_combine(est_c, est_f, est_fc), _tsm_combine(der_c, der_f, der_fc)
        tsm = {"full": est_f, "cheap": est_fc}
    else:
        est, der = estimate(NOISE_SEED, ph.n_noise, "solves", solve_ddag_batch)
    loops = {"loops/oneend": est, "loops/oneend_der": der}
    if evecs is not None:
        log.info("exact low-mode one-end part (%d production solves)", evecs.shape[0])
        low, low_der = oneend_lowmode_exact_pk(
            evecs_solver, timed("lowmode", solve_ddag_batch), INSERTION_GAMMAS, lat, momenta,
            a.kappa, a.mu, u_pk=u_pk, derivs=True, timer=stage, lmesh=lmesh)
        loops.update({"loops/oneend_lowmode": low, "loops/oneend_lowmode_der": low_der})
    meta = {"n_noise": ph.n_noise, "kappa": a.kappa, "mu": a.mu, "tsm_cheap": ph.tsm_cheap,
            "n_deflate": ph.n_deflate, "dilute_t": ph.dilute_t,
            "dilute_sc": int(bool(ph.dilute_sc))}

    def host(d):
        return {k: v.cpu().numpy() for k, v in d.items()}
    return LoopsResult(
        loops={name: host(d) for name, d in loops.items()}, meta=meta,
        seconds=dict(prof.times), solves=solve.records, momenta=momenta, plaquette=plaq,
        evals=evals, tsm=None if tsm is None else {k: host(v) for k, v in tsm.items()},
        u_pk=u_pk if keep_fields else None, evecs=evecs if keep_fields else None)


def write(cfg: RunConfig, result: LoopsResult) -> None:
    """Every dataset into physics.output with write_loops (one dataset per
    insertion, the meta as attributes); adds the seconds to result.seconds
    as "write".  On a mesh rank 0 alone writes."""
    if tdist.rank() != 0:
        return
    t0 = time.perf_counter()
    out = cfg.physics.output
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    for group, loops in result.loops.items():
        names = list(loops)
        write_loops(out, group, np.stack([loops[k] for k in names]), names, meta=result.meta)
    result.seconds["write"] = time.perf_counter() - t0
    log.info("wrote loops -> %s", out)


def main(argv=None):
    cfg, device = parse_args(__doc__, argv)
    try:
        for ctag, c in ensemble_members(cfg, device):
            if ctag:
                log.info("=== ensemble member %s ===", ctag)
            result = measure(c, device)
            write(c, result)
            log.info("seconds by stage: %s", {k: round(v, 3) for k, v in result.seconds.items()})
    finally:
        tdist.shutdown()


if __name__ == "__main__":
    main()
