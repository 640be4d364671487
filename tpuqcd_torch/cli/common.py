"""Shared CLI plumbing: arguments, device, scope checks, ensemble members,
gauge setup (an ILDG file, a heatbath, random links; gauge fixing),
the solver.

Counterpart of ``tpuqcd/cli/common.py:21-781``.  The
device is explicit: ``--device`` defaults to ``cuda`` and raises when
CUDA is missing; ``--device cpu`` runs the plain PyTorch versions.
Under torchrun every rank joins the process group first (NCCL for cuda,
gloo for cpu), and ``--device cuda`` means cuda:LOCAL_RANK.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import logging
import os
import sys
import time
from typing import NamedTuple

import torch

from .. import su3
from ..fields import apply_boundary_phase, gauge_eo_to_full, gauge_full_to_eo
from ..lattice import Lattice
from ..ops.gauge_tools import plaquette
from ..ops.layout import gauge_from_device, gauge_to_device
from ..parallel.dist import init_distributed
from ..phys.propagator import full_to_packed
from ..utils.config import ConfigError, RunConfig, load_config
from ..utils.packed import pack_gauge, unpack_gauge
from ..utils.profile import sync

log = logging.getLogger("tpuqcd_torch")


def parse_args(description: str, argv=None) -> tuple[RunConfig, torch.device]:
    ap = argparse.ArgumentParser(description=description,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True, help="YAML run config")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cuda:N runs the kernels; cpu runs "
                         "their plain PyTorch versions")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s",
                        stream=sys.stdout)
    device = resolve_device(args.device)
    rank_device = init_distributed(device.type)
    return load_config(args.config), rank_device or device


def resolve_device(name) -> torch.device:
    """torch.device for ``name``; a CUDA device without CUDA raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not available "
                           f"(torch {torch.__version__}); use --device cpu for the "
                           "plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {name!r}")
    return dev


def is_mesh(cfg: RunConfig) -> bool:
    """Whether cfg.mesh spans several ranks (as in tpuqcd, a mesh of one
    device is no mesh)."""
    return cfg.mesh.nt * cfg.mesh.nz * cfg.mesh.ny > 1


def _sloppy_dtype(cfg: RunConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.solver.sloppy_dtype == "bfloat16" else torch.float32


def check_in_slice(cfg: RunConfig, threep: bool = False) -> None:
    """Refuse, with ``threep`` (the three-point run), a configuration without
    physics.t_sinks.  Every other configuration of tpuqcd's is in the
    port's slice, MG's bfloat16 solver buffers (mg.gcr_dtype, vec_dtype)
    and a mesh included; what tpuqcd refuses on a mesh (MG vector files,
    eigCG with clover) the solver refuses (MGSolver, Solver)."""
    if threep and not cfg.physics.t_sinks:
        raise ConfigError("physics.t_sinks is empty: the three-point run needs at least one "
                          "sink timeslice")


def ensemble_members(cfg: RunConfig, device: torch.device):
    """Yield (ctag, cfg_member) for each gauge configuration of an ensemble
    run, or a single ("", cfg) in single-config mode
    (tpuqcd/cli/common.py:80-121).

    Members come from gauge.config_files (ctag: the file's stem), from
    gauge.random_seeds ("s<seed>") or, with gauge.heatbath_beta and
    heatbath_n_cfg > 1, from one heatbath chain generated on ``device``
    ("c<i:04d>", _heatbath_chain_members).  Member i's physics.output gets
    ".<ctag>" before its suffix; with files, member i+1's file is read
    on a background thread while member i runs, started once member i's
    own read is taken (io/prefetch.prefetch_after).  Other
    output and input files (mg.vec_outfile / vec_infile,
    physics.eig_outfile / eig_infile) keep one name for all members, as
    in tpuqcd: the vectors precondition or deflate, and a member's result
    does not depend on them."""
    g = cfg.gauge
    files, seeds = tuple(g.config_files), tuple(g.random_seeds)
    hb_chain = g.heatbath_beta is not None and g.heatbath_n_cfg > 1
    if not files and not seeds and not hb_chain:
        yield "", cfg
        return
    if hb_chain:
        members = _heatbath_chain_members(cfg, device)
        files = tuple(m[1].config_file for m in members)
    elif files:
        members = [(os.path.splitext(os.path.basename(f))[0],
                    dataclasses.replace(g, config_file=f)) for f in files]
    else:
        members = [(f"s{int(s)}", dataclasses.replace(g, random_seed=int(s))) for s in seeds]
    root, ext = os.path.splitext(cfg.physics.output)
    for i, (ctag, g_i) in enumerate(members):
        if files and i + 1 < len(members):
            from ..io.prefetch import prefetch_after
            prefetch_after(g_i.config_file, members[i + 1][1].config_file)
        ph = dataclasses.replace(cfg.physics, output=f"{root}.{ctag}{ext}")
        yield ctag, dataclasses.replace(cfg, gauge=g_i, physics=ph)


def _heatbath_chain_members(cfg: RunConfig, device: torch.device, keep: list | None = None):
    """The members of ONE heatbath Markov chain (ops/heatbath.generate_ensemble:
    gauge.heatbath_sweeps to thermalize, then a member every heatbath_skip
    compound sweeps, the generator on ``device`` seeded with
    gauge.random_seed, so member 0 is setup_gauge's heatbath gauge), each
    written to ILDG as hb_b<beta>_<i:04d>.lime under gauge.heatbath_dir
    (default '<output dir>/ensemble').  Returns [(ctag, gauge params)]
    whose config_file re-reads the member through the ILDG reader with
    plaquette_check pinned to the generated plaquette
    (tpuqcd/cli/common.py:124-178).  ``keep``, a list, receives per member
    a dict: its in-memory device-layout links "links", "path",
    "plaquette", "sweeps_seconds" (its sweeps, host clock, device
    synchronised) and "write" (write_ildg_gauge's seconds by stage; empty
    on a rank that does not write).

    Under torchrun (tpuqcd is single-controller) every rank runs the same
    chain on its own device from the same seed, and rank 0 alone writes
    each member.  After each write one all-reduce (parallel/dist.
    rank0_outcome) hands every rank the plaquette rank 0 computed, and
    raises on every rank if the member failed on any of them.  The ranks
    reach that collective after the same sweeps, so none waits in it
    longer than rank 0's write of one member; every rank then reads the
    members' files as it reads gauge.config_files."""
    from ..io.lime import write_ildg_gauge
    from ..ops.heatbath import generate_ensemble
    from ..parallel import dist as tdist
    g = cfg.gauge
    lat = Lattice(tuple(g.dims))
    out_dir = g.heatbath_dir or os.path.join(os.path.dirname(cfg.physics.output) or ".",
                                             "ensemble")
    writer = tdist.rank() == 0

    def settled(failure, value, what):
        """rank 0's value, once every rank knows whether ``what`` failed on any."""
        failed, value = tdist.rank0_outcome(value, failure is not None, device)
        if failure is not None:
            raise failure
        if failed:
            raise RuntimeError(f"{what} failed on {failed} of {tdist.world_size()} ranks")
        return value

    failure = None
    if writer:
        try:
            os.makedirs(out_dir, exist_ok=True)
        except OSError as e:
            failure = e
    settled(failure, 0.0, f"the heatbath chain's directory {out_dir}")
    gen = torch.Generator(device=device).manual_seed(int(g.random_seed))
    chain = generate_ensemble(gen, lat, g.heatbath_beta, g.heatbath_n_cfg,
                              n_therm=g.heatbath_sweeps, n_skip=g.heatbath_skip)
    members = []
    t0 = time.perf_counter()
    for i in range(g.heatbath_n_cfg):
        path = os.path.join(out_dir, f"hb_b{g.heatbath_beta:g}_{i:04d}.lime")
        failure, plaq, wr = None, float("nan"), {}
        try:
            u_dev = next(chain)
            sync(device)
            sweeps_s = time.perf_counter() - t0
            plaq = plaquette(u_dev, lat)
            if writer:
                wr = write_ildg_gauge(path, gauge_eo_to_full(gauge_from_device(u_dev, lat), lat),
                                      lat)
        except Exception as e:      # raised by settled, once every rank knows of it
            failure = e
        plaq = settled(failure, plaq, f"heatbath chain member {i} ({path})")
        log.info("heatbath chain member %d -> %s (plaquette %.8f; sweeps %.3f s, %s)", i, path,
                 plaq, sweeps_s,
                 f"write {sum(wr.values()):.3f} s" if writer else "written by rank 0")
        if keep is not None:
            keep.append({"links": u_dev, "path": path, "plaquette": plaq,
                         "sweeps_seconds": sweeps_s, "write": wr})
        members.append((f"c{i:04d}", dataclasses.replace(g, heatbath_beta=None, config_file=path,
                                                          plaquette_check=plaq)))
        t0 = time.perf_counter()
    return members


class Gauge(NamedTuple):
    lat: Lattice
    u_pk: torch.Tensor     # packed float32 [4, 2, 3, 3, 2, T, Z, S], boundary phase in
    plaquette: float
    #: generation or read and decode, and the gauge fix: host clock, device
    #: synchronised
    seconds: float


def _read_gauge(path: str, lat: Lattice, device: torch.device, detail: dict) -> torch.Tensor:
    """The ILDG file's unphased complex device-layout links on ``device``:
    the payload from io/prefetch.take (the read-ahead's, or read now),
    decoded on the device; a file whose lattice is not gauge.dims raises."""
    from ..io.native import ildg_payload_to_device
    from ..io.prefetch import take
    t0 = time.perf_counter()
    payload = take(path)
    t1 = time.perf_counter()
    if payload.lat.dims != lat.dims:
        raise ConfigError(f"{path} holds a {payload.lat.dims} lattice, but gauge.dims is "
                          f"{lat.dims}, on which the configuration was validated")
    u_dev = ildg_payload_to_device(payload.data, lat, payload.precision, device)
    sync(device)
    detail.update(take=t1 - t0, read=payload.seconds["read"],
                  checksum=payload.seconds["checksum"], decode=time.perf_counter() - t1,
                  scidac_checksum=payload.checksum)
    log.info("loaded gauge %s dims=%s (%d bit): take %.3f s (read %.3f s, checksum %.3f s), "
             "decode on %s %.3f s", path, lat.dims, payload.precision, detail["take"],
             detail["read"], detail["checksum"], device, detail["decode"])
    return u_dev


def setup_gauge(cfg: RunConfig, device: torch.device, detail: dict | None = None) -> Gauge:
    """The gauge of gauge.*: the ILDG file gauge.config_file (decoded on
    ``device``), a quenched heatbath at gauge.heatbath_beta (thermalized on
    ``device`` from a cold start, the generator seeded with
    gauge.random_seed), else random SU(3) links from gauge.random_seed;
    then the plaquette check, with gauge.fix the Landau or Coulomb gauge
    fix on ``device``, and the boundary phase.  ``detail``, a dict,
    receives the seconds of a file's "take" (the host's wait), "read",
    "checksum" and "decode" and its verified "scidac_checksum" (None if the
    file carried none), and of a fix "fix_seconds", "fix_sweeps",
    and the functional before ("fix_initial") and after each sweep
    ("fix_history")."""
    detail = {} if detail is None else detail
    g = cfg.gauge
    lat = Lattice(tuple(g.dims))
    t0 = time.perf_counter()
    if g.config_file:
        u_dev = _read_gauge(g.config_file, lat, device, detail)
    elif g.heatbath_beta is not None:
        from ..ops.heatbath import thermalize
        gen = torch.Generator(device=device).manual_seed(int(g.random_seed))
        u_dev = thermalize(gen, lat, g.heatbath_beta, g.heatbath_sweeps)
        sync(device)
        log.info("heatbath gauge dims=%s beta=%.3f sweeps=%d seed=%d", lat.dims,
                 g.heatbath_beta, g.heatbath_sweeps, g.random_seed)
    else:
        gen = torch.Generator().manual_seed(int(g.random_seed))
        u_dev = gauge_to_device(gauge_full_to_eo(su3.random_gauge(lat, gen, device), lat),
                                lat)
        log.info("generated random gauge dims=%s seed=%d", lat.dims, g.random_seed)
    seconds = time.perf_counter() - t0
    plaq = plaquette(u_dev, lat)
    log.info("plaquette = %.8f", plaq)
    if g.plaquette_check is not None and abs(plaq - g.plaquette_check) > 1e-5:
        raise RuntimeError(f"plaquette check failed: {plaq} != {g.plaquette_check}")
    if g.fix:
        # before the boundary phase, on the periodic links (tpuqcd/cli/common.py:253-268)
        from ..ops.gauge_fix import functional, gauge_fix
        t0 = time.perf_counter()
        f0 = functional(u_dev, lat, g.fix)
        u_dev, hist = gauge_fix(u_dev, lat, gauge=g.fix, n_sweeps=g.fix_sweeps, tol=g.fix_tol)
        sync(device)
        fix_s = time.perf_counter() - t0
        seconds += fix_s
        detail.update(fix_seconds=fix_s, fix_sweeps=len(hist), fix_initial=f0,
                      fix_history=hist)
        log.info("%s gauge fixing: %d sweeps, functional %.8f -> %.8f, %.3f s", g.fix,
                 len(hist), f0, hist[-1] if hist else f0, fix_s)
    u_dev = apply_boundary_phase(u_dev, lat, "device", g.antiperiodic_t)
    return Gauge(lat, pack_gauge(u_dev, torch.float32).contiguous(), plaq, seconds)


def smeared_gauge(cfg: RunConfig, lat: Lattice, u_pk: torch.Tensor) -> torch.Tensor:
    """The APE- or stout-smeared links of the Gaussian smearing
    (physics.smear_type, smear_n_ape steps, spatial links over spatial
    staples), packed float32 [4, 2, 3, 3, 2, T, Z, S] without a boundary
    phase, from the run's packed gauge (whose phase is taken off first)."""
    ph = cfg.physics
    u_dev = apply_boundary_phase(unpack_gauge(u_pk), lat, "device", cfg.gauge.antiperiodic_t)
    if ph.smear_n_ape > 0 and ph.smear_type == "stout":
        from ..ops.gauge_tools import stout_smear
        log.info("stout smearing: rho=%.3f n=%d", ph.smear_rho_stout, ph.smear_n_ape)
        u_dev = stout_smear(u_dev, lat, rho=ph.smear_rho_stout, n_steps=ph.smear_n_ape,
                            spatial_only=True)
    elif ph.smear_n_ape > 0:
        from ..ops.gauge_tools import ape_smear
        log.info("APE smearing: alpha=%.3f n=%d", ph.smear_alpha_ape, ph.smear_n_ape)
        u_dev = ape_smear(u_dev, lat, alpha=ph.smear_alpha_ape, n_steps=ph.smear_n_ape)
    return pack_gauge(u_dev, torch.float32).contiguous()


def _mg_fine_level(cfg: RunConfig, lat: Lattice, u_pk: torch.Tensor, flavor: int,
                   lmesh=None, comm_policy: str = "fused"):
    """The twisted-mass or, with action.csw, the twisted-clover fine level
    of the action config; the A blocks come from the float32 gauge.  With
    a LatticeMesh the level of this rank's shard (mg/shard.ShardedFineLevel,
    its hops under ``comm_policy``)."""
    from ..mg.device import DeviceFineCloverLevel, DeviceFineLevel
    a, u32 = cfg.action, u_pk.to(torch.float32)
    tb = -1 if cfg.gauge.antiperiodic_t else 1
    cl_pk = None
    if a.csw != 0.0:
        from ..solve import clover_pk_from_gauge
        cl_pk = clover_pk_from_gauge(u32, lat, kappa=a.kappa, csw=a.csw)
    if lmesh is not None:
        from ..mg.shard import ShardedFineLevel
        from ..parallel.dist import local_shard
        return ShardedFineLevel.build(
            lmesh, local_shard(u32, lmesh), a.kappa, a.mu, flavor, tb, comm_policy,
            None if cl_pk is None else local_shard(cl_pk, lmesh))
    if cl_pk is not None:
        return DeviceFineCloverLevel(lat, u32, cl_pk, a.kappa, a.mu, flavor=flavor,
                                     t_boundary=tb)
    return DeviceFineLevel(lat, u32, a.kappa, a.mu, flavor, t_boundary=tb)


def comm_policy(cfg: RunConfig, lmesh, device: torch.device, tune_operands=None) -> str:
    """The communication policy of the sharded hops
    (tpuqcd/cli/common.py:552-584): a y-sharded mesh takes overlap (the
    halo kernel has no y faces); solver.comm_policy fused or overlap is
    taken as it is; auto takes fused on one rank and on the CPU, else the
    faster on the cards: ``tune_operands()`` gives (the operator of either
    policy by name -> one apply, a shard to apply it to, the cache tag)
    for utils/tune.tune_comm_policy."""
    if lmesh.ny > 1:
        return "overlap"
    if cfg.solver.comm_policy in ("fused", "overlap"):
        return cfg.solver.comm_policy
    if lmesh.size == 1 or device.type != "cuda" or tune_operands is None:
        return "fused"
    from ..utils.tune import tune_comm_policy
    fns, b_loc, tag = tune_operands()
    winner = tune_comm_policy(lmesh.lat, lmesh, fns, b_loc, tag=tag)
    log.info("comm_policy auto -> %s", winner)
    return winner


def _tuning(cfg: RunConfig, lmesh, halo_gauge, u_pk: torch.Tensor, clover=None):
    """tune_operands for comm_policy: the sloppy operator of the action
    (twisted mass, or twisted clover with action.csw: cache tag "tm" or
    "clover") applied under either policy; ``halo_gauge()`` gives the
    float64 HaloGauge, ``clover`` make_clover_fields's fields when the
    caller has them (else they are made here)."""
    from ..parallel.dist import local_shard
    from ..parallel.sharded import (ShardedTMCloverOperatorPC, ShardedTMOperatorPC,
                                    clover_fields_to)
    a, tb = cfg.action, -1 if cfg.gauge.antiperiodic_t else 1
    sdt = _sloppy_dtype(cfg)

    def operands():
        ug = halo_gauge()
        if a.csw == 0.0:
            cls, tag, fields = ShardedTMOperatorPC, "tm", ug.to(sdt, rows=2)
        else:
            from ..solve import make_clover_fields
            cl = clover if clover is not None else make_clover_fields(
                u_pk, lmesh.lat, kappa=a.kappa, mu=a.mu, csw=a.csw)
            cls, tag = ShardedTMCloverOperatorPC, "clover"
            fields = clover_fields_to((ug, *(local_shard(c, lmesh) for c in cl)), sdt, rows=2)
        ops = {p: cls(lmesh.lat, kappa=a.kappa, mu=a.mu, t_boundary=tb, lmesh=lmesh,
                      comm_policy=p) for p in ("fused", "overlap")}
        b = torch.ones((2, 4, 3, *lmesh.local_lat.site_shape), dtype=sdt, device=ug.u.device)
        return {p: (lambda x, op=op: op.apply(fields, x)) for p, op in ops.items()}, b, tag
    return operands


def mg_params(cfg: RunConfig):
    from ..mg.dsolve import DeviceMGParams
    m = cfg.mg
    return DeviceMGParams(n_vec=tuple(m.n_vec), block=tuple(m.block),
                          setup_iters=m.setup_iters, smoother_iters=m.smoother_iters,
                          coarse_iters=m.coarse_maxiter, restart=m.restart,
                          mu_factor=m.mu_factor, setup_solver=m.setup_solver,
                          smoother_dtype=m.smoother_dtype, coarse_dtype=m.coarse_dtype,
                          gcr_dtype=m.gcr_dtype, vec_dtype=m.vec_dtype)


class MGSolver:
    """The MG branch of tpuqcd's make_solver (cli/common.py:380-426):
    solve(b_pk, flavor) for
    packed two-parity sources [2(par), 2(ri), 4, 3, T, Z, S].

    A flavor's hierarchy is set up (or loaded from mg.vec_infile) when a
    solve first asks for it, or by ``setup(flavor)``; tpuqcd builds both
    flavors up front.  The results are the same."""

    def __init__(self, cfg: RunConfig, lat: Lattice, u_pk: torch.Tensor, lmesh=None,
                 comm_policy: str = "fused"):
        self.cfg, self.lat, self.u_pk = cfg, lat, u_pk
        self.lmesh, self.comm_policy = lmesh, comm_policy
        self.params = mg_params(cfg)
        self.hierarchies = {}
        if lmesh is not None and (cfg.mg.vec_infile or cfg.mg.vec_outfile):
            raise NotImplementedError("mg.vec_infile/vec_outfile are single-card: drop them "
                                      "from the config when mesh spans several ranks, as in "
                                      "tpuqcd (cli/common.py:398-401)")

    def setup(self, flavor: int = +1):
        if flavor not in self.hierarchies:
            from ..utils.checkpoint import load_device_mg, save_device_mg
            from ..mg.dsolve import DeviceMG
            m = self.cfg.mg
            lv = _mg_fine_level(self.cfg, self.lat, self.u_pk, flavor, self.lmesh,
                                self.comm_policy)
            if m.vec_infile:
                mg = load_device_mg(f"{m.vec_infile}.f{flavor:+d}.npz", lv, self.params)
                log.info("MG hierarchy loaded (flavor %+d)", flavor)
            else:
                log.info("MG setup (flavor %+d)...", flavor)
                mg = DeviceMG(lv, self.params)
                log.info("MG setup seconds %s", mg.setup_seconds)
                if m.vec_outfile:
                    save_device_mg(f"{m.vec_outfile}.f{flavor:+d}.npz", mg)
            self.hierarchies[flavor] = mg
        return self.hierarchies[flavor]

    def __call__(self, b_pk: torch.Tensor, flavor: int = +1):
        from ..solve import solve_tm_mg
        res = solve_tm_mg(self.setup(flavor), b_pk, tol=self.cfg.solver.tol,
                          inner_tol=self.cfg.solver.inner_tol)
        log.info("  mg solve: relres=%.2e iters=%d refinements=%d", res.relres, res.iters,
                 res.refinements)
        return res

    def solve_batch(self, b_pks: torch.Tensor, flavor: int = +1):
        """The columns b_pks [n, 2(par), 2(ri), ...] in lockstep
        (solve.solve_tm_mg_batch)."""
        from ..solve import solve_tm_mg_batch
        res = solve_tm_mg_batch(self.setup(flavor), b_pks, tol=self.cfg.solver.tol,
                                inner_tol=self.cfg.solver.inner_tol)
        log.info("  mg batch solve (%d rhs): max relres=%.2e iters=%d", b_pks.shape[0],
                 max(res.relres), res.iters[0])
        return res


class Solver:
    """tpuqcd's make_solver (cli/common.py:329-781): the solves of the
    physics programs and of run_invert on packed fields of the run's device.

        solve = make_solver(cfg, lat, u_pk)
        x = solve.packed_src(b_pk, flavor=+1)          # [2(par), 2(ri), ...] float32
        xs = solve.packed_src_batch(b_pks, flavor=-1)  # [n, 2(par), 2(ri), ...] float32
        x = solve.packed(b_full)                       # from a full-layout source
        x_full = solve(b_full)                         # complex128 [T, Z, Y, X, 4, 3]
        res = solve.solve_local(b_loc, flavor=+1)      # on a mesh: this rank's shard
        xs = solve.packed_src_batch(b_locs)            # on a mesh: this rank's blocks
        xs = solve.truncated_batch(b_pks, +1, 1e-3, 50)  # TSM's cheap solves

    With mg.enabled the MG branch (MGSolver; the batch in chunks of
    solver.rhs_batch columns in lockstep); else with solver.solver eigcg
    one solve.EigCGSolver per flavor, whose deflation space grows along
    the columns of a batch, solved one after the other
    (tpuqcd/cli/common.py:479-539); else the direct even-odd
    branch: solve_tm and solve_tm_batch, the clover fields built once,
    and the batch gate of solver.rhs_batch_gate_iters.  ``records`` keeps
    one entry per solver call: flavor, first_column (its index in the
    batch handed to packed_src_batch), columns, the certified relres and
    the count of every column, whether the gate re-chunked, with eigCG the
    size of the deflation space after the solve ("space"), and, with
    ``keep_first``, the float64 solution of its first column as
    ``x_first`` (for an independent residual).  ``audit``, when set, is
    called as audit(b_pks, x, flavor) after every solver call with its
    sources [n, 2(par), 2(ri), ...] and their float64 solutions, before
    these are rounded to float32 (an independent check of every column).

    On a mesh (cfg.mesh of several ranks, or ``lmesh`` given: a one-rank
    mesh runs the same code; tpuqcd/cli/common.py:479-665) every branch
    runs sharded: ``lmesh`` is this rank's LatticeMesh and ``policy`` the
    communication policy (comm_policy), the direct branch
    solve.solve_tm_sharded on the sharded twisted-mass or clover operator,
    the MG branch mg/shard.ShardedFineLevel, eigCG
    solve.ShardedEigCGSolver.  The columns go one at a time; TSM's
    truncated solves (truncated_batch) take the sharded direct operators
    on every branch.  packed_src_batch takes this rank's blocks of the
    sources and returns its blocks of the solutions (the physics programs;
    every rank calls it); records, keep_first's x_first and the audit see
    the blocks too (an audit that needs whole fields gathers them itself:
    it is a check, not the path).  packed_src takes a whole source (every
    rank holds the same), shards it and returns the whole solution on
    every rank."""

    keep_first = False
    audit = None

    def __init__(self, cfg: RunConfig, lat: Lattice, u_pk: torch.Tensor, lmesh=None):
        self.cfg, self.lat, self.u_pk = cfg, lat, u_pk
        self.rhs_batch = max(1, int(cfg.solver.rhs_batch))
        self.records: list[dict] = []
        self.lmesh, self.policy = lmesh, None
        if lmesh is None and is_mesh(cfg):
            from ..parallel.mesh import LatticeMesh
            m = cfg.mesh
            self.lmesh = LatticeMesh.make(lat, m.nt, m.nz, m.ny)
        self.eigcg = None
        if not cfg.mg.enabled and cfg.solver.solver == "eigcg":
            if cfg.action.csw != 0.0:
                raise NotImplementedError(
                    "solver: eigcg runs on the plain twisted-mass operator only; with "
                    "action.csw != 0 use mg.enabled or solver: cg/bicgstab (which honor the "
                    "clover term)")
            self.eigcg = {}
        self.clover = None
        if not cfg.mg.enabled and cfg.action.csw != 0.0:
            from ..solve import make_clover_fields
            self.clover = make_clover_fields(u_pk, lat, kappa=cfg.action.kappa,
                                             mu=cfg.action.mu, csw=cfg.action.csw)
        self.sharded = None
        if self.lmesh is not None:
            self._setup_mesh()
        self.mg = (MGSolver(cfg, lat, u_pk, self.lmesh, self.policy) if cfg.mg.enabled
                   else None)

    def _setup_mesh(self):
        """The mesh's policy and, on the direct branch, the sharded operators
        of both flavors and their operands."""
        from ..parallel.dist import local_shard
        from ..parallel.sharded import extend_gauge
        cfg, lmesh = self.cfg, self.lmesh

        @functools.lru_cache(maxsize=None)
        def halo_gauge():
            """The float64 HaloGauge (one face exchange), built when the
            direct branch, the truncated solves or the tuner read it: the
            MG and eigCG levels exchange their own."""
            return extend_gauge(lmesh, local_shard(self.u_pk.to(torch.float64), lmesh))
        self._halo_gauge, self._sharded_ops = halo_gauge, {}
        direct = not cfg.mg.enabled and self.eigcg is None
        self.policy = comm_policy(cfg, lmesh, self.u_pk.device,
                                  _tuning(cfg, lmesh, halo_gauge, self.u_pk, self.clover))
        log.info("lattice mesh: %d x %d x %d ranks over (T, Z, Y), comm_policy %s -> %s",
                 lmesh.nt, lmesh.nz, lmesh.ny, cfg.solver.comm_policy, self.policy)
        if direct:
            self.sharded = self._sharded_operators(_sloppy_dtype(cfg))

    def _clover_fields(self):
        """make_clover_fields's fields of the action (the direct branch's,
        else made at the first call)."""
        if self.clover is None:
            from ..solve import make_clover_fields
            a = self.cfg.action
            self.clover = make_clover_fields(self.u_pk, self.lat, kappa=a.kappa, mu=a.mu,
                                             csw=a.csw)
        return self.clover

    def _sharded_operators(self, sdt: torch.dtype):
        """(the sharded twisted-mass or clover operators of both flavors by
        flavor, their operands with sloppy dtype sdt, in float64), built at
        the first call for sdt."""
        if sdt not in self._sharded_ops:
            from ..parallel.dist import local_shard
            from ..parallel.sharded import (ShardedTMCloverOperatorPC, ShardedTMOperatorPC,
                                            clover_fields_to)
            lmesh, a = self.lmesh, self.cfg.action
            kw = dict(kappa=a.kappa, mu=a.mu,
                      t_boundary=-1 if self.cfg.gauge.antiperiodic_t else 1, lmesh=lmesh,
                      comm_policy=self.policy)
            ug = self._halo_gauge()
            if a.csw == 0.0:
                ops = {f: ShardedTMOperatorPC(lmesh.lat, flavor=f, **kw) for f in (+1, -1)}
                fields = (ug.to(sdt, rows=2), ug.to(torch.float64))
            else:
                ops = {f: ShardedTMCloverOperatorPC(lmesh.lat, flavor=f, **kw)
                       for f in (+1, -1)}
                f64 = (ug, *(local_shard(c, lmesh) for c in self._clover_fields()))
                fields = (clover_fields_to(f64, sdt, rows=2),
                          clover_fields_to(f64, torch.float64))
            self._sharded_ops[sdt] = (ops, *fields)
        return self._sharded_ops[sdt]

    def put(self, arr: torch.Tensor) -> torch.Tensor:
        """A packed array onto the solver's device."""
        return arr.to(self.u_pk.device)

    def _kw(self, flavor: int) -> dict:
        c = self.cfg
        return dict(kappa=c.action.kappa, mu=c.action.mu, flavor=int(flavor),
                    tol=c.solver.tol, maxiter=c.solver.maxiter, inner_tol=c.solver.inner_tol,
                    solver=c.solver.solver, sloppy_dtype=_sloppy_dtype(c),
                    t_boundary=-1 if c.gauge.antiperiodic_t else 1, csw=c.action.csw,
                    clover=self.clover)

    def _record(self, flavor, res, first_column=0, **more):
        one = not isinstance(res.relres, list)
        rec = dict(flavor=int(flavor), first_column=first_column,
                   relres=[res.relres] if one else list(res.relres),
                   iters=[res.iters] if one else list(res.iters), **more)
        rec["columns"] = len(rec["relres"])
        if self.keep_first:
            rec["x_first"] = res.x if one else res.x[0]
        self.records.append(rec)

    def _eigcg_solver(self, flavor: int):
        """The flavor's EigCGSolver (ShardedEigCGSolver on a mesh), made at
        its first solve."""
        if flavor not in self.eigcg:
            from ..solve import EigCGSolver, ShardedEigCGSolver
            a = self.cfg.action
            kw = dict(kappa=a.kappa, mu=a.mu, flavor=flavor,
                      t_boundary=-1 if self.cfg.gauge.antiperiodic_t else 1)
            if self.lmesh is None:
                self.eigcg[flavor] = EigCGSolver(self.u_pk, self.lat, **kw)
            else:
                from ..parallel.dist import local_shard
                self.eigcg[flavor] = ShardedEigCGSolver(
                    local_shard(self.u_pk, self.lmesh), self.lat, self.lmesh,
                    comm_policy=self.policy, **kw)
        return self.eigcg[flavor]

    def _solve(self, b_pk: torch.Tensor, flavor: int, probe: bool = False):
        """One source (on a mesh: this rank's shard) -> (SolveResult, the
        record's extra keys)."""
        more = {}
        if self.mg is not None:
            res = self.mg(b_pk, flavor)
        elif self.eigcg is not None:
            es = self._eigcg_solver(int(flavor))
            c = self.cfg.solver
            res = es.solve(b_pk, tol=c.tol, inner_tol=c.inner_tol, maxiter=c.maxiter)
            log.info("  eigcg solve: relres=%.2e iters=%d (space k=%d)", res.relres, res.iters,
                     es.space.k)
            more["space"] = es.space.k
        elif self.sharded is not None:
            from ..solve import solve_tm_sharded
            ops, fields_s, fields_hp = self.sharded
            c = self.cfg.solver
            res = solve_tm_sharded(ops[int(flavor)], fields_s, fields_hp, b_pk, tol=c.tol,
                                   maxiter=c.maxiter, inner_tol=c.inner_tol, solver=c.solver)
            log.info("  sharded solve: relres=%.2e iters=%d", res.relres, res.iters)
        else:
            from ..solve import solve_tm
            res = solve_tm(self.u_pk, b_pk, self.lat, **self._kw(flavor))
            log.info("  solve: relres=%.2e iters=%d%s", res.relres, res.iters,
                     " (batch-gate probe)" if probe else "")
        return res, more

    def solve_local(self, b_loc: torch.Tensor, flavor: int = +1):
        """On a mesh: this rank's shard of a packed source -> the SolveResult
        with this rank's shard of x (every rank calls it)."""
        if self.lmesh is None:
            raise ValueError("solve_local solves on a mesh; use packed_src on one card")
        return self._solve(b_loc, flavor)[0]

    def _column(self, b: torch.Tensor, flavor: int, probe: bool = False,
                first_column: int = 0):
        """One source (on a mesh this rank's block) -> its SolveResult,
        recorded and audited."""
        res, more = self._solve(b, flavor, probe)
        self._record(flavor, res, first_column, probe=probe, **more)
        if self.audit is not None:
            self.audit(b[None], res.x[None], flavor)
        return res

    def packed_src(self, b_pk: torch.Tensor, flavor: int = +1, probe: bool = False,
                   first_column: int = 0):
        """One packed source -> the packed float32 solution (probe: it is
        the batch gate's first column; first_column: its index in a batch);
        on a mesh the whole source in and the whole solution out."""
        b_pk = self.put(b_pk)
        if self.lmesh is None:
            return self._column(b_pk, flavor, probe, first_column).x.to(torch.float32)
        from ..parallel.dist import local_shard
        res = self._column(local_shard(b_pk, self.lmesh), flavor, first_column=first_column)
        return self.lmesh.all_gather(res.x).to(torch.float32)

    def _batch(self, b_pks: torch.Tensor, flavor: int, first_column: int):
        if self.mg is not None:
            res = self.mg.solve_batch(b_pks, flavor)
        else:
            from ..solve import solve_tm_batch
            res = solve_tm_batch(self.u_pk, b_pks, self.lat, **self._kw(flavor))
            log.info("  batch solve (%d rhs): max relres=%.2e iters<=%d", b_pks.shape[0],
                     max(res.relres), max(res.iters))
        self._record(flavor, res, first_column)
        if self.audit is not None:
            self.audit(b_pks, res.x, flavor)
        return res.x.to(torch.float32)

    def packed_src_batch(self, b_pks: torch.Tensor, flavor: int = +1) -> torch.Tensor:
        """Packed sources [n, 2(par), 2(ri), ...] -> packed float32 solutions,
        in batches of solver.rhs_batch columns.  On the direct branch the
        first column is solved alone, and if it took more than
        solver.rhs_batch_gate_iters matvecs the others run in batches of
        solver.rhs_batch_gate_chunk (tpuqcd/cli/common.py:728-774).  eigCG
        solves the columns one after the other, each deflated by what the
        ones before it harvested, and so does every branch on a mesh, where
        b_pks are this rank's blocks and so are the solutions."""
        b_pks = self.put(b_pks)
        if self.eigcg is not None or self.lmesh is not None:
            return torch.stack([self._column(b, flavor, first_column=i).x.to(torch.float32)
                                for i, b in enumerate(b_pks)])
        n, batch_n, lead = b_pks.shape[0], self.rhs_batch, None
        gate = int(self.cfg.solver.rhs_batch_gate_iters)
        gate_chunk = int(self.cfg.solver.rhs_batch_gate_chunk)
        if self.mg is None and n > 1 and self.rhs_batch > gate_chunk and gate > 0:
            lead = self.packed_src(b_pks[0], flavor, probe=True)
            it0 = self.records[-1]["iters"][0]
            self.records[-1]["gate_rechunked"] = it0 > gate
            if it0 > gate:
                log.info("  batch gate: %d iters > %d: the remaining %d columns run in "
                         "batches of %d", it0, gate, n - 1, gate_chunk)
                batch_n = gate_chunk
        outs = [] if lead is None else [lead[None]]
        for lo in range(len(outs), n, batch_n):
            outs.append(self._batch(b_pks[lo:lo + batch_n], flavor, lo))
        return torch.cat(outs)

    def truncated_batch(self, b_pks: torch.Tensor, flavor: int, tol: float,
                        maxiter: int) -> torch.Tensor:
        """The truncated solves of TSM (tpuqcd/cli/run_loops.py:134-154): to
        ``tol`` or ``maxiter`` sloppy matvecs, inner_tol max(tol, 1e-3), CG
        where the solver is eigCG, float32 sloppy arithmetic; uncertified
        by design, so neither recorded nor audited.  On one card the
        columns b_pks [n, 2(par), 2(ri), ...] run as one solve_tm_batch; on
        a mesh they are this rank's blocks and go one at a time through
        solve_tm_sharded on the sharded operators (built at the first call
        on the MG and eigCG branches).  Returns float32 solutions."""
        c, a = self.cfg, self.cfg.action
        solver = "cg" if c.solver.solver == "eigcg" else c.solver.solver
        kw = dict(tol=tol, maxiter=maxiter, inner_tol=max(tol, 1e-3), solver=solver)
        b_pks = self.put(b_pks)
        if self.lmesh is None:
            from ..solve import solve_tm_batch
            res = solve_tm_batch(self.u_pk, b_pks, self.lat, kappa=a.kappa, mu=a.mu,
                                 flavor=int(flavor), t_boundary=-1 if c.gauge.antiperiodic_t
                                 else 1, csw=a.csw,
                                 clover=self._clover_fields() if a.csw != 0.0 else None, **kw)
            return res.x.to(torch.float32)
        from ..solve import solve_tm_sharded
        ops, fields_s, fields_hp = self._sharded_operators(torch.float32)
        return torch.stack([solve_tm_sharded(ops[int(flavor)], fields_s, fields_hp, b, **kw)
                            .x.to(torch.float32) for b in b_pks])

    def packed(self, b_full: torch.Tensor, flavor: int = +1) -> torch.Tensor:
        """A full-layout source complex [T, Z, Y, X, 4, 3] -> packed solution."""
        return self.packed_src(full_to_packed(self.put(b_full), self.lat), flavor)

    def __call__(self, b_full: torch.Tensor, flavor: int = +1) -> torch.Tensor:
        from ..phys.propagator import packed_to_full
        return packed_to_full(self.packed(b_full, flavor), self.lat)


def make_solver(cfg: RunConfig, lat: Lattice, u_pk: torch.Tensor, lmesh=None) -> Solver:
    """The solver of run_invert and of the physics programs (see Solver),
    on the mesh of cfg.mesh or ``lmesh``; refuses what the port does not
    run yet (check_in_slice)."""
    check_in_slice(cfg)
    if cfg.action.epsbar != 0.0:
        raise NotImplementedError("make_solver solves the light (degenerate) twisted-mass "
                                  "quark; action.epsbar selects run_invert's doublet solve")
    return Solver(cfg, lat, u_pk, lmesh)


def random_source(lat: Lattice, device: torch.device, seed: int = 99,
                  columns: int | None = None) -> torch.Tensor:
    """Gaussian complex source, drawn in full layout on the CPU generator,
    as packed float32 [2(par), 2(ri), 4, 3, T, Z, S] on ``device``; with
    ``columns`` that many drawn one after the other and stacked in front
    (columns=2: the doublet source [2(fl), 2(par), ...])."""
    gen = torch.Generator().manual_seed(seed)
    shape = (*lat.full_shape, 4, 3)

    def one():
        b = torch.complex(torch.randn(shape, generator=gen), torch.randn(shape, generator=gen))
        return full_to_packed(b.to(device), lat)
    return one() if columns is None else torch.stack([one() for _ in range(columns)])
