"""Certified twisted-mass and twisted-clover solves: sloppy Krylov
iteration inside an f64 defect-correction loop.

Counterpart of ``tpuqcd/solve.py:30-251, :292-367, :445``.  The iteration operator
runs in the sloppy dtype on a reconstruct-12 gauge copy; true residuals,
the even-odd preparation, the reconstruction and the final full-system
residual use the float64 operator on the full 18-real gauge.  On a CUDA
device every one of them goes through the Dslash kernel.

    lat = Lattice((16, 16, 16, 32))
    res = solve_tm(u_pk, b_pk, lat, kappa=0.115, mu=0.05, tol=1e-10)
    x = res.x          # [2(par), 2(ri), 4, 3, T, Z, S] float64
    clover = make_clover_fields(u_pk, lat, kappa=0.115, mu=0.05, csw=1.2)
    res = solve_tm(u_pk, b_pk, lat, kappa=0.115, mu=0.05, csw=1.2, clover=clover)

The clover fields hold the A blocks in float32 (built from the float32
gauge, exact in float64) and the odd twisted inverses in float64, so the
float64 operator certifies the even-odd system of the same M that
full_system_relres applies.

The non-degenerate doublet (solve_ndeg_tm, b and x [2(fl), 2(par), 2(ri),
4, 3, T, Z, S]) runs the same loop with CG.  On a LatticeMesh,
solve_tm_sharded and solve_ndeg_tm_sharded run it on the local shards
with every reduction summed over the ranks; the same sharded operator
certifies in float64 (tpuqcd needs an XLA twin there, its kernel being
float32 only).

solve_tm_musweep solves a twisted-mass quark-mass sweep from one
multi-shift Krylov space (on one card or a mesh), and certify_musweep
takes each of its masses on to a certified tolerance by a warm-started
solve_tm.

EigCGSolver keeps tpuqcd's incremental eigCG for a sequence of sources:
one deflation space per instance, grown by every solve;
ShardedEigCGSolver is its twin on a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .fields import ODD
from .lattice import Lattice
from .mg.device import DeviceFineCloverLevel, DeviceFineLevel, g5_fine
from .operators import PackedNdegTMOperatorPC, PackedTMCloverOperatorPC, PackedTMOperatorPC
from .ops.clover import clover_blocks, clover_twist_inverse
from .solvers.bicgstab import bicgstab, bicgstab_cols
from .solvers.cg import _cg_cycle, _cg_cycle_cols
from .solvers.multishift import multishift_cg
from .solvers import reductions
from .solvers.reductions import norm2, norm2_cols
from .utils.packed import pack_clover, unpack_gauge


class SolveResult(NamedTuple):
    x: torch.Tensor        # [2(par), 2(ri), 4, 3, T, Z, S] float64
    relres: float          # certified |bhat - Mhat x_e| / |bhat|
    iters: int             # sloppy matvec count
    refinements: int


def _refined_solve(pc, u_s, u_hp, bhat, *, sdt, tol, maxiter, inner_tol, solver, x0=None):
    """Defect correction: each pass solves Mhat dx = r in the sloppy dtype
    sdt (pc on the sloppy operands u_s) to inner_tol and adds dx to the
    f64 iterate; stops when the f64 true residual (pc on u_hp) meets tol,
    after maxiter sloppy matvecs, or 40 passes.  u_s and u_hp are a gauge
    or, for twisted clover, the operand tuple of make_clover_fields."""
    bsq = norm2(bhat).item()
    tol2 = tol * tol * bsq

    def inner(r_s, budget):
        if solver == "bicgstab":
            res = bicgstab(lambda v: pc.apply(u_s, v), r_s, tol=inner_tol,
                           maxiter=budget)
            return res.x, res.iters
        bn = pc.apply_dagger(u_s, r_s)
        dx, _, k = _cg_cycle(lambda v: pc.normal(u_s, v), bn, torch.zeros_like(bn),
                             inner_tol * inner_tol * norm2(bn).item(), budget)
        return dx, 2 * k + 1

    if x0 is None:
        x = torch.zeros_like(bhat)
        rsq = 4.0 * bsq
    else:
        x = x0.to(bhat.dtype).clone()
        rsq = norm2(bhat - pc.apply(u_hp, x)).item()
    k, nref = 0, 0
    while rsq > tol2 and k < maxiter and nref < 40:
        r = bhat - pc.apply(u_hp, x)
        dx, used = inner(r.to(sdt), maxiter - k)
        x += dx.to(x.dtype)
        rsq = norm2(bhat - pc.apply(u_hp, x)).item()
        k += used + 2
        nref += 1
    return x, (rsq / max(bsq, 1e-300)) ** 0.5, k, nref


def _certified(pc, u_s, u_hp, b_pk, *, sdt, tol, maxiter, inner_tol, solver,
               x0=None) -> SolveResult:
    """The certified two-parity solve on pc: prepare in float64, the
    defect correction on the even-odd system, reconstruct in float64."""
    b_hp = b_pk.to(torch.float64)
    bhat = pc.prepare(u_hp, b_hp)
    x_e, relres, iters, nref = _refined_solve(
        pc, u_s, u_hp, bhat, sdt=sdt, tol=tol, maxiter=maxiter, inner_tol=inner_tol,
        solver=solver, x0=x0)
    return SolveResult(x=pc.reconstruct(u_hp, x_e, b_hp), relres=relres, iters=iters,
                       refinements=nref)


class BatchSolveResult(NamedTuple):
    x: torch.Tensor        # [N, 2(par), 2(ri), 4, 3, T, Z, S] float64
    relres: list           # per column, certified
    iters: list            # per column (solve_tm_batch) or the common count
    refinements: list


def _refined_solve_cols(pc, u_s, u_hp, bhat, *, sdt, tol, maxiter, inner_tol, solver):
    """_refined_solve on a batch bhat [N, 2(ri), ...] with the meaning of
    ``jax.vmap`` over it (tpuqcd/solve.py:501): every column carries its own
    residual, matvec count and pass count, takes part in a pass while its
    own condition holds, and is left as it is afterwards, so each column's
    x, relres and count are those of its single solve.  Every operator
    apply is one batched launch, and the host reads the whole batch's
    residuals once per step."""
    dev = bhat.device
    bsq = norm2_cols(bhat)
    tol2 = tol * tol * bsq
    x = torch.zeros_like(bhat)
    rsq = 4.0 * bsq
    k = torch.zeros(bhat.shape[0], dtype=torch.int64, device=dev)
    nref = torch.zeros_like(k)
    live = (rsq > tol2) & (k < maxiter) & (nref < 40)
    while live.any().item():
        r_s = (bhat - pc.apply(u_hp, x)).to(sdt)
        if solver == "bicgstab":
            dx, used = bicgstab_cols(lambda v: pc.apply(u_s, v), r_s, inner_tol,
                                     maxiter - k, live)
        else:
            bn = pc.apply_dagger(u_s, r_s)
            dx, _, kc = _cg_cycle_cols(lambda v: pc.normal(u_s, v), bn,
                                       inner_tol * inner_tol * norm2_cols(bn), maxiter - k,
                                       live)
            used = 2 * kc + 1
        # a column outside `live` took no step: its dx is zero
        x += dx.to(x.dtype)
        rsq = torch.where(live, norm2_cols(bhat - pc.apply(u_hp, x)), rsq)
        k = k + (used + 2) * live
        nref = nref + live
        live = live & (rsq > tol2) & (k < maxiter) & (nref < 40)
    relres = torch.sqrt(rsq / torch.clamp(bsq, min=1e-300))
    return x, relres.tolist(), k.tolist(), nref.tolist()


def clover_pk_from_gauge(u_pk: torch.Tensor, lat: Lattice, *, kappa: float,
                         csw: float) -> torch.Tensor:
    """The packed A blocks of both parities, [2(par), 2(ri), 2(chir), 6, 6,
    T, Z, S] float32, built in complex64 from the float32 gauge."""
    a = clover_blocks(unpack_gauge(u_pk.to(torch.float32)), lat, kappa, csw)
    return torch.stack([pack_clover(a[0]), pack_clover(a[1])])


def make_clover_fields(u_pk: torch.Tensor, lat: Lattice, *, kappa: float, mu: float,
                       csw: float):
    """One-time clover construction for PackedTMCloverOperatorPC:
    (cl_pk, clinv_plus, clinv_minus).  cl_pk is clover_pk_from_gauge's A;
    clinv_plus and clinv_minus [2(ri), 2(chir), 6, 6, T, Z, S] float64 hold
    the odd twisted inverses of that A for flavor +1 and -1, inverted in
    complex128."""
    cl_pk = clover_pk_from_gauge(u_pk, lat, kappa=kappa, csw=csw)
    a = torch.complex(cl_pk[:, 0], cl_pk[:, 1])
    clinv = [pack_clover(clover_twist_inverse(a, kappa, mu, f, ODD), torch.float64)
             for f in (+1, -1)]
    return cl_pk, clinv[0], clinv[1]


def _tm_operands(u_pk, lat, *, kappa, mu, flavor, sloppy_dtype, t_boundary, csw, clover):
    """The operator of a twisted-mass(-clover) solve with its sloppy and
    float64 operands: (pc, u_s, u_hp)."""
    # one contiguous compressed copy per solve: the kernel rebuilds the rest
    u_s = u_pk[:, :, :2].to(sloppy_dtype).contiguous()
    u_hp = u_pk.to(torch.float64).contiguous()
    if csw == 0.0:
        return PackedTMOperatorPC(lat, kappa=kappa, mu=mu, flavor=flavor,
                                  t_boundary=t_boundary), u_s, u_hp
    if clover is None:
        clover = make_clover_fields(u_pk, lat, kappa=kappa, mu=mu, csw=csw)
    pc = PackedTMCloverOperatorPC(lat, kappa=kappa, mu=mu, flavor=flavor,
                                  t_boundary=t_boundary)
    return (pc, (u_s, *(c.to(sloppy_dtype) for c in clover)),
            (u_hp, *(c.to(torch.float64) for c in clover)))


def solve_tm(u_pk: torch.Tensor, b_pk: torch.Tensor, lat: Lattice, *, kappa: float,
             mu: float, flavor: int = 1, tol: float = 1e-10, maxiter: int = 5000,
             inner_tol: float = 1e-5, solver: str = "cg",
             sloppy_dtype: torch.dtype = torch.float32, t_boundary: int = -1,
             csw: float = 0.0, clover=None,
             x0_e: torch.Tensor | None = None) -> SolveResult:
    """Solve the two-parity twisted-mass(-clover) system M x = b.

    u_pk: packed gauge [4, 2, 3, 3, 2, T, Z, S] (any float dtype);
    b_pk: packed source [2(par), 2(ri), 4, 3, T, Z, S].
    solver: "cg" (normal equations) or "bicgstab" (on Mhat directly).
    t_boundary: the T-boundary phase folded into u_pk (-1 antiperiodic,
    +1 periodic); the sloppy reconstruct-12 operator restores it.
    csw != 0 solves the twisted-clover system; ``clover =
    make_clover_fields(...)`` reuses a clover construction (built here
    otherwise).  The operand tuple is cast to the sloppy dtype for the
    iteration and to float64 for the certification; reconstruct-12
    applies to the gauge only.
    tol is on the even-odd preconditioned system; x0_e warm-starts the
    even-parity iterate.
    """
    if solver not in ("cg", "bicgstab"):
        raise ValueError(f"solver must be cg or bicgstab, got {solver!r}")
    pc, u_s, u_hp = _tm_operands(u_pk, lat, kappa=kappa, mu=mu, flavor=flavor,
                                 sloppy_dtype=sloppy_dtype, t_boundary=t_boundary, csw=csw,
                                 clover=clover)
    return _certified(pc, u_s, u_hp, b_pk, sdt=sloppy_dtype, tol=tol, maxiter=maxiter,
                      inner_tol=inner_tol, solver=solver, x0=x0_e)


def solve_tm_batch(u_pk: torch.Tensor, b_pks: torch.Tensor, lat: Lattice, *, kappa: float,
                   mu: float, flavor: int = 1, tol: float = 1e-10, maxiter: int = 5000,
                   inner_tol: float = 1e-5, solver: str = "cg",
                   sloppy_dtype: torch.dtype = torch.float32, t_boundary: int = -1,
                   csw: float = 0.0, clover=None) -> BatchSolveResult:
    """solve_tm on N right-hand sides b_pks [N, 2(par), 2(ri), 4, 3, T, Z, S]
    as one iteration stream (tpuqcd/solve.py:485, ``jax.vmap(solve_tm)``):
    every Dslash is one batched launch and every column's x, certified
    relres and matvec count equal those of its single solve_tm.  Arguments
    as solve_tm."""
    if solver not in ("cg", "bicgstab"):
        raise ValueError(f"solver must be cg or bicgstab, got {solver!r}")
    pc, u_s, u_hp = _tm_operands(u_pk, lat, kappa=kappa, mu=mu, flavor=flavor,
                                 sloppy_dtype=sloppy_dtype, t_boundary=t_boundary, csw=csw,
                                 clover=clover)
    b_hp = b_pks.to(torch.float64)
    bhat = pc.prepare(u_hp, b_hp)
    x_e, relres, iters, nref = _refined_solve_cols(
        pc, u_s, u_hp, bhat, sdt=sloppy_dtype, tol=tol, maxiter=maxiter,
        inner_tol=inner_tol, solver=solver)
    return BatchSolveResult(x=pc.reconstruct(u_hp, x_e, b_hp), relres=relres, iters=iters,
                            refinements=nref)


def solve_ndeg_tm(u_pk: torch.Tensor, b_pk: torch.Tensor, lat: Lattice, *, kappa: float,
                  mubar: float, epsbar: float, tol: float = 1e-10, maxiter: int = 5000,
                  inner_tol: float = 1e-5, sloppy_dtype: torch.dtype = torch.float32,
                  t_boundary: int = -1) -> SolveResult:
    """Solve the two-parity non-degenerate doublet system M_nd x = b:
    CG on the normal equations of the even-odd Schur complement inside
    the f64 defect correction, as solve_tm (tpuqcd/solve.py:216).

    b_pk: packed doublet [2(fl), 2(par), 2(ri), 4, 3, T, Z, S]; t_boundary
    as in solve_tm (the sloppy reconstruct-12 hop restores it).
    """
    pc = PackedNdegTMOperatorPC(lat, kappa=kappa, mubar=mubar, epsbar=epsbar,
                                t_boundary=t_boundary)
    u_s = u_pk[:, :, :2].to(sloppy_dtype).contiguous()
    return _certified(pc, u_s, u_pk.to(torch.float64).contiguous(), b_pk, sdt=sloppy_dtype,
                      tol=tol, maxiter=maxiter, inner_tol=inner_tol, solver="cg")


def solve_ndeg_tm_sharded(op, fields_s, fields_hp, b_pk: torch.Tensor, *,
                          tol: float = 1e-10, maxiter: int = 5000,
                          inner_tol: float = 1e-5) -> SolveResult:
    """The doublet on a LatticeMesh (tpuqcd/solve.py:169-213), by CG
    (Mhat_nd is g5 tau1-Hermitian, not Hermitian): op a
    ShardedNdegTMOperatorPC, fields_s and fields_hp its sloppy and float64
    operands (HaloGauge.to; the iteration runs in fields_s's dtype), b_pk
    this rank's shard of the doublet [2(fl), 2(par), ...].  Every rank
    calls it; x is this rank's shard, relres the global one."""
    with reductions.over(op.lmesh):
        return _certified(op, fields_s, fields_hp, b_pk, sdt=fields_s.u.dtype, tol=tol,
                          maxiter=maxiter, inner_tol=inner_tol, solver="cg")


def _gauge_dtype(fields) -> torch.dtype:
    """The dtype of a sharded operand: a HaloGauge or a clover tuple."""
    return (fields[0] if isinstance(fields, tuple) else fields).u.dtype


def solve_tm_sharded(op, fields_s, fields_hp, b_pk: torch.Tensor, *, tol: float = 1e-10,
                     maxiter: int = 5000, inner_tol: float = 1e-5, solver: str = "cg",
                     x0_e: torch.Tensor | None = None) -> SolveResult:
    """The twisted-mass(-clover) system on a LatticeMesh
    (tpuqcd/solve.py:169-192): op a ShardedTMOperatorPC or
    ShardedTMCloverOperatorPC, fields_s and fields_hp its sloppy and
    float64 operands (a HaloGauge, or parallel/sharded.clover_fields_to's
    tuple; the iteration runs in fields_s's dtype), b_pk this rank's shard
    of [2(par), 2(ri), 4, 3, T, Z, S].  The same operator, on the float64
    operands, certifies (tpuqcd needs an XLA twin there).  x0_e, this
    rank's shard of an even-parity iterate, warm-starts it, as in
    solve_tm.  Every rank calls it; x is this rank's shard, relres the
    global one."""
    if solver not in ("cg", "bicgstab"):
        raise ValueError(f"solver must be cg or bicgstab, got {solver!r}")
    with reductions.over(op.lmesh):
        return _certified(op, fields_s, fields_hp, b_pk, sdt=_gauge_dtype(fields_s), tol=tol,
                          maxiter=maxiter, inner_tol=inner_tol, solver=solver, x0=x0_e)


def ndeg_full_relres(u_pk: torch.Tensor, b_pk: torch.Tensor, x_pk: torch.Tensor,
                     lat: Lattice, *, kappa: float, mubar: float, epsbar: float) -> float:
    """Float64 |b - M_nd x| / |b| of the two-parity doublet system, fields
    [2(fl), 2(par), 2(ri), 4, 3, T, Z, S] and the 18-real gauge
    (tpuqcd/cli/run_invert.py:221-246)."""
    pc = PackedNdegTMOperatorPC(lat, kappa=kappa, mubar=mubar, epsbar=epsbar)
    b64 = b_pk.to(torch.float64)
    r = b64 - pc.apply_full(u_pk.to(torch.float64).contiguous(), x_pk.to(torch.float64))
    return (norm2(r).item() / max(norm2(b64).item(), 1e-300)) ** 0.5


def full_system_relres(u_pk: torch.Tensor, b_pk: torch.Tensor, x_pk: torch.Tensor,
                       lat: Lattice, *, kappa: float, mu: float, flavor: int = 1,
                       csw: float = 0.0, clover_pk: torch.Tensor | None = None) -> float:
    """Certified float64 |b - M x| / |b| of the two-parity system, fields
    [2(par), 2(ri), 4, 3, T, Z, S] and the 18-real gauge.

    csw != 0 certifies against the twisted-clover M, which applies A
    itself (DeviceFineCloverLevel.as_hp), never an inverse; clover_pk,
    the A blocks [2(par), 2(ri), 2(chir), 6, 6, T, Z, S], is built from
    u_pk when not given."""
    b64 = b_pk.to(torch.float64)
    u64 = u_pk.to(torch.float64).contiguous()
    if csw != 0.0:
        if clover_pk is None:
            clover_pk = clover_pk_from_gauge(u_pk, lat, kappa=kappa, csw=csw)
        lv = DeviceFineCloverLevel(lat, u64, clover_pk, kappa, mu, flavor=flavor).as_hp()
        mx = lv.apply(x_pk.to(torch.float64).transpose(0, 1).contiguous()).transpose(0, 1)
    else:
        pc = PackedTMOperatorPC(lat, kappa=kappa, mu=mu, flavor=flavor)
        mx = pc.apply_full(u64, x_pk.to(torch.float64))
    r = b64 - mx
    return (norm2(r).item() / max(norm2(b64).item(), 1e-300)) ** 0.5


def solve_tm_musweep(u_pk: torch.Tensor, b_pk: torch.Tensor, lat: Lattice, *, kappa: float,
                     mu_list, tol: float = 1e-8, maxiter: int = 4000, t_boundary: int = -1,
                     lmesh=None, comm_policy: str = "fused"):
    """Twisted-mass quark-mass sweep (tpuqcd/solve.py:504-594): M(mu_i) x_i
    = b for every mu of mu_list from one multi-shift CG Krylov space.

    The left normal operators of all masses are shifts of one Hermitian
    positive definite operator, M(mu) M(mu)^dag = M_W M_W^dag + (2 kappa
    mu)^2 (M_W = M(0); the cross terms cancel by gamma5-hermiticity), so
    solvers/multishift.py solves (M_W M_W^dag + sigma_i) y_i = b with the
    shifts sigma_i ascending, the seed the smallest, two fine-level applies
    (one xpay launch a parity each) per step, and x_i = M(mu_i)^dag y_i =
    g5 M(-mu_i) g5 y_i.  The sweep runs in float32 on the reconstruct-12
    links to ``tol`` on the normal system, whose residual is x_i's
    full-system residual; certify_musweep takes every mass on to a
    certified tolerance.

    u_pk [4, 2, 3, 3, 2, T, Z, S] with the boundary phase t_boundary
    folded in; b_pk [2(par), 2(ri), 4, 3, T, Z, S].  Returns (xs [n_mu,
    *b_pk.shape] float32 in mu_list order, relres: per mass the float64
    |b - M(mu_i) x_i| / |b| (full_system_relres), iters: the multishift
    steps).  Masses with the same mu^2 share a shift, not an x_i.

    On a LatticeMesh ``lmesh`` every rank calls it with its shards of u_pk
    and b_pk; the matvec runs on mg/shard.ShardedFineLevel under
    ``comm_policy``, the Krylov scalars sum over the ranks, xs are this
    rank's shards and relres, from the sharded float64 level, is global.
    """
    mu_list = tuple(float(m) for m in mu_list)
    order = sorted(range(len(mu_list)), key=lambda i: mu_list[i] ** 2)
    shifts = [(2.0 * kappa * mu_list[i]) ** 2 for i in order]
    if lmesh is None:
        level = DeviceFineLevel(lat, u_pk.to(torch.float32), kappa, 0.0, t_boundary=t_boundary)
    else:
        from .mg.shard import ShardedFineLevel
        level = ShardedFineLevel.build(lmesh, u_pk, kappa, 0.0, t_boundary=t_boundary,
                                       comm_policy=comm_policy)

    def matvec(v):      # M_W M_W^dag = M_W g5 M_W g5 (mu = 0)
        return level.apply(g5_fine(level.apply(g5_fine(v))))

    b_t = b_pk.to(torch.float32).transpose(0, 1).contiguous()     # [2(ri), 2(par), ...]
    xs = torch.empty((len(mu_list), *b_pk.shape), dtype=torch.float32, device=b_pk.device)
    with reductions.over(lmesh):
        res = multishift_cg(matvec, b_t, shifts, tol=tol, maxiter=maxiter)
        for pos, i in enumerate(order):
            lv = dataclasses.replace(level, mu=-mu_list[i])
            xs[i] = g5_fine(lv.apply(g5_fine(res.xs[pos]))).transpose(0, 1)
        iters = res.iters
        del res
        if lmesh is None:
            relres = [full_system_relres(u_pk, b_pk, x, lat, kappa=kappa, mu=mu)
                      for x, mu in zip(xs, mu_list)]
        else:
            hp = level.as_hp()
            b64 = b_t.to(torch.float64)
            bsq = max(norm2(b64).item(), 1e-300)
            relres = [(norm2(b64 - dataclasses.replace(hp, mu=mu).apply(
                x.transpose(0, 1).to(torch.float64).contiguous())).item() / bsq) ** 0.5
                for x, mu in zip(xs, mu_list)]
    return xs, relres, iters


def certify_musweep(u_pk: torch.Tensor, b_pk: torch.Tensor, lat: Lattice, xs: torch.Tensor,
                    *, kappa: float, mu_list, tol: float = 1e-10, maxiter: int = 5000,
                    inner_tol: float = 1e-5, sloppy_dtype: torch.dtype = torch.float32,
                    t_boundary: int = -1, lmesh=None,
                    comm_policy: str = "fused") -> list[SolveResult]:
    """Every mass of a sweep certified to ``tol``: solve_tm at mu_i (on a
    LatticeMesh solve_tm_sharded, with the shards as solve_tm_musweep takes
    them) warm-started from the even parity of x_i, the iterate of the
    even-odd system its defect correction runs (tpuqcd does not refine its
    sweep).  xs [n_mu, 2(par), 2(ri), ...] in mu_list order.  Returns one
    SolveResult a mass, in mu_list order; iters and refinements count the
    certification's own sloppy matvecs and passes."""
    mu_list = tuple(float(m) for m in mu_list)
    kw = dict(tol=tol, maxiter=maxiter, inner_tol=inner_tol)
    if lmesh is None:
        return [solve_tm(u_pk, b_pk, lat, kappa=kappa, mu=mu, sloppy_dtype=sloppy_dtype,
                         t_boundary=t_boundary, x0_e=x[0], **kw)
                for x, mu in zip(xs, mu_list)]
    from .parallel.sharded import ShardedTMOperatorPC, extend_gauge
    ug = extend_gauge(lmesh, u_pk.to(torch.float64))
    fields = (ug.to(sloppy_dtype, rows=2), ug.to(torch.float64))
    return [solve_tm_sharded(ShardedTMOperatorPC(lmesh.lat, kappa=kappa, mu=mu,
                                                 t_boundary=t_boundary, lmesh=lmesh,
                                                 comm_policy=comm_policy),
                             *fields, b_pk, x0_e=x[0], **kw)
            for x, mu in zip(xs, mu_list)]


#: EigCGSolver's sizes (tpuqcd's defaults, which no caller changes): Ritz
#: pairs harvested a solve, the window, the largest deflation space, and
#: the defect-correction passes a solve
EIGCG_NEV, EIGCG_M, EIGCG_MAX_SPACE, EIGCG_MAX_REFINE = 8, 24, 96, 10


class EigCGSolver:
    """Incremental eigCG for a sequence of right-hand sides
    (tpuqcd/solve.py:292-367): each solve runs deflated CG on the even-odd
    normal operator Mhat^dag Mhat in float32 (solvers/eigcg.py) inside a
    float64 defect correction that certifies the true residual, harvests
    low eigenpairs of Mhat^dag Mhat, and adds them to a deflation space that
    cuts the iterations of every later solve.

    One instance per gauge and flavor: the space belongs to that operator.
    The sloppy operator reads a reconstruct-12 float32 copy of the gauge
    (tpuqcd's reads the 18 reals), so ``t_boundary`` must be the links'
    phase; prepare, the residuals and the reconstruction take the float64
    operator on the 18 reals."""

    def __init__(self, u_pk: torch.Tensor, lat: Lattice, *, kappa: float, mu: float,
                 flavor: int = +1, t_boundary: int = -1):
        from .solvers.eigcg import EigCGSpace
        self.lat = lat
        self.pc = PackedTMOperatorPC(lat, kappa=kappa, mu=mu, flavor=flavor,
                                     t_boundary=t_boundary)
        self.u32 = u_pk[:, :, :2].to(torch.float32).contiguous()
        self.u_hp = u_pk.to(torch.float64).contiguous()
        self.space = EigCGSpace.empty()

    def _apply_a(self, v: torch.Tensor) -> torch.Tensor:
        return self.pc.normal(self.u32, v)

    def solve(self, b_pk: torch.Tensor, *, tol: float = 1e-10, inner_tol: float = 1e-5,
              maxiter: int = 2000) -> SolveResult:
        """b_pk [2(par), 2(ri), 4, 3, T, Z, S] -> x float64 in the same
        layout, relres the certified |bhat - Mhat x_e| / |bhat|, iters the
        eigCG iterations over all passes."""
        from .solvers.eigcg import eigcg
        pc, u_hp = self.pc, self.u_hp
        b_hp = b_pk.to(torch.float64)
        bhat = pc.prepare(u_hp, b_hp)
        bsq = max(norm2(bhat).item(), 1e-300)
        x = torch.zeros_like(bhat)
        total, nref = 0, 0
        while True:
            r = bhat - pc.apply(u_hp, x)
            rel = (norm2(r).item() / bsq) ** 0.5
            if rel <= tol or nref == EIGCG_MAX_REFINE:
                break
            rhs32 = pc.apply_dagger(self.u32, r.to(torch.float32))
            res = eigcg(self._apply_a, rhs32, nev=EIGCG_NEV, m=EIGCG_M, tol=inner_tol,
                        maxiter=maxiter, space=self.space)
            self.space.absorb(self._apply_a, res.ritz, max_k=EIGCG_MAX_SPACE)
            total += res.iters
            nref += 1
            x += res.x.to(torch.float64)
        return SolveResult(x=pc.reconstruct(u_hp, x, b_hp), relres=rel, iters=total,
                           refinements=nref)


class ShardedEigCGSolver(EigCGSolver):
    """EigCGSolver on a LatticeMesh (tpuqcd/solve.py:370-411): the sloppy
    and float64 operators are one ShardedTMOperatorPC on the shard's
    HaloGauge (reconstruct-12 float32, 18-real float64), every dot product
    of eigCG, of the Rayleigh-Ritz step and of the space's absorb sums over
    the ranks, and the deflation basis holds local shards.  u_loc is this
    rank's gauge shard; solve takes and returns shards."""

    def __init__(self, u_loc: torch.Tensor, lat: Lattice, lmesh, *, kappa: float, mu: float,
                 flavor: int = +1, t_boundary: int = -1, comm_policy: str = "fused"):
        from .parallel.sharded import ShardedTMOperatorPC
        from .solvers.eigcg import EigCGSpace
        self.lat, self.lmesh = lat, lmesh
        self.pc = ShardedTMOperatorPC(lat, kappa=kappa, mu=mu, flavor=flavor,
                                      t_boundary=t_boundary, lmesh=lmesh,
                                      comm_policy=comm_policy)
        ug = self.pc.extend_gauge(u_loc.to(torch.float64))
        self.u32, self.u_hp = ug.to(torch.float32, rows=2), ug.to(torch.float64)
        self.space = EigCGSpace.empty()

    def solve(self, b_pk: torch.Tensor, **kw) -> SolveResult:
        with reductions.over(self.lmesh):
            return super().solve(b_pk, **kw)


def solve_tm_mg(mg, b_pk: torch.Tensor, *, tol: float = 1e-10,
                inner_tol: float | None = None, maxiter: int = 200,
                verbose: bool = False) -> SolveResult:
    """MG-preconditioned solve of the two-parity system M x = b on a
    mg.dsolve.DeviceMG hierarchy (tpuqcd/solve.py:445).

    b_pk: packed source [2(par), 2(ri), 4, 3, T, Z, S]; the source is
    rounded to float32, as in tpuqcd, and the hierarchy's float64
    defect correction certifies |b - M x| / |b|.  Returns x in the same
    parity-first layout, float64.
    """
    res = mg.solve_certified(b_pk.to(torch.float32).transpose(0, 1).contiguous(), tol=tol,
                             inner_tol=inner_tol, maxiter=maxiter, verbose=verbose)
    return SolveResult(x=res.x.transpose(0, 1).contiguous(), relres=res.relres,
                       iters=res.iters, refinements=res.refinements)


def solve_tm_mg_batch(mg, b_pks: torch.Tensor, *, tol: float = 1e-10,
                      inner_tol: float | None = None, maxiter: int = 200,
                      verbose: bool = False) -> BatchSolveResult:
    """solve_tm_mg on N right-hand sides b_pks [N, 2(par), 2(ri), 4, 3, T, Z,
    S] as one GCR stream in lockstep (tpuqcd/solve.py:467,
    mg.dsolve.DeviceMG.solve_certified_batch).  x is float64 in the same
    layout, relres per column; iters and refinements are common to the
    columns and repeated for each."""
    n = b_pks.shape[0]
    res = mg.solve_certified_batch(b_pks.to(torch.float32).transpose(1, 2).contiguous(),
                                   tol=tol, inner_tol=inner_tol, maxiter=maxiter,
                                   verbose=verbose)
    return BatchSolveResult(x=res.x.transpose(1, 2).contiguous(), relres=res.relres,
                            iters=[res.iters] * n, refinements=[res.refinements] * n)
