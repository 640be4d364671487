"""Adaptive multigrid on the device: setup, V-cycle, certified solve.

Counterpart of ``tpuqcd/mg/dsolve.py`` (float64 certification).  The
MG-preconditioned flexible GCR runs on the device; the host reads the
residual norm once per restart cycle (tpuqcd's ``lax.while_loop``
condition), and an outer defect-correction loop against the float64
operator certifies the true residual.

``solve_batch`` and ``solve_certified_batch`` run N right-hand sides
[N, 2(ri), 2(par), 4, 3, T, Z, S] as one GCR stream in lockstep (tpuqcd
vmaps the cycle, mg/dsolve.py:316-428): every fine apply is one batched
kernel launch, every transfer and coarse apply one batched product, with
one scalar per column (utils/pkalg, cols=True).  Columns that have converged
keep polishing until every column meets the tolerance, and the iteration
count is the common one.

A sharded fine level (mg/shard.ShardedFineLevel) makes the hierarchy
run on a LatticeMesh: the fine level's reductions sum over the ranks
(``_scope``), the coarse levels are replicated and reduce locally, and
its columns go one at a time.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import NamedTuple

import torch

from ..solvers import reductions
from ..solvers.krylov_pk import (GCRResultPk, _gcr_cycle, bicgstab_fixed_pk, cg_fixed_pk,
                                 gcr_fixed_pk, mr_smoother_pk)
from ..utils import pkalg as pk
from ..utils.profile import sync
from .device import DeviceCoarseTransfer, DeviceFineLevel, build_coarse_device, g5_fine


@dataclasses.dataclass
class DeviceMGParams:
    """n_vec per coarsening, geometric blocks, setup depth, cycle
    smoothing, coarsest-level work, mu boost (tpuqcd's DeviceMGParams).

    smoother_dtype "bfloat16" runs the fine smoother on a bfloat16 twin
    (kernel storage); coarse_dtype "bfloat16" rounds the coarse links to
    bfloat16; setup_solver "cgne" is CG on M^dag M = g5 M_{-f} g5 M_f,
    "bicgstab" fixed BiCGStab on M (coarse levels always use BiCGStab).
    gcr_dtype "bfloat16" stores the fine level's outer GCR basis (2 restart
    fields a column) in bfloat16, vec_dtype "bfloat16" the null-vector bank
    of every transfer; every product and sum stays float32 (tpuqcd's
    buffers; mg/device.py's BANK_CHUNK_FIELDS, solvers/krylov_pk._gcr_cycle).
    """
    n_vec: tuple = (8, 8)
    block: tuple = ((4, 4, 4, 4), (2, 2, 2, 2))
    setup_iters: int = 60
    smoother_iters: int = 4
    coarse_iters: int = 32
    restart: int = 8
    mu_factor: float = 6.0
    seed: int = 7
    smoother_dtype: str = "float32"
    setup_solver: str = "bicgstab"
    coarse_dtype: str = "float32"
    inner_tol: float = 1e-5
    gcr_dtype: str = "float32"
    vec_dtype: str = "float32"

    @classmethod
    def near_critical(cls, levels: int = 2) -> "DeviceMGParams":
        """The recipe for near kappa_c on thermalized gauges: CG-NE setup
        at depth 300, n_vec 16, restart-24 flexible GCR, bfloat16 smoother
        and coarse links, coarse GCR 24, inner tolerance 1e-7."""
        nv = (16,) if levels == 2 else (16,) * (levels - 1)
        blocks = ((4, 4, 4, 4),) + ((2, 2, 2, 2),) * (levels - 2)
        return cls(n_vec=nv, block=blocks, setup_iters=300, smoother_iters=4,
                   coarse_iters=24, restart=24, mu_factor=6.0,
                   smoother_dtype="bfloat16", setup_solver="cgne",
                   coarse_dtype="bfloat16", inner_tol=1e-7)


class CertifiedResult(NamedTuple):
    x: torch.Tensor        # float64, the layout of b
    relres: float          # certified float64 |b - M x| / |b|
    iters: int             # inner (float32 GCR) iterations
    refinements: int


class DeviceMG:
    """Adaptive MG hierarchy on the device.

    Setup: null vectors by fixed-iteration CG-NE or BiCGStab from random
    starts drawn from ``generator`` (default: a generator on the fine
    level's device seeded with params.seed), the block orthogonalization
    (Gram, Cholesky, triangular inverse) and the Galerkin links by
    colored probing, without host round-trips of field data.
    setup_seconds holds each stage's seconds (device synchronised).
    """

    def __init__(self, fine: DeviceFineLevel, params: DeviceMGParams,
                 verbose: bool = False, generator: torch.Generator | None = None):
        _check_params(params)
        if generator is None:
            generator = torch.Generator(device=fine.device).manual_seed(params.seed)
        self.params = params
        self.lmesh = getattr(fine, "lmesh", None)
        self.levels, self.transfers = [fine], []
        self.setup_seconds = {}
        level = fine
        for depth, nv in enumerate(params.n_vec):
            t0 = time.perf_counter()
            with self._scope(depth):
                nulls = self._gen_null_vectors(level, nv, params.setup_iters, generator,
                                               params.setup_solver, self._vec_dtype())
            sync(fine.device)
            self.setup_seconds[f"nulls{depth}"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            if depth == 0:
                tr = fine.transfer(params.block[depth], nulls)
            else:
                tr = DeviceCoarseTransfer.from_pk(level.dims, level.n, params.block[depth],
                                                  nulls)
            del nulls
            coarse = build_coarse_device(level, tr)
            sync(fine.device)
            self.setup_seconds[f"galerkin{depth}"] = time.perf_counter() - t0
            self.transfers.append(tr)
            self.levels.append(coarse)
            level = coarse
            if verbose:
                print(f"[mg] level {depth + 1}: dims={coarse.dims} n={coarse.n} "
                      f"({self.setup_seconds[f'nulls{depth}']:.1f}s nulls, "
                      f"{self.setup_seconds[f'galerkin{depth}']:.1f}s RAP)")
        self._boost_and_round()
        self._finish()

    def rebuilt(self, params: DeviceMGParams) -> "DeviceMG":
        """This hierarchy's null vectors under ``params`` (the same n_vec and
        blocks): each bank stored in params.vec_dtype, its Linv and the
        Galerkin links built again from it, the coarsest level boosted and
        rounded as a setup does, and no null-vector solve.  From a float32
        setup it is the hierarchy that a setup with vec_dtype bfloat16 from
        the same starts builds (on two levels exactly; deeper levels keep
        the null vectors this hierarchy drew on its own coarse levels)."""
        _check_params(params)
        if (params.n_vec, params.block) != (self.params.n_vec, self.params.block):
            raise ValueError(f"rebuilt keeps the null vectors: n_vec {params.n_vec} and block "
                             f"{params.block} must be {self.params.n_vec} and "
                             f"{self.params.block}")
        mg = DeviceMG.__new__(DeviceMG)
        mg.params, mg.lmesh = params, self.lmesh
        fine = self.levels[0]
        mg.levels, mg.transfers, mg.setup_seconds = [fine], [], {}
        level = fine
        for depth, tr in enumerate(self.transfers):
            t0 = time.perf_counter()
            tr = copy.copy(tr.stored(mg._vec_dtype()))
            tr.linv = tr.gram_linv()
            coarse = build_coarse_device(level, tr)
            sync(fine.device)
            mg.setup_seconds[f"galerkin{depth}"] = time.perf_counter() - t0
            mg.transfers.append(tr)
            mg.levels.append(coarse)
            level = coarse
        mg._boost_and_round()
        mg._finish()
        return mg

    def _boost_and_round(self):
        """The coarsest level's twisted-mass boost (mu_factor) and the
        bfloat16 coarse links (coarse_dtype), after the probing."""
        fine, params = self.levels[0], self.params
        if params.mu_factor != 1.0 and fine.mu != 0.0:
            delta = 2.0 * fine.kappa * fine.mu * (params.mu_factor - 1.0)
            self.levels[-1] = self.levels[-1].boosted(delta)
        if params.coarse_dtype == "bfloat16":
            self.levels[1:] = [lv.rounded(torch.bfloat16) for lv in self.levels[1:]]

    @classmethod
    def from_parts(cls, fine: DeviceFineLevel, params: DeviceMGParams, transfers,
                   coarse_levels) -> "DeviceMG":
        """A hierarchy from given transfers and coarse levels (no setup),
        as utils/checkpoint.load_device_mg rebuilds one."""
        _check_params(params)
        mg = cls.__new__(cls)
        mg.params = params
        mg.lmesh = getattr(fine, "lmesh", None)
        mg.levels = [fine, *coarse_levels]
        mg.transfers = [tr.stored(mg._vec_dtype()) for tr in transfers]
        mg.setup_seconds = {}
        mg._finish()
        return mg

    def _finish(self):
        fine = self.levels[0]
        self.sloppy_fine = (fine.sloppy(torch.bfloat16)
                            if self.params.smoother_dtype == "bfloat16" else None)
        self._hp = None

    def _vec_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.params.vec_dtype == "bfloat16" else torch.float32

    def _basis_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.params.gcr_dtype == "bfloat16" else torch.float32

    @staticmethod
    def _gen_null_vectors(level, n_vec: int, iters: int, generator: torch.Generator,
                          setup_solver: str = "bicgstab",
                          store_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """n_vec normalized near-null vectors [n_vec, *field shape], each
        from a random start, solved and normalised in float32 and stored in
        ``store_dtype``: a bfloat16 bank is bfloat16 from the first vector
        (tpuqcd's store_dtype, tpuqcd/mg/dsolve.py:181-227), so that the
        float32 bank is never held whole."""
        if setup_solver == "cgne" and hasattr(level, "flavor"):
            level_m = dataclasses.replace(level, flavor=-level.flavor)

            def gen(v):     # M^dag M w = g5 M_- g5 (M_+ w)
                return cg_fixed_pk(lambda w: g5_fine(level_m.apply(g5_fine(level.apply(w)))),
                                   v, iters)
        else:
            def gen(v):
                return bicgstab_fixed_pk(level.apply, v, iters)
        buf = None
        for i in range(n_vec):
            x = gen(level.random_field(generator))
            x = x * torch.rsqrt(torch.clamp(pk.norm2(x), min=1e-30))
            if buf is None:
                buf = torch.empty((n_vec, *x.shape), dtype=store_dtype, device=x.device)
            buf[i] = x
        return buf

    def _scope(self, depth: int):
        """The reductions of level ``depth``: over the mesh's ranks on a
        sharded fine level (mg/shard.py), local on the replicated coarse
        levels and on one card."""
        return reductions.over(self.lmesh if depth == 0 else None)

    # --- the cycle -----------------------------------------------------------

    def _vcycle(self, depth: int, b: torch.Tensor, cols: bool = False) -> torch.Tensor:
        """One V-cycle from level ``depth`` down on one field, or with
        ``cols`` on a batch [N, 2(ri), ...] in lockstep."""
        with self._scope(depth):
            return self._vcycle_level(depth, b, cols)

    def _vcycle_level(self, depth: int, b: torch.Tensor, cols: bool) -> torch.Tensor:
        p = self.params
        lv = self.levels[depth]
        if depth == len(self.levels) - 1:
            return gcr_fixed_pk(lv.apply, b, iters=p.coarse_iters, restart=p.restart,
                                cols=cols)

        def smooth(rhs):
            if depth == 0 and self.sloppy_fine is not None:
                xs = mr_smoother_pk(self.sloppy_fine.apply, rhs.to(torch.bfloat16),
                                    iters=p.smoother_iters, cols=cols)
                return xs.to(torch.float32)
            return mr_smoother_pk(lv.apply, rhs, iters=p.smoother_iters, cols=cols)

        tr = self.transfers[depth]
        x = smooth(b)
        r = pk.caxpy(-1.0, 0.0, lv.apply(x), b, cols)
        xc = self._vcycle(depth + 1, tr.restrict(r), cols)
        x = x + tr.prolong(xc)
        r = pk.caxpy(-1.0, 0.0, lv.apply(x), b, cols)
        return x + smooth(r)

    def precondition(self, r: torch.Tensor) -> torch.Tensor:
        """One V-cycle ~ M^{-1} r."""
        return self._vcycle(0, r)

    # --- N right-hand sides in lockstep ---------------------------------------

    def _single_card(self, what: str) -> None:
        if self.lmesh is not None:
            raise NotImplementedError(f"{what}: a sharded hierarchy solves its columns one "
                                      "at a time, as tpuqcd's (cli/common.py:452-456)")

    def batch_buffers(self, n_rhs: int) -> dict:
        """The buffers solve_certified_batch allocates on the card for n_rhs
        columns and holds together at its peak, by name -> bytes; their sum
        is batch_bytes.  F is one float32 fine field (_fine_field_bytes),
        m the GCR restart.  The peak falls in a V-cycle's smoothing inside a
        fine GCR iteration (Gram-Schmidt and the transfers add less a
        column), the same in every cycle.  Each column holds there:

        * the float64 source and iterate, 4 F (solve_certified_batch's
          b64 and x);
        * the float32 residual handed to solve_batch, 1 F (r32);
        * solve_batch's iterate and residual between cycles, 2 F (the x
          and r it passes to _gcr_cycle);
        * the GCR basis, Z and V, 2 m fields in gcr_dtype
          (solvers/krylov_pk._gcr_cycle: Z, V);
        * the cycle's own iterate and residual, 2 F (its x and r);
        * the V-cycle's fine iterate and residual, 2 F (_vcycle_level's
          x and r);
        * the MR smoother's work, 5 F (mr_smoother_pk: with a bfloat16
          smoother the bfloat16 right-hand side, x, r and A r, 2 F, and
          pkalg.cdot's float32 copies of A r and r and the product under
          torch.linalg.vecdot, 3 F; with a float32 smoother x, r, A r and
          the new x and r);
        * on each coarse level, 2 restart + 23 of its float32 fields: its
          GCR basis (gcr_fixed_pk, float32 at every depth as in tpuqcd),
          its GCR and V-cycle iterates and residuals and z, v (6), its
          smoother's work (5), and DeviceCoarseLevel.apply's complex copy,
          nine gathered neighbours, product and stacked result (12).

        Paid once: the float64 operator, as_hp's copy of the fine level's
        links (and clover blocks), while solve_certified_batch has not
        built it; and each transfer's bank in restrict's V^dag product
        (mg/device._Transfer._wdag): a float32 bank's conjugate, n_vec
        fields of the finer level, or a bfloat16 bank's widened chunk and
        its conjugate, 2 (BANK_CHUNK_FIELDS)."""
        p, fine = self.params, self.levels[0]
        fields = [self._fine_field_bytes()] + [4 * 2 * lv.n * lv.Vc for lv in self.levels[1:]]
        f, coarse = fields[0], sum(fields[1:])
        out = {
            "float64 source and iterate": n_rhs * 4 * f,
            "float32 residual of the refinement": n_rhs * f,
            "solve_batch iterate and residual": n_rhs * 2 * f,
            f"GCR basis ({p.gcr_dtype})": n_rhs * 2 * p.restart * f
                                           * torch.finfo(self._basis_dtype()).bits // 32,
            "GCR cycle iterate and residual": n_rhs * 2 * f,
            "V-cycle iterate and residual": n_rhs * 2 * f,
            "MR smoother work": n_rhs * 5 * f,
            "coarse levels": n_rhs * (2 * p.restart + 23) * coarse,
            "restrict's bank": sum((2 if self._vec_dtype() == torch.bfloat16 else tr.n_vec)
                                   * field for tr, field in zip(self.transfers, fields)),
        }
        if self._hp is None:
            promoted = [fine.u_pk, getattr(fine, "clover_pk", None)]
            out["float64 operator"] = sum(2 * t.nbytes for t in promoted if t is not None)
        return out

    def batch_bytes(self, n_rhs: int) -> int:
        """Device memory solve_certified_batch allocates for n_rhs columns at
        its peak: the sum of batch_buffers."""
        return sum(self.batch_buffers(n_rhs).values())

    def _fine_field_bytes(self) -> int:
        """One float32 field of the fine level."""
        return 4 * 2 * 2 * 12 * self.levels[0].lat.half_volume

    def _column_field_bytes(self) -> int:
        """One float32 field of every level, summed."""
        return self._fine_field_bytes() + sum(4 * 2 * lv.n * lv.Vc for lv in self.levels[1:])

    def _check_batch_fits(self, n_rhs: int) -> None:
        dev = self.levels[0].device
        if dev.type != "cuda":
            return
        free, _ = torch.cuda.mem_get_info(dev)
        # blocks PyTorch's allocator holds but does not use are free for the solve
        free += torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
        need = self.batch_bytes(n_rhs)
        if need > free:
            p, f = self.params, self._fine_field_bytes()
            per_column = (self.batch_bytes(n_rhs) - self.batch_bytes(0)) / n_rhs
            raise MemoryError(
                f"a batched MG solve of {n_rhs} right-hand sides needs about "
                f"{need / 2**30:.1f} GiB ({per_column / f:.1f} fine fields of "
                f"{f / 2**20:.0f} MiB a column: the GCR basis, 2 x restart {p.restart} fields "
                f"in {p.gcr_dtype}, and 16 float32 fields of the solve's float64 source, "
                f"iterate and residual, its GCR and V-cycle work and smoother, with the "
                f"coarse levels' share; {(need - n_rhs * per_column) / 2**30:.1f} GiB once; "
                f"DeviceMG.batch_buffers) and {free / 2**30:.1f} GiB are free on {dev}: "
                f"lower solver.rhs_batch"
                + ("" if p.gcr_dtype == "bfloat16" else " or set mg.gcr_dtype: bfloat16"))

    def solve_batch(self, b: torch.Tensor, tol: float = 1e-6,
                    maxiter: int = 200) -> GCRResultPk:
        """MG-preconditioned flexible GCR on N fine systems at once, b
        [N, 2(ri), 2(par), 4, 3, T, Z, S] float32, until every column meets
        tol (tpuqcd/mg/dsolve.py:349).  relres is a list, one per column;
        iters the common count.  A zero column stays zero."""
        self._single_card("solve_batch")
        bsq = pk.norm2(b, cols=True)
        live = bsq > 0
        bnorm = torch.sqrt(torch.where(live, bsq, torch.ones_like(bsq)))
        b = b / bnorm
        apply = self.levels[0].apply

        def precond(r):
            return self._vcycle(0, r, cols=True)

        x, r = torch.zeros_like(b), b
        del b                       # r is the source until the first cycle replaces it
        tol2 = float(torch.tensor(tol * tol, dtype=torch.float32))
        rsq, it = pk.norm2(r, cols=True), 0
        while rsq.max().item() > tol2 and it < maxiter:
            x, r = _gcr_cycle(apply, precond, x, r, self.params.restart, cols=True,
                              basis_dtype=self._basis_dtype())
            rsq = pk.norm2(r, cols=True)
            it += self.params.restart
        relres = torch.sqrt(torch.where(live, rsq, torch.zeros_like(rsq))).flatten().tolist()
        x = x * bnorm
        return GCRResultPk(x=x, relres=relres, iters=it,
                           converged=all(rr <= tol for rr in relres))

    def solve_certified_batch(self, b: torch.Tensor, *, tol: float = 1e-10,
                              inner_tol: float | None = None, maxiter: int = 200,
                              max_refine: int = 12, verbose: bool = False) -> CertifiedResult:
        """solve_certified on N right-hand sides in lockstep, b [N, 2(ri),
        2(par), 4, 3, T, Z, S]: per-column normalization and float64
        certification (tpuqcd/mg/dsolve.py:377).  x is float64 in b's
        layout, relres a list, iters the inner iterations (common to the
        columns).  Raises MemoryError before allocating when what the solve
        allocates for N columns does not fit the card (batch_buffers)."""
        self._single_card("solve_certified_batch")
        self._check_batch_fits(b.shape[0])
        if inner_tol is None:
            inner_tol = self.params.inner_tol
        if self._hp is None:
            self._hp = self.levels[0].as_hp()
        hp_level = self._hp
        cols = (-1, *([1] * (b.ndim - 1)))

        def colnorm(x64):
            return torch.sqrt(torch.linalg.vecdot(x64.flatten(1), x64.flatten(1)))

        b64 = b.to(torch.float64)
        bnorm = colnorm(b64)
        live = bnorm > 0
        bnorm = torch.where(live, bnorm, torch.ones_like(bnorm)).reshape(cols)
        b64 = b64 / bnorm
        x = torch.zeros_like(b64)
        total, nref = 0, 0
        for it in range(max_refine + 1):
            r64 = b64 - hp_level.apply(x)
            rel = torch.where(live, colnorm(r64), torch.zeros_like(live, dtype=torch.float64))
            rel = rel.tolist()
            if verbose:
                print(f"[mg] refine {it}: true relres max {max(rel):.3e} ({total} inner iters)")
            if max(rel) <= tol or it == max_refine:
                break
            r32 = r64.to(torch.float32)
            del r64                 # neither is held while the next inner solve runs
            res = self.solve_batch(r32, tol=inner_tol, maxiter=maxiter)
            total += res.iters
            nref += 1
            x += res.x.to(torch.float64)
            del res, r32
        return CertifiedResult(x * bnorm, rel, total, nref)

    def solve(self, b: torch.Tensor, tol: float = 1e-6, maxiter: int = 200) -> GCRResultPk:
        """MG-preconditioned flexible GCR on M x = b in float32.  The
        right-hand side is normalized first: the epsilon floors of
        utils/pkalg are set for O(1) fields."""
        with self._scope(0):
            return self._solve(b, tol, maxiter)

    def _solve(self, b: torch.Tensor, tol: float, maxiter: int) -> GCRResultPk:
        bsq = pk.norm2(b).item()
        if bsq == 0.0:
            return GCRResultPk(x=torch.zeros_like(b), relres=0.0, iters=0, converged=True)
        bnorm = bsq ** 0.5
        b = b * (1.0 / bnorm)
        apply = self.levels[0].apply
        x, r = torch.zeros_like(b), b
        # the float32 comparison of tpuqcd's while_loop condition
        tol2 = float(torch.tensor(tol * tol, dtype=torch.float32))
        rsq, it = 1.0, 0
        while rsq > tol2 and it < maxiter:
            x, r = _gcr_cycle(apply, self.precondition, x, r, self.params.restart,
                              basis_dtype=self._basis_dtype())
            rsq = pk.norm2(r).item()
            it += self.params.restart
        relres = rsq ** 0.5
        return GCRResultPk(x=x * bnorm, relres=relres, iters=it, converged=relres <= tol)

    def solve_certified(self, b: torch.Tensor, *, tol: float = 1e-10,
                        inner_tol: float | None = None, maxiter: int = 200,
                        max_refine: int = 12, verbose: bool = False,
                        hp: str = "float64") -> CertifiedResult:
        """Defect correction to the float64 true residual |b - M x|/|b|:
        each pass solves M dx = r in float32 to inner_tol (default
        params.inner_tol) and adds dx to the float64 iterate; the
        residuals run through the float64 kernel on the 18-real gauge."""
        if hp != "float64":
            raise NotImplementedError(f"hp={hp!r}: only float64 certification is ported "
                                      "(the df64 path exists for a TPU without fast f64)")
        with self._scope(0):
            return self._solve_certified(b, tol, inner_tol, maxiter, max_refine, verbose)

    def _solve_certified(self, b, tol, inner_tol, maxiter, max_refine,
                         verbose) -> CertifiedResult:
        if inner_tol is None:
            inner_tol = self.params.inner_tol
        if self._hp is None:
            self._hp = self.levels[0].as_hp()
        hp_level = self._hp
        b64 = b.to(torch.float64)
        bsq0 = pk.norm2(b64, torch.float64).item()
        if bsq0 == 0.0:
            return CertifiedResult(b64, 0.0, 0, 0)
        bnorm = bsq0 ** 0.5
        b64 = b64 * (1.0 / bnorm)
        x = torch.zeros_like(b64)
        total, nref, rel = 0, 0, 1.0
        for it in range(max_refine + 1):
            t0 = time.perf_counter()
            r64 = b64 - hp_level.apply(x)
            rel = pk.norm2(r64, torch.float64).item() ** 0.5
            t_res = time.perf_counter() - t0
            if rel <= tol or it == max_refine:
                if verbose:
                    print(f"[mg] refine {it}: true relres {rel:.3e} ({total} inner iters)")
                break
            t0 = time.perf_counter()
            res = self.solve(r64.to(torch.float32), tol=inner_tol, maxiter=maxiter)
            total += res.iters
            nref += 1
            x += res.x.to(torch.float64)
            if verbose:
                print(f"[mg] refine {it}: true relres {rel:.3e} (f64 residual "
                      f"{t_res:.2f}s, inner {res.iters} iters "
                      f"{time.perf_counter() - t0:.2f}s)")
        return CertifiedResult(x * bnorm, rel, total, nref)


def _check_params(params: DeviceMGParams) -> None:
    if len(params.n_vec) != len(params.block):
        raise ValueError(f"n_vec {params.n_vec} and block {params.block} need one entry "
                         "per coarsening")
