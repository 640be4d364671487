"""Adaptive multigrid on the device: setup, V-cycle, certified solve.

Counterpart of ``tpuqcd/mg/dsolve.py`` (single right-hand side, float64
certification).  The MG-preconditioned flexible GCR runs on the device;
the host reads the residual norm once per restart cycle (tpuqcd's
``lax.while_loop`` condition), and an outer defect-correction loop
against the float64 operator certifies the true residual.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import torch

from ..solvers.krylov_pk import (GCRResultPk, _gcr_cycle, bicgstab_fixed_pk, cg_fixed_pk,
                                 gcr_fixed_pk, mr_smoother_pk)
from ..utils import pkalg as pk
from ..utils.profile import sync
from .device import (DeviceCoarseTransfer, DeviceFineLevel, DeviceFineTransfer,
                     build_coarse_device, g5_fine)


@dataclasses.dataclass
class DeviceMGParams:
    """n_vec per coarsening, geometric blocks, setup depth, cycle
    smoothing, coarsest-level work, mu boost (tpuqcd's DeviceMGParams).

    smoother_dtype "bfloat16" runs the fine smoother on a bfloat16 twin
    (kernel storage); coarse_dtype "bfloat16" rounds the coarse links to
    bfloat16; setup_solver "cgne" is CG on M^dag M = g5 M_{-f} g5 M_f,
    "bicgstab" fixed BiCGStab on M (coarse levels always use BiCGStab).
    gcr_dtype and vec_dtype other than float32 were memory fitting for a
    16 GB TPU and are not ported: DeviceMG refuses them.
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
        self.levels, self.transfers = [fine], []
        self.setup_seconds = {}
        level = fine
        for depth, nv in enumerate(params.n_vec):
            t0 = time.perf_counter()
            nulls = self._gen_null_vectors(level, nv, params.setup_iters, generator,
                                           params.setup_solver)
            sync(fine.device)
            self.setup_seconds[f"nulls{depth}"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            if depth == 0:
                tr = DeviceFineTransfer.from_pk(fine.lat, params.block[depth], nulls)
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
        if params.mu_factor != 1.0 and fine.mu != 0.0:
            delta = 2.0 * fine.kappa * fine.mu * (params.mu_factor - 1.0)
            self.levels[-1] = self.levels[-1].boosted(delta)
        if params.coarse_dtype == "bfloat16":
            self.levels[1:] = [lv.rounded(torch.bfloat16) for lv in self.levels[1:]]
        self._finish()

    @classmethod
    def from_parts(cls, fine: DeviceFineLevel, params: DeviceMGParams, transfers,
                   coarse_levels) -> "DeviceMG":
        """A hierarchy from given transfers and coarse levels (no setup),
        as utils/checkpoint.load_device_mg rebuilds one."""
        _check_params(params)
        mg = cls.__new__(cls)
        mg.params = params
        mg.levels = [fine, *coarse_levels]
        mg.transfers = list(transfers)
        mg.setup_seconds = {}
        mg._finish()
        return mg

    def _finish(self):
        fine = self.levels[0]
        self.sloppy_fine = (fine.sloppy(torch.bfloat16)
                            if self.params.smoother_dtype == "bfloat16" else None)
        self._hp = None

    @staticmethod
    def _gen_null_vectors(level, n_vec: int, iters: int, generator: torch.Generator,
                          setup_solver: str = "bicgstab") -> torch.Tensor:
        """n_vec normalized near-null vectors [n_vec, *field shape], each
        from a random start."""
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
                buf = torch.empty((n_vec, *x.shape), dtype=x.dtype, device=x.device)
            buf[i] = x
        return buf

    # --- the cycle -----------------------------------------------------------

    def _vcycle(self, depth: int, b: torch.Tensor) -> torch.Tensor:
        p = self.params
        lv = self.levels[depth]
        if depth == len(self.levels) - 1:
            return gcr_fixed_pk(lv.apply, b, iters=p.coarse_iters, restart=p.restart)

        def smooth(rhs):
            if depth == 0 and self.sloppy_fine is not None:
                xs = mr_smoother_pk(self.sloppy_fine.apply, rhs.to(torch.bfloat16),
                                    iters=p.smoother_iters)
                return xs.to(torch.float32)
            return mr_smoother_pk(lv.apply, rhs, iters=p.smoother_iters)

        tr = self.transfers[depth]
        x = smooth(b)
        r = pk.caxpy(-1.0, 0.0, lv.apply(x), b)
        xc = self._vcycle(depth + 1, tr.restrict(r))
        x = x + tr.prolong(xc)
        r = pk.caxpy(-1.0, 0.0, lv.apply(x), b)
        return x + smooth(r)

    def precondition(self, r: torch.Tensor) -> torch.Tensor:
        """One V-cycle ~ M^{-1} r."""
        return self._vcycle(0, r)

    def solve(self, b: torch.Tensor, tol: float = 1e-6, maxiter: int = 200) -> GCRResultPk:
        """MG-preconditioned flexible GCR on M x = b in float32.  The
        right-hand side is normalized first: the epsilon floors of
        utils/pkalg are set for O(1) fields."""
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
            x, r = _gcr_cycle(apply, self.precondition, x, r, self.params.restart)
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
    for name in ("gcr_dtype", "vec_dtype"):
        if getattr(params, name) != "float32":
            raise NotImplementedError(
                f"DeviceMGParams.{name}={getattr(params, name)!r}: bfloat16 solver "
                "buffers were memory fitting for a 16 GB TPU and are not ported")
    if len(params.n_vec) != len(params.block):
        raise ValueError(f"n_vec {params.n_vec} and block {params.block} need one entry "
                         "per coarsening")
