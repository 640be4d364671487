"""Even-odd Wilson hop with fused twisted-mass and clover epilogues: the
CUDA kernel, its plain PyTorch version, and the dispatch between them.

Counterpart of ``tpuqcd/ops/dslash_pallas.py::dslash_eo_pallas`` (the
TPU kernel) and ``tpuqcd/ops/dslash_xla.py::dslash_eo_dev_ri`` (whose f64
role, the certification operator, the double instantiation takes over).
The kernel is ``csrc/dslash_eo.cuh``; ``csrc/dslash_eo_inst.cu`` is
compiled once per storage type, arithmetic type and link format (twelve
nvcc processes side by side, for sm_90a) and linked with the entries of
``csrc/dslash_eo.cu`` at first use into ``tpuqcd_torch/_build/`` (rebuilt
when a source changes); the library is loaded with ctypes.

Dispatch has no fallback: a CUDA tensor launches the kernel or raises,
a CPU tensor runs ``dslash_eo_plain``.  A single bfloat16 launch takes the
pair kernel (two output sites a thread, every operand pair one 4-byte
bfloat16x2 access) where ``pair_sites`` admits its shapes (reconstruct-12
links, Xh = Lx/2 even, every pointer 4-byte aligned, every re/im plane
stride even), and the one-site kernel otherwise; both give the same bits.
``dslash_eo_one_site`` runs the one-site kernel on any operands, for
holding the two to each other.

    out = dslash_eo(u, psi, src_parity, lat)            # D_{q<-p} psi
    out = dslash_eo(u, psi, 0, lat, epilogue="twist_inv", kappa=k, mu=m)
    out = dslash_eo(u, t1, 1, lat, epilogue="xpay", kappa=k, mu=m, psi0=psi)

Fields: psi, psi0 and the result [2(ri), 4, 3, T, Z, S]; u
[4, 2, 3, 3, 2, T, Z, S], reconstruct-12 [4, 2, 2, 3, 2, T, Z, S] or
reconstruct-8 [4, 2, 4, 1, 2, T, Z, S] (utils/packed.pack_gauge8; the TPU
kernel's K5), of the same dtype as psi (float32, bfloat16 or float64).
The format is read from the gauge's shape.  bfloat16 is storage only and
the arithmetic float32, unless ``compute="bf16"``: then the projection,
mat-vec, accumulation and epilogue run in bfloat16 (the link
reconstruction stays float32); other storage raises.

A batch: psi (and psi0, out) [N, 2(ri), 4, 3, T, Z, S] is N right-hand
sides in one launch (the TPU kernel under ``jax.vmap``); u and clover are
shared.  It composes with every epilogue, dagger, dirs and dtype, not
with legs_out or halo mode.  N > 1 takes the batched kernel, which reads
and rebuilds each link once for all N columns (``batch_geometry``); a
batch of one takes the single kernel.

Epilogues, with tw = 2 kappa mu flavor:

    "none"       out = D psi
    "twist_inv"  out = (1 - i tw g5) / (1 + tw^2) . D psi
    "xpay"       out = (1 + i tw g5) psi0 - k2 . D psi,  k2 = kappa^2
                 (or xpay_scale: kappa gives the full two-parity M)
    "clover_inv"  out = cl . D psi            (cl the twisted inverse of A)
    "clover_xpay" out = (cl + i tw g5) psi0 - k2 . D psi      (cl = A)

The clover epilogues (the TPU kernel's K3) take ``clover``, one parity's
packed chiral blocks [2(ri), 2(chir), 6, 6, T, Z, S] at the output
parity (ops/clover.py), contiguous and of the spinor's dtype.

Leg selection, for MG Galerkin probing (the TPU kernel's K4 modes):

    dirs=((mu, sign), ...)   only those hop legs (mu 0..3 = x, y, z, t;
                             sign +1 forward, -1 backward); epilogue as usual
    legs_out=True            each selected leg (all 8 without dirs) stored
                             apart: [n_legs, 2(ri), 4, 3, T, Z, S], slots in
                             LEG_ORDER (mu-major, +1 before -1) whatever the
                             order of dirs; epilogue "none" only

Halo mode, for one shard of a (t, z) decomposition (the TPU kernel's
K6; parallel/sharded.py builds the operands): ``lat`` is the shard's
local lattice and ``halo=Halo(...)`` carries the neighbour shards' faces,
which the t and z legs read where they step past the local edge:

    t_m, t_p   spinor faces at t-1, t+1 [2(ri), ns, 3, Z, S]
    z_m, z_p   spinor faces at z-1, z+1 [2(ri), ns, 3, T, S]
               ns = 4 full spinors, or 2 half-spinors projected with the
               launch's tables (parallel/sharded.half_tables)
    u_t, u_z   mu=3 links of the t-1 face [R, 3, 2(ri), Z, S] and mu=2
               links of the z-1 face [R, 3, 2(ri), T, S], source parity
    t_offset   the shard's global t, and t_global the global Lt: the
               reconstruct-12 phase is a global-t condition

Spinor operands may be views whose re/im planes are any stride apart
(the parity halves of an MG field [2(ri), 2(par), 4, 3, T, Z, S]); each
plane itself must be contiguous, and the fields of a batch may be any
stride apart.  ``out=`` writes the result into such a view instead of a
new tensor.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch

from ..gammas import (G5_DIAG, HALF_PROJ_MINUS, HALF_PROJ_PLUS,
                      HALF_RECON_MINUS, HALF_RECON_PLUS)
from ..lattice import Lattice
from ..utils.packed import recon8_rows

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
#: the kernel, its one-instantiation-set translation unit and the entries
SOURCES = (CSRC / "dslash_eo.cuh", CSRC / "dslash_eo_inst.cu", CSRC / "dslash_eo.cu")
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: entry suffix -> (storage type, arithmetic type) of an instantiation set
_TYPES = {"f32": ("float", "float"), "bf16": ("__nv_bfloat16", "float"),
          "f64": ("double", "double"), "bf16c": ("__nv_bfloat16", "__nv_bfloat16")}
#: link rows of the gauge operand -> reals a link (18-real, reconstruct-12, -8)
LINK_ROWS = {3: 18, 2: 12, 4: 8}

EPILOGUES = {"none": 0, "twist_inv": 1, "xpay": 2, "clover_inv": 3, "clover_xpay": 4}
CLOVER_EPILOGUES = ("clover_inv", "clover_xpay")
#: the kernel's textual leg order: slot order of legs_out, bit order of
#: the leg mask (bit 2*mu + (sign < 0))
LEG_ORDER = tuple((mu, s) for mu in range(4) for s in (+1, -1))
_ENTRY = {torch.float32: "tq_dslash_eo_f32", torch.bfloat16: "tq_dslash_eo_bf16",
          torch.float64: "tq_dslash_eo_f64"}
_ENTRY_BF16C = "tq_dslash_eo_bf16c"
COMPUTES = ("f32", "bf16")

#: launches of the kernel, by storage dtype name ("float32"), with the
#: leg modes, the clover epilogues and halo mode apart ("float32:dirs",
#: "float32:legs_out", "float32:clover_inv", "float32:clover_xpay",
#: "float32:halo", "float32:clover_xpay:halo"), bfloat16 arithmetic under
#: "bfloat16:compute_bf16", reconstruct-8 links under "float32:recon8" (the
#: two right after the dtype), a batched launch with a last ":batch" (one
#: count per launch whatever N), and calls of the plain version under
#: "plain".  A single bfloat16 launch that takes the one-site kernel, where
#: ``pair_sites`` refuses the pair kernel, adds a last ":one_site"
#: ("bfloat16:one_site", "bfloat16:clover_xpay:halo:one_site"); legs_out
#: and batches keep their keys.  Each kernel launch adds one; nothing else
#: does.
counts: collections.Counter = collections.Counter()


def reset_counts() -> None:
    counts.clear()


class Halo(NamedTuple):
    """The face operands of a shard's hop (see the module docstring).
    A shard of a y-sharded mesh also carries its y faces y_m, y_p [2(ri),
    ns, 3, T, Z, X/2] and the mu=1 links of the y-1 face u_y [R, 3,
    2(ri), T, Z, X/2], which only the overlap engine reads
    (parallel/overlap.py): the kernel refuses them."""
    t_m: torch.Tensor
    t_p: torch.Tensor
    z_m: torch.Tensor
    z_p: torch.Tensor
    u_t: torch.Tensor
    u_z: torch.Tensor
    t_offset: int
    t_global: int
    y_m: torch.Tensor | None = None
    y_p: torch.Tensor | None = None
    u_y: torch.Tensor | None = None

    @property
    def spins(self) -> int:
        return self.t_m.shape[1]


# --------------------------------------------------------------------------
# build and binding

class _Library:
    """The compiled kernel library, built and loaded once per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None
        self.path: Path | None = None
        self.build_seconds = 0.0
        self.build_log = ""

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._load()
            return self._lib

    def _load(self) -> ctypes.CDLL:
        src = b"".join(p.read_bytes() for p in SOURCES)
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        path = BUILD_DIR / f"dslash_eo-{tag}.so"
        if not path.exists():
            self._build(path)
        lib = ctypes.CDLL(str(path))
        for name in (*_ENTRY.values(), _ENTRY_BF16C):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                           + [ctypes.c_double] * 2 + [ctypes.c_int] * 3
                           + [ctypes.c_int64] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6
                           + [ctypes.c_int] * 6 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.tq_error_string.argtypes = [ctypes.c_int]
        lib.tq_error_string.restype = ctypes.c_char_p
        self.path = path
        return lib

    def _build(self, path: Path) -> None:
        """Every translation unit in an nvcc process of its own, all
        started together, then one link."""
        nvcc = shutil.which("nvcc")
        if nvcc is None:
            cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
            nvcc = str(cand) if cand.exists() else None
        if nvcc is None:
            raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): cannot "
                               f"build {SOURCES[-1].name}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        work = BUILD_DIR / f"{path.stem}.{os.getpid()}.obj"
        work.mkdir(exist_ok=True)
        units = [("entries", [str(SOURCES[2])])]
        for sfx, (storage, compute) in _TYPES.items():
            for rows in LINK_ROWS:
                name = f"tq_dslash_eo_{sfx}_r{rows}"
                units.append((name, [f"-DTQ_STORAGE={storage}", f"-DTQ_COMPUTE={compute}",
                                     f"-DTQ_NROW={rows}", f"-DTQ_NAME={name}",
                                     str(SOURCES[1])]))
        t0 = time.perf_counter()
        procs = [(name, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(work / f"{name}.o"), *args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for name, args in units]
        logs, failed = [], []
        for name, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        if not failed:
            link = subprocess.run(
                [nvcc, "-shared", "-o", str(tmp), *(str(work / f"{n}.o") for n, _ in units)],
                capture_output=True, text=True)
            logs.append(f"== link\n{link.stdout}{link.stderr}")
            if link.returncode != 0:
                failed.append("link")
        self.build_seconds = time.perf_counter() - t0
        self.build_log = "".join(logs)
        shutil.rmtree(work, ignore_errors=True)
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{self.build_log}")
        os.replace(tmp, path)


library = _Library()


#: the batched kernel's site tile (a warp's 32 lanes are a block's sites)
#: and its most column warps (csrc/dslash_eo.cuh: BATCH_SITES,
#: BATCH_MAX_WARPS); the t-slices whose tiles consecutive blocks take
BATCH_SITES, BATCH_MAX_WARPS, BATCH_T_BLOCK = 32, 4, 8
#: the H100's L2 cache; a t-slice is read again as a neighbour two slices
#: of streaming later, in about half of it
L2_BYTES = 50 * 2 ** 20


class BatchGeometry(NamedTuple):
    """The launch of the batched kernel: blocks of BATCH_SITES sites and
    ``warps`` column warps; warp w takes the columns w, w + warps, ...
    (``columns``).  ``shared_bytes`` is the
    block's link tile, the 8 legs' rebuilt 3x3 links of its sites in the
    arithmetic type, the same for every link format.  ``t_block``
    consecutive blocks take the same sites of as many consecutive
    t-slices (``tile``), so that the t-neighbours of N columns are read
    again while the L2 cache holds them; 1 keeps the site order."""
    warps: int
    shared_bytes: int
    t_block: int

    @property
    def threads(self) -> int:
        return BATCH_SITES * self.warps

    def columns(self, warp: int, n_batch: int) -> range:
        return range(warp, n_batch, self.warps)

    def tile(self, block: int, per_slice: int) -> int:
        """The site tile of a block, per_slice tiles to a t-slice (the
        kernel's order)."""
        if self.t_block == 1:
            return block
        t_in, rest = block % self.t_block, block // self.t_block
        return ((rest // per_slice) * self.t_block + t_in) * per_slice + rest % per_slice


def batch_geometry(n_batch: int, lat: Lattice, dtype: torch.dtype, link_reals: int,
                   compute: str = "f32") -> BatchGeometry | None:
    """The batched kernel's geometry for N = ``n_batch`` columns of storage
    ``dtype`` and links of ``link_reals`` reals on ``lat``, or None for N =
    1 (the single kernel).  The fewest steps a warp takes with at most
    BATCH_MAX_WARPS warps, then the fewest warps that keep them: N = 5
    runs 3 warps of 2, 2, 1 columns, not 4 of 2, 1, 1, 1.  Tiles go
    BATCH_T_BLOCK t-slices at a time where a t-slice streams more than a
    quarter of the L2 (N spinors read, N read by xpay, N written, 8 links
    a site), and where a t-slice is whole tiles and T a multiple of it;
    else in site order, which a slice that stays in the L2 reads faster."""
    if not 1 <= n_batch <= 65535:
        raise ValueError(f"a batch holds 1 to 65535 fields, got {n_batch}")
    if n_batch == 1:
        return None
    steps = -(-n_batch // min(BATCH_MAX_WARPS, n_batch))
    warps = -(-n_batch // steps)
    arith = 2 if compute == "bf16" else 8 if dtype == torch.float64 else 4
    T, Z, S = lat.site_shape
    item = torch.empty((), dtype=dtype).element_size()
    slice_bytes = Z * S * (3 * 24 * n_batch + 8 * link_reals) * item
    blocked = (slice_bytes > L2_BYTES / 4 and T % BATCH_T_BLOCK == 0
               and Z * S % BATCH_SITES == 0)
    return BatchGeometry(warps, 8 * 18 * BATCH_SITES * arith, BATCH_T_BLOCK if blocked else 1)


# --------------------------------------------------------------------------
# checks shared by the kernel and the plain version

def _ri_stride(x: torch.Tensor, name: str, lead: int = 0) -> int:
    """Elements from the re to the im plane of a spinor operand whose
    dims after ``lead`` leading dims are [2(ri), 4, 3, T, Z, S], each
    plane contiguous; raises otherwise."""
    planes = x.shape[lead + 1:]
    want, step = [], 1
    for d in reversed(planes):
        want.append(step)
        step *= d
    if tuple(x.stride()[lead + 1:]) != tuple(reversed(want)):
        raise ValueError(f"{name} is not contiguous within its re/im planes "
                         f"(strides {tuple(x.stride())})")
    return x.stride(lead)


def _leg_mask(dirs) -> int:
    if dirs is None:
        return 255
    mask = 0
    for leg in dirs:
        if tuple(leg) not in LEG_ORDER:
            raise ValueError(f"dirs entries must be (mu, sign) with mu in 0..3 and "
                             f"sign +-1, got {leg!r}")
        bit = 1 << LEG_ORDER.index(tuple(leg))
        if mask & bit:
            raise ValueError(f"dirs lists {leg!r} twice")
        mask |= bit
    if not mask:
        raise ValueError("dirs is empty")
    return mask


def _check_halo(halo: Halo, u, psi, lat, legs_out):
    """Validate the face operands; returns them as (name, tensor) pairs."""
    if legs_out:
        raise ValueError("halo mode composes with the summed hop only, not legs_out")
    if halo.y_m is not None:
        raise ValueError("halo mode reads t and z faces only; a shard of a y-sharded mesh "
                         "takes the overlap engine (parallel/overlap.py)")
    T, Z, S = lat.site_shape
    ns = halo.spins
    if ns not in (2, 4):
        raise ValueError(f"spinor faces hold 4 spins or 2 projected ones, got {ns}")
    rows, cols = u.shape[2:4]
    want = {"t_m": (2, ns, 3, Z, S), "t_p": (2, ns, 3, Z, S), "z_m": (2, ns, 3, T, S),
            "z_p": (2, ns, 3, T, S), "u_t": (rows, cols, 2, Z, S),
            "u_z": (rows, cols, 2, T, S)}
    faces = []
    for name, shape in want.items():
        x = getattr(halo, name)
        if tuple(x.shape) != shape or x.dtype != psi.dtype:
            raise ValueError(f"halo.{name} must be {psi.dtype} {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"halo.{name} is not contiguous")
        faces.append((f"halo.{name}", x))
    if not (isinstance(halo.t_offset, int) and isinstance(halo.t_global, int)
            and 0 <= halo.t_offset and halo.t_offset + T <= halo.t_global):
        raise ValueError(f"halo needs the shard's global t_offset and the global Lt: got "
                         f"t_offset {halo.t_offset!r}, t_global {halo.t_global!r}, local T {T}")
    return faces


def _check(u, psi, src_parity, lat, epilogue, psi0, dirs=None, legs_out=False, out=None,
           clover=None, halo=None, compute="f32"):
    """Validate the operands; returns (leg mask, output shape, batch dims)."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {sorted(EPILOGUES)}, got {epilogue!r}")
    if legs_out and epilogue != "none":
        raise ValueError("legs_out composes with epilogue='none' only")
    mask = _leg_mask(dirs)
    if src_parity not in (0, 1):
        raise ValueError(f"src_parity must be 0 or 1, got {src_parity!r}")
    if psi.dtype not in _ENTRY:
        raise ValueError(f"psi dtype {psi.dtype} is not float32, bfloat16 or float64")
    if compute not in COMPUTES:
        raise ValueError(f"compute must be one of {COMPUTES}, got {compute!r}")
    if compute == "bf16" and psi.dtype != torch.bfloat16:
        raise ValueError("compute='bf16' needs bfloat16 spinor storage")
    sites = lat.site_shape
    nb = psi.ndim - 6
    if nb not in (0, 1) or tuple(psi.shape[nb:]) != (2, 4, 3, *sites):
        raise ValueError(f"psi shape {tuple(psi.shape)} is neither {(2, 4, 3, *sites)} nor a "
                         f"batch [N, 2, 4, 3, ...] of it")
    if nb and (legs_out or halo is not None):
        raise ValueError("a batch composes with the summed hop only, not legs_out or halo mode")
    if nb and not 1 <= psi.shape[0] <= 65535:
        raise ValueError(f"a batch holds 1 to 65535 fields, got {psi.shape[0]}")
    if u.dtype != psi.dtype:
        raise ValueError(f"gauge dtype {u.dtype} != spinor dtype {psi.dtype}")
    if u.ndim != 8 or tuple(u.shape[:2]) != (4, 2) \
            or tuple(u.shape[2:4]) not in ((3, 3), (2, 3), (4, 1)) \
            or tuple(u.shape[4:]) != (2, *sites):
        raise ValueError(f"gauge shape {tuple(u.shape)} is none of "
                         f"{(4, 2, 3, 3, 2, *sites)}, {(4, 2, 2, 3, 2, *sites)} "
                         f"(reconstruct-12), {(4, 2, 4, 1, 2, *sites)} (reconstruct-8)")
    if not u.is_contiguous():
        raise ValueError("u is not contiguous (a u[:, :, :2] view must be copied: "
                         "utils.packed.pack_gauge12)")
    _ri_stride(psi, "psi", lead=nb)
    tensors = [("psi", psi)]
    if epilogue in CLOVER_EPILOGUES:
        if clover is None:
            raise ValueError(f"the {epilogue} epilogue needs clover")
        if tuple(clover.shape) != (2, 2, 6, 6, *sites) or clover.dtype != psi.dtype:
            raise ValueError(f"clover must be {psi.dtype} {(2, 2, 6, 6, *sites)}, got "
                             f"{clover.dtype} {tuple(clover.shape)}")
        if not clover.is_contiguous():
            raise ValueError("clover is not contiguous")
        tensors.append(("clover", clover))
    elif clover is not None:
        raise ValueError(f"clover is given, but epilogue {epilogue!r} does not read it")
    if epilogue in ("xpay", "clover_xpay"):
        if psi0 is None:
            raise ValueError(f"the {epilogue} epilogue needs psi0")
        if psi0.shape != psi.shape or psi0.dtype != psi.dtype:
            raise ValueError("psi0 must match psi in shape and dtype")
        _ri_stride(psi0, "psi0", lead=nb)
        tensors.append(("psi0", psi0))
    n_legs = bin(mask).count("1")
    shape = (n_legs, *psi.shape) if legs_out else tuple(psi.shape)
    if out is not None:
        if tuple(out.shape) != shape or out.dtype != psi.dtype:
            raise ValueError(f"out must be {psi.dtype} {shape}, got {out.dtype} "
                             f"{tuple(out.shape)}")
        _ri_stride(out, "out", lead=1 if legs_out else nb)
        tensors.append(("out", out))
    if halo is not None:
        tensors += _check_halo(halo, u, psi, lat, legs_out)
    for name, x in tensors + [("u", u)]:
        if x.device != psi.device:
            raise ValueError(f"{name} is on {x.device}, psi on {psi.device}")
    return mask, shape, nb


def pair_sites(lat: Lattice, psi: torch.Tensor, psi0: torch.Tensor | None = None,
               out: torch.Tensor | None = None, u: torch.Tensor | None = None,
               clover: torch.Tensor | None = None, halo: Halo | None = None,
               legs_out: bool = False) -> bool:
    """Whether a launch takes the pair kernel (two output sites a thread,
    every operand pair one 4-byte bfloat16x2 access), decided by shape
    alone: bfloat16 storage (either arithmetic), one field (no batch axis,
    or a batch of one), not legs_out, reconstruct-12 links, Xh = Lx/2
    even, every operand's pointer 4-byte aligned and every re/im plane
    stride even.
    Xh even makes every other element stride the kernel derives (the
    site counts of a plane, a face's planes, the clover operand's 72 n)
    even.  psi0 is an operand only where the epilogue reads it; out None
    is a new, aligned tensor.  Otherwise the one-site kernel runs, and a
    bfloat16 single launch counts under a last ":one_site"."""
    nb = psi.ndim - 6
    if psi.dtype != torch.bfloat16 or legs_out or (nb and psi.shape[0] != 1) or lat.Lx // 2 % 2:
        return False
    if u is not None and u.shape[2] != 2:
        return False
    fields = [x for x in (psi, psi0, out) if x is not None]
    operands = fields + [x for x in (u, clover) if x is not None]
    if halo is not None:
        operands += list(halo[:6])
    return (all(x.data_ptr() % 4 == 0 for x in operands)
            and all(x.stride(nb) % 2 == 0 for x in fields))


def _site_terms(kappa, mu, flavor, xpay_scale):
    tw = 2.0 * kappa * mu * flavor
    k2 = kappa * kappa if xpay_scale is None else xpay_scale
    return tw, k2


def dslash_eo(u: torch.Tensor, psi: torch.Tensor, src_parity: int, lat: Lattice, *,
              dagger: bool = False, epilogue: str = "none", kappa: float = 0.0,
              mu: float = 0.0, flavor: int = 1, psi0: torch.Tensor | None = None,
              t_boundary: int = -1, xpay_scale: float | None = None,
              dirs: tuple | None = None, legs_out: bool = False,
              out: torch.Tensor | None = None,
              clover: torch.Tensor | None = None,
              halo: Halo | None = None, compute: str = "f32") -> torch.Tensor:
    """D_{q<-p} psi with a fused epilogue; result at parity 1 - src_parity.

    t_boundary is the fermion T-boundary phase folded into the stored
    links (-1 antiperiodic, +1 periodic); only reconstruct-12 and -8 read
    it.  A batch, dirs, legs_out, out, clover, halo and compute: see the
    module docstring.  A bfloat16 launch that ``pair_sites`` admits takes
    the pair kernel.
    """
    return _dslash_eo(u, psi, src_parity, lat, None, dagger=dagger, epilogue=epilogue,
                      kappa=kappa, mu=mu, flavor=flavor, psi0=psi0, t_boundary=t_boundary,
                      xpay_scale=xpay_scale, dirs=dirs, legs_out=legs_out, out=out,
                      clover=clover, halo=halo, compute=compute)


def dslash_eo_one_site(u: torch.Tensor, psi: torch.Tensor, src_parity: int, lat: Lattice,
                       **kw) -> torch.Tensor:
    """``dslash_eo`` through the one-site kernel whatever the shape, on CUDA
    tensors: the operands on which the pair kernel ran, for holding it to
    the one-site kernel bit for bit and timing the two (chip_smoke.py,
    tests/test_torch_kernels_gpu.py).  No solver calls it."""
    if psi.device.type != "cuda":
        raise ValueError("dslash_eo_one_site launches the CUDA kernel: psi must be on a "
                         f"CUDA device, got {psi.device}")
    return _dslash_eo(u, psi, src_parity, lat, False, **kw)


def _dslash_eo(u, psi, src_parity, lat, pair, *, dagger=False, epilogue="none", kappa=0.0,
               mu=0.0, flavor=1, psi0=None, t_boundary=-1, xpay_scale=None, dirs=None,
               legs_out=False, out=None, clover=None, halo=None, compute="f32"):
    """dslash_eo with the kernel's sites a thread given (pair False: one)
    or, pair None, by pair_sites."""
    kw = dict(dagger=dagger, epilogue=epilogue, kappa=kappa, mu=mu, flavor=flavor,
              psi0=psi0, t_boundary=t_boundary, xpay_scale=xpay_scale, dirs=dirs,
              legs_out=legs_out, out=out, clover=clover, halo=halo, compute=compute)
    mask, shape, nb = _check(u, psi, src_parity, lat, epilogue, psi0, dirs, legs_out, out,
                             clover, halo, compute)
    if psi.device.type == "cpu":
        return dslash_eo_plain(u, psi, src_parity, lat, **kw)
    if psi.device.type != "cuda":
        raise ValueError(f"no Dslash for device {psi.device}")
    tw, k2 = _site_terms(kappa, mu, flavor, xpay_scale)
    fn = getattr(library.get(), _ENTRY_BF16C if compute == "bf16" else _ENTRY[psi.dtype])
    if out is None:
        out = torch.empty(shape, dtype=psi.dtype, device=psi.device)
    if pair is None:
        pair = pair_sites(lat, psi, psi0 if epilogue in ("xpay", "clover_xpay") else None, out,
                          u, clover, halo, legs_out)
    T, Z, _ = lat.site_shape
    stream = torch.cuda.current_stream(psi.device).cuda_stream
    faces = ([x.data_ptr() for x in halo[:6]] + [1, halo.spins, halo.t_offset, halo.t_global]
             if halo is not None else [None] * 6 + [0, 4, 0, T])

    def batch_stride(x):
        return x.stride(0) if nb and x is not None else 0

    geom = (batch_geometry(psi.shape[0], lat, psi.dtype, LINK_ROWS[u.shape[2]], compute)
            if nb else None)

    err = fn(u.data_ptr(), psi.data_ptr(), psi0.data_ptr() if psi0 is not None else None,
             clover.data_ptr() if clover is not None else None, out.data_ptr(), T, Z,
             lat.Ly, lat.Lx // 2, u.shape[2], src_parity, int(dagger), EPILOGUES[epilogue],
             tw, k2, int(t_boundary), mask, int(legs_out), psi.stride(nb),
             psi0.stride(nb) if psi0 is not None else 0, out.stride(1 if legs_out else nb),
             out.stride(0) if legs_out else 0, batch_stride(psi), batch_stride(psi0),
             batch_stride(out), psi.shape[0] if nb else 1,
             *((geom.warps, geom.shared_bytes, geom.t_block) if geom else (0, 0, 0)),
             *faces, int(pair), psi.device.index, stream)
    if err != 0:
        msg = library.get().tq_error_string(err).decode()
        raise RuntimeError(f"dslash_eo kernel launch failed: {msg} (CUDA error {err})")
    counts[_count_key(psi, u, compute, dirs, legs_out, clover, epilogue, halo, nb, pair)] += 1
    return out


def _count_key(psi, u, compute, dirs, legs_out, clover, epilogue, halo, nb, pair) -> str:
    """The counts key of a kernel launch (see ``counts``)."""
    key = str(psi.dtype).removeprefix("torch.")
    if compute == "bf16":
        key += ":compute_bf16"
    if u.shape[2] == 4:
        key += ":recon8"
    if legs_out:
        key += ":legs_out"
    elif dirs is not None:
        key += ":dirs"
    elif clover is not None:
        key += ":" + epilogue
    if halo is not None:
        key += ":halo"
    if nb:
        key += ":batch"
    elif psi.dtype == torch.bfloat16 and not legs_out and not pair:
        key += ":one_site"
    return key


# --------------------------------------------------------------------------
# plain PyTorch version

def hop_index(lat: Lattice, src_parity: int, device=None, halo: bool = False) -> torch.Tensor:
    """int64 [4(mu), 2(fwd, bwd), T*Z*S]: flat site index of the +mu and
    -mu neighbour of every output site, with periodic wrap and the eo
    x-shift rule (the same index math as the kernel).  With ``halo`` a t
    or z leg past the local edge indexes the faces appended after the N
    local sites: t-1 face at N, t+1 at N + Z*S, z-1 at N + 2*Z*S, z+1 at
    N + 2*Z*S + T*S (each face [Z, S] or [T, S], site index minor)."""
    T, Z, Y, Xh = lat.Lt, lat.Lz, lat.Ly, lat.Lx // 2
    ar = lambda n: torch.arange(n, device=device)  # noqa: E731
    t = ar(T)[:, None, None, None]
    z = ar(Z)[None, :, None, None]
    y = ar(Y)[None, None, :, None]
    xh = ar(Xh)[None, None, None, :]
    o_p = (t + z + y + src_parity) % 2 == 1

    def flat(t_, z_, y_, x_):
        return (((t_ * Z + z_) * Y + y_) * Xh + x_).expand(T, Z, Y, Xh).reshape(-1)

    legs = [
        (flat(t, z, y, torch.where(o_p, xh, (xh + 1) % Xh)),
         flat(t, z, y, torch.where(o_p, (xh - 1) % Xh, xh))),
        (flat(t, z, (y + 1) % Y, xh), flat(t, z, (y - 1) % Y, xh)),
        (flat(t, (z + 1) % Z, y, xh), flat(t, (z - 1) % Z, y, xh)),
        (flat((t + 1) % T, z, y, xh), flat((t - 1) % T, z, y, xh)),
    ]
    idx = torch.stack([torch.stack(pair) for pair in legs])
    if halo:
        n, S = T * Z * Y * Xh, Y * Xh
        zero = torch.zeros((T, Z, Y, Xh), dtype=torch.int64, device=device)
        i_t = (z * S + y * Xh + xh + zero).reshape(-1)          # index in a t face
        i_z = (t * S + y * Xh + xh + zero).reshape(-1)          # index in a z face
        tt, zz = (t + zero).reshape(-1), (z + zero).reshape(-1)
        idx[3, 1] = torch.where(tt == 0, n + i_t, idx[3, 1])
        idx[3, 0] = torch.where(tt == T - 1, n + Z * S + i_t, idx[3, 0])
        idx[2, 1] = torch.where(zz == 0, n + 2 * Z * S + i_z, idx[2, 1])
        idx[2, 0] = torch.where(zz == Z - 1, n + 2 * Z * S + T * S + i_z, idx[2, 0])
    return idx


def _rebuild_row2(uc: torch.Tensor) -> torch.Tensor:
    """Reconstruct-12 rows [..., 2, 3, n] complex -> the third row
    conj(row0 x row1) [..., 3, n], without a phase."""
    return torch.conj(torch.linalg.cross(uc[..., 0, :, :], uc[..., 1, :, :], dim=-2))


def expand_links(u: torch.Tensor, lat: Lattice, t_boundary: int = -1, t_offset: int = 0,
                 t_global: int | None = None) -> torch.Tensor:
    """Packed gauge -> complex [4, 2, 3, 3, T*Z*S] in the reconstruction
    precision (complex128 for f64 storage, complex64 otherwise).
    Reconstruct-12 and -8 rebuild row 2 = phase * conj(row0 x row1), phase
    = t_boundary on t-links at global t = t_global - 1 (t_global defaults
    to T; a shard at global t_offset has it at local t_global - 1 -
    t_offset): the stored rows carry the phase, the bilinear cross product
    squares it away.  Reconstruct-8 first rebuilds rows 0 and 1 from its
    8 reals."""
    rdt = torch.float64 if u.dtype == torch.float64 else torch.float32
    n = lat.site_shape[0] * lat.site_shape[1] * lat.site_shape[2]
    rows = u.shape[2]
    if rows == 4:
        uc = recon8_rows(u.to(rdt).reshape(4, 2, 8, n))
    else:
        uc = torch.complex(u[:, :, :, :, 0].to(rdt), u[:, :, :, :, 1].to(rdt))
        uc = uc.reshape(4, 2, rows, 3, n)
        if rows == 3:
            return uc
    r2 = _rebuild_row2(uc)
    T = lat.Lt
    t_last = (T if t_global is None else t_global) - 1 - t_offset
    if t_boundary != 1 and 0 <= t_last < T:
        r2[3, :, :, t_last * (n // T):(t_last + 1) * (n // T)] *= t_boundary
    return torch.cat([uc, r2[:, :, None]], dim=2)


def _halo_operands(halo: Halo, x: torch.Tensor, links: torch.Tensor, p: int,
                   t_boundary: int):
    """The plain version's halo mode: the spinor faces appended to x
    [4, 3, N] (half-spinor faces padded with zero spins 2, 3, which the
    projection maps to exactly the shipped half-spinor) in hop_index's
    order, and per direction the backward links of parity p with the face
    links at the same indices: ([4, 3, N + F], [4, 3, 3, N + F])."""
    rdt = x.real.dtype

    def cplx(f):
        c = torch.complex(f[0].to(rdt), f[1].to(rdt)).reshape(f.shape[1], 3, -1)
        if c.shape[0] == 2:
            c = torch.cat([c, torch.zeros_like(c)])
        return c

    def face_links(uf, phase):
        if uf.shape[0] == 4:
            uc = recon8_rows(uf.to(rdt).reshape(8, -1))
        else:
            uc = torch.complex(uf[:, :, 0].to(rdt), uf[:, :, 1].to(rdt))
            uc = uc.reshape(uf.shape[0], 3, -1)
        if uc.shape[0] == 2:
            uc = torch.cat([uc, (phase * _rebuild_row2(uc))[None]])
        return uc

    faces = [cplx(f) for f in (halo.t_m, halo.t_p, halo.z_m, halo.z_p)]
    nt, nz = faces[0].shape[-1], faces[2].shape[-1]
    x_ext = torch.cat([x, *faces], dim=-1)
    # the t-1 face sits at global t_offset - 1: the boundary slice when t_offset = 0
    u_t = face_links(halo.u_t, t_boundary if halo.t_offset == 0 else 1)
    u_z = face_links(halo.u_z, 1)

    def pad(*parts):
        return torch.cat([p_ if torch.is_tensor(p_) else
                          torch.zeros((3, 3, p_), dtype=links.dtype, device=links.device)
                          for p_ in parts], dim=-1)

    bwd = torch.stack([pad(links[0, p], 2 * nt + 2 * nz), pad(links[1, p], 2 * nt + 2 * nz),
                       pad(links[2, p], 2 * nt, u_z, nz), pad(links[3, p], u_t, nt + 2 * nz)])
    return x_ext, bwd


def _round_bf16(z: torch.Tensor) -> torch.Tensor:
    """A complex64 tensor with re and im rounded to bfloat16 values."""
    return torch.complex(z.real.bfloat16().float(), z.imag.bfloat16().float())


def dslash_eo_plain(u: torch.Tensor, psi: torch.Tensor, src_parity: int, lat: Lattice,
                    *, dagger: bool = False, epilogue: str = "none", kappa: float = 0.0,
                    mu: float = 0.0, flavor: int = 1, psi0: torch.Tensor | None = None,
                    t_boundary: int = -1, xpay_scale: float | None = None,
                    dirs: tuple | None = None, legs_out: bool = False,
                    out: torch.Tensor | None = None,
                    clover: torch.Tensor | None = None,
                    halo: Halo | None = None, compute: str = "f32") -> torch.Tensor:
    """The same function as the kernel in plain PyTorch, on any device.

    A port of tpuqcd's dslash_eo_dev_ri (spin projection, SU(3) mat-vec,
    reconstruction) with reconstruct-12 and -8, the epilogues, the leg
    modes, halo mode and the batch axis added; the clover epilogues apply
    the blocks with ops/clover.clover_mv.  bfloat16 storage computes in
    float32, reconstruction included.  compute="bf16" (PyTorch has no
    complex bfloat16) runs the same complex64 steps and rounds re and im
    to bfloat16 after each stage the kernel keeps in bfloat16: the
    rebuilt link, the projection, the mat-vec, each leg's accumulation
    and the epilogue's terms.
    """
    mask, _, nb = _check(u, psi, src_parity, lat, epilogue, psi0, dirs, legs_out, out,
                         clover, halo, compute)
    counts["plain"] += 1
    p, q = src_parity, 1 - src_parity
    T, Z, S = lat.site_shape
    rdt = torch.float64 if psi.dtype == torch.float64 else torch.float32
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    dev = psi.device
    rnd = _round_bf16 if compute == "bf16" else (lambda z: z)
    B = psi.shape[0] if nb else 1

    def cplx(f, inner):
        """A (batch of) packed operand -> complex [B, *inner, n]."""
        f = f if nb else f[None]
        return torch.complex(f[:, 0].to(rdt), f[:, 1].to(rdt)).reshape(B, *inner, -1)

    x = cplx(psi, (4, 3))
    if halo is None:
        links = rnd(expand_links(u, lat, t_boundary))
        bwd_links = links[:, p]
    else:
        links = rnd(expand_links(u, lat, t_boundary, halo.t_offset, halo.t_global))
        x0_ext, bwd_links = _halo_operands(halo, x[0], links, p, t_boundary)
        x, bwd_links = x0_ext[None], rnd(bwd_links)
    idx = hop_index(lat, p, dev, halo=halo is not None)
    tabs = [t.to(device=dev, dtype=cdt) for t in
            (HALF_PROJ_MINUS, HALF_RECON_MINUS, HALF_PROJ_PLUS, HALF_RECON_PLUS)]
    hpm, hrm, hpp, hrp = tabs
    if dagger:
        hpm, hrm, hpp, hrp = hpp, hrp, hpm, hrm
    legs = []
    for bit, (m, sign) in enumerate(LEG_ORDER):
        if not mask & (1 << bit):
            continue
        if sign > 0:
            # forward: (1 - g_mu) U_mu(x)|q psi(x + mu)
            h = rnd(torch.einsum("hs,bscn->bhcn", hpm[m], x[..., idx[m, 0]]))
            w = rnd(torch.einsum("ijn,bhjn->bhin", links[m, q], h))
            legs.append(torch.einsum("ah,bhin->bain", hrm[m], w))
        else:
            # backward: (1 + g_mu) U_mu(x - mu)|p^dag psi(x - mu)
            nbr = idx[m, 1]
            h = rnd(torch.einsum("hs,bscn->bhcn", hpp[m], x[..., nbr]))
            w = rnd(torch.einsum("jin,bhjn->bhin", bwd_links[m][:, :, nbr].conj(), h))
            legs.append(torch.einsum("ah,bhin->bain", hrp[m], w))
    if legs_out:
        acc = torch.stack(legs, dim=1)[0]
        res = torch.stack([acc.real, acc.imag], dim=1).reshape(len(legs), 2, 4, 3, T, Z, S)
    else:
        acc = legs[0]
        for leg in legs[1:]:
            acc = rnd(acc + leg)
        tw, k2 = _site_terms(kappa, mu, flavor, xpay_scale)
        g5 = torch.tensor(G5_DIAG, dtype=rdt, device=dev)[:, None, None]
        if epilogue == "twist_inv":
            acc = rnd((1 - 1j * tw * g5) / (1 + tw * tw) * acc)
        elif epilogue == "xpay":
            acc = rnd((1 + 1j * tw * g5) * cplx(psi0, (4, 3)) - rnd(k2 * acc))
        elif epilogue in CLOVER_EPILOGUES:
            # imported here: ops/clover imports gauge_tools, which imports this module
            from .clover import clover_mv
            cl = torch.complex(clover[0].to(rdt), clover[1].to(rdt)).reshape(2, 6, 6, -1)
            if epilogue == "clover_inv":
                acc = rnd(clover_mv(cl, acc))
            else:
                x0 = cplx(psi0, (4, 3))
                a_x0 = rnd(clover_mv(cl, x0))
                acc = rnd(a_x0 + 1j * tw * g5 * x0 - rnd(k2 * acc))
        res = torch.stack([acc.real, acc.imag], dim=1).reshape(B, 2, 4, 3, T, Z, S)
        if not nb:
            res = res[0]
    if out is None:
        return res.to(psi.dtype)
    return out.copy_(res)
