"""Even-odd Wilson hop with fused twisted-mass and clover epilogues: the
CUDA kernel, its plain PyTorch version, and the dispatch between them.

Counterpart of ``tpuqcd/ops/dslash_pallas.py::dslash_eo_pallas`` (the
TPU kernel) and ``tpuqcd/ops/dslash_xla.py::dslash_eo_dev_ri`` (whose f64
role, the certification operator, the double instantiation takes over).
The kernel source is ``csrc/dslash_eo.cu``; it is compiled with nvcc for
sm_90a at first use into ``tpuqcd_torch/_build/`` (rebuilt when the
source changes) and loaded with ctypes.

Dispatch has no fallback: a CUDA tensor launches the kernel or raises,
a CPU tensor runs ``dslash_eo_plain``.

    out = dslash_eo(u, psi, src_parity, lat)            # D_{q<-p} psi
    out = dslash_eo(u, psi, 0, lat, epilogue="twist_inv", kappa=k, mu=m)
    out = dslash_eo(u, t1, 1, lat, epilogue="xpay", kappa=k, mu=m, psi0=psi)

Fields: psi, psi0 and the result [2(ri), 4, 3, T, Z, S]; u
[4, 2, 3, 3, 2, T, Z, S] or reconstruct-12 [4, 2, 2, 3, 2, T, Z, S], of
the same dtype as psi (float32, bfloat16 or float64; bfloat16 is storage
only, the arithmetic is float32).  Epilogues, with tw = 2 kappa mu flavor:

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

Spinor operands may be views whose re/im planes are any stride apart
(the parity halves of an MG field [2(ri), 2(par), 4, 3, T, Z, S]); each
plane itself must be contiguous.  ``out=`` writes the result into such a
view instead of a new tensor.
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

import torch

from ..gammas import (G5_DIAG, HALF_PROJ_MINUS, HALF_PROJ_PLUS,
                      HALF_RECON_MINUS, HALF_RECON_PLUS)
from ..lattice import Lattice

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR / "csrc" / "dslash_eo.cu"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

EPILOGUES = {"none": 0, "twist_inv": 1, "xpay": 2, "clover_inv": 3, "clover_xpay": 4}
CLOVER_EPILOGUES = ("clover_inv", "clover_xpay")
#: the kernel's textual leg order: slot order of legs_out, bit order of
#: the leg mask (bit 2*mu + (sign < 0))
LEG_ORDER = tuple((mu, s) for mu in range(4) for s in (+1, -1))
_ENTRY = {torch.float32: "tq_dslash_eo_f32", torch.bfloat16: "tq_dslash_eo_bf16",
          torch.float64: "tq_dslash_eo_f64"}

#: launches of the kernel, by storage dtype name ("float32"), with the
#: leg modes and the clover epilogues apart ("float32:dirs",
#: "float32:legs_out", "float32:clover_inv", "float32:clover_xpay"), and
#: calls of the plain version under "plain".  Each kernel launch adds one;
#: nothing else does.
counts: collections.Counter = collections.Counter()


def reset_counts() -> None:
    counts.clear()


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
        src = SOURCE.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        path = BUILD_DIR / f"dslash_eo-{tag}.so"
        if not path.exists():
            self._build(path)
        lib = ctypes.CDLL(str(path))
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                           + [ctypes.c_double] * 2 + [ctypes.c_int] * 3
                           + [ctypes.c_int64] * 4 + [ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.tq_error_string.argtypes = [ctypes.c_int]
        lib.tq_error_string.restype = ctypes.c_char_p
        self.path = path
        return lib

    def _build(self, path: Path) -> None:
        nvcc = shutil.which("nvcc")
        if nvcc is None:
            cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
            nvcc = str(cand) if cand.exists() else None
        if nvcc is None:
            raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): cannot "
                               f"build {SOURCE.name}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{self.build_log}")
        os.replace(tmp, path)


library = _Library()


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


def _check(u, psi, src_parity, lat, epilogue, psi0, dirs=None, legs_out=False, out=None,
           clover=None):
    """Validate the operands; returns (leg mask, output shape)."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {sorted(EPILOGUES)}, got {epilogue!r}")
    if legs_out and epilogue != "none":
        raise ValueError("legs_out composes with epilogue='none' only")
    mask = _leg_mask(dirs)
    if src_parity not in (0, 1):
        raise ValueError(f"src_parity must be 0 or 1, got {src_parity!r}")
    if psi.dtype not in _ENTRY:
        raise ValueError(f"psi dtype {psi.dtype} is not float32, bfloat16 or float64")
    sites = lat.site_shape
    if tuple(psi.shape) != (2, 4, 3, *sites):
        raise ValueError(f"psi shape {tuple(psi.shape)} != {(2, 4, 3, *sites)}")
    if u.dtype != psi.dtype:
        raise ValueError(f"gauge dtype {u.dtype} != spinor dtype {psi.dtype}")
    if u.ndim != 8 or tuple(u.shape[:2]) != (4, 2) or u.shape[2] not in (2, 3) \
            or tuple(u.shape[3:]) != (3, 2, *sites):
        raise ValueError(f"gauge shape {tuple(u.shape)} is neither "
                         f"{(4, 2, 3, 3, 2, *sites)} nor {(4, 2, 2, 3, 2, *sites)}")
    if not u.is_contiguous():
        raise ValueError("u is not contiguous (a u[:, :, :2] view must be copied: "
                         "utils.packed.pack_gauge12)")
    _ri_stride(psi, "psi")
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
        _ri_stride(psi0, "psi0")
        tensors.append(("psi0", psi0))
    n_legs = bin(mask).count("1")
    shape = (n_legs, *psi.shape) if legs_out else tuple(psi.shape)
    if out is not None:
        if tuple(out.shape) != shape or out.dtype != psi.dtype:
            raise ValueError(f"out must be {psi.dtype} {shape}, got {out.dtype} "
                             f"{tuple(out.shape)}")
        _ri_stride(out, "out", lead=1 if legs_out else 0)
        tensors.append(("out", out))
    for name, x in tensors + [("u", u)]:
        if x.device != psi.device:
            raise ValueError(f"{name} is on {x.device}, psi on {psi.device}")
    return mask, shape


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
              clover: torch.Tensor | None = None) -> torch.Tensor:
    """D_{q<-p} psi with a fused epilogue; result at parity 1 - src_parity.

    t_boundary is the fermion T-boundary phase folded into the stored
    links (-1 antiperiodic, +1 periodic); only reconstruct-12 reads it.
    dirs, legs_out, out and clover: see the module docstring.
    """
    kw = dict(dagger=dagger, epilogue=epilogue, kappa=kappa, mu=mu, flavor=flavor,
              psi0=psi0, t_boundary=t_boundary, xpay_scale=xpay_scale, dirs=dirs,
              legs_out=legs_out, out=out, clover=clover)
    mask, shape = _check(u, psi, src_parity, lat, epilogue, psi0, dirs, legs_out, out, clover)
    if psi.device.type == "cpu":
        return dslash_eo_plain(u, psi, src_parity, lat, **kw)
    if psi.device.type != "cuda":
        raise ValueError(f"no Dslash for device {psi.device}")
    tw, k2 = _site_terms(kappa, mu, flavor, xpay_scale)
    fn = getattr(library.get(), _ENTRY[psi.dtype])
    if out is None:
        out = torch.empty(shape, dtype=psi.dtype, device=psi.device)
    lead = 1 if legs_out else 0
    T, Z, _ = lat.site_shape
    stream = torch.cuda.current_stream(psi.device).cuda_stream
    err = fn(u.data_ptr(), psi.data_ptr(), psi0.data_ptr() if psi0 is not None else None,
             clover.data_ptr() if clover is not None else None, out.data_ptr(), T, Z,
             lat.Ly, lat.Lx // 2, u.shape[2], src_parity, int(dagger), EPILOGUES[epilogue],
             tw, k2, int(t_boundary), mask, int(legs_out), psi.stride(0),
             psi0.stride(0) if psi0 is not None else 0, out.stride(lead),
             out.stride(0) if legs_out else 0, psi.device.index, stream)
    if err != 0:
        msg = library.get().tq_error_string(err).decode()
        raise RuntimeError(f"dslash_eo kernel launch failed: {msg} (CUDA error {err})")
    key = str(psi.dtype).removeprefix("torch.")
    if legs_out:
        key += ":legs_out"
    elif dirs is not None:
        key += ":dirs"
    elif clover is not None:
        key += ":" + epilogue
    counts[key] += 1
    return out


# --------------------------------------------------------------------------
# plain PyTorch version

def hop_index(lat: Lattice, src_parity: int, device=None) -> torch.Tensor:
    """int64 [4(mu), 2(fwd, bwd), T*Z*S]: flat site index of the +mu and
    -mu neighbour of every output site, with periodic wrap and the eo
    x-shift rule (the same index math as the kernel)."""
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
    return torch.stack([torch.stack(pair) for pair in legs])


def expand_links(u: torch.Tensor, lat: Lattice, t_boundary: int = -1) -> torch.Tensor:
    """Packed gauge -> complex [4, 2, 3, 3, T*Z*S] in the compute precision
    (complex128 for f64 storage, complex64 otherwise).  Reconstruct-12
    rebuilds row 2 = phase * conj(row0 x row1), phase = t_boundary on
    t-links at t = T-1: the stored rows carry the phase, the bilinear
    cross product squares it away."""
    rdt = torch.float64 if u.dtype == torch.float64 else torch.float32
    n = lat.site_shape[0] * lat.site_shape[1] * lat.site_shape[2]
    uc = torch.complex(u[:, :, :, :, 0].to(rdt), u[:, :, :, :, 1].to(rdt))
    uc = uc.reshape(4, 2, u.shape[2], 3, n)
    if u.shape[2] == 3:
        return uc
    r2 = torch.conj(torch.linalg.cross(uc[:, :, 0], uc[:, :, 1], dim=2))
    if t_boundary != 1:
        T = lat.Lt
        r2[3, :, :, (T - 1) * (n // T):] *= t_boundary
    return torch.cat([uc, r2[:, :, None]], dim=2)


def dslash_eo_plain(u: torch.Tensor, psi: torch.Tensor, src_parity: int, lat: Lattice,
                    *, dagger: bool = False, epilogue: str = "none", kappa: float = 0.0,
                    mu: float = 0.0, flavor: int = 1, psi0: torch.Tensor | None = None,
                    t_boundary: int = -1, xpay_scale: float | None = None,
                    dirs: tuple | None = None, legs_out: bool = False,
                    out: torch.Tensor | None = None,
                    clover: torch.Tensor | None = None) -> torch.Tensor:
    """The same function as the kernel in plain PyTorch, on any device.

    A port of tpuqcd's dslash_eo_dev_ri (spin projection, SU(3) mat-vec,
    reconstruction) with reconstruct-12, the epilogues and the leg modes
    added; the clover epilogues apply the blocks with ops/clover.clover_mv.
    bfloat16 storage computes in float32, reconstruction included.
    """
    mask, _ = _check(u, psi, src_parity, lat, epilogue, psi0, dirs, legs_out, out, clover)
    counts["plain"] += 1
    p, q = src_parity, 1 - src_parity
    T, Z, S = lat.site_shape
    rdt = torch.float64 if psi.dtype == torch.float64 else torch.float32
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    dev = psi.device
    x = torch.complex(psi[0].to(rdt), psi[1].to(rdt)).reshape(4, 3, -1)
    links = expand_links(u, lat, t_boundary)
    idx = hop_index(lat, p, dev)
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
            h = torch.einsum("hs,scn->hcn", hpm[m], x[:, :, idx[m, 0]])
            w = torch.einsum("ijn,hjn->hin", links[m, q], h)
            legs.append(torch.einsum("bh,hin->bin", hrm[m], w))
        else:
            # backward: (1 + g_mu) U_mu(x - mu)|p^dag psi(x - mu)
            nb = idx[m, 1]
            h = torch.einsum("hs,scn->hcn", hpp[m], x[:, :, nb])
            w = torch.einsum("jin,hjn->hin", links[m, p][:, :, nb].conj(), h)
            legs.append(torch.einsum("bh,hin->bin", hrp[m], w))
    if legs_out:
        acc = torch.stack(legs)
        res = torch.stack([acc.real, acc.imag], dim=1).reshape(len(legs), 2, 4, 3, T, Z, S)
    else:
        acc = sum(legs[1:], legs[0])
        tw, k2 = _site_terms(kappa, mu, flavor, xpay_scale)
        g5 = torch.tensor(G5_DIAG, dtype=rdt, device=dev)[:, None, None]
        if epilogue == "twist_inv":
            acc = (1 - 1j * tw * g5) / (1 + tw * tw) * acc
        elif epilogue == "xpay":
            x0 = torch.complex(psi0[0].to(rdt), psi0[1].to(rdt)).reshape(4, 3, -1)
            acc = (1 + 1j * tw * g5) * x0 - k2 * acc
        elif epilogue in CLOVER_EPILOGUES:
            # imported here: ops/clover imports gauge_tools, which imports this module
            from .clover import clover_mv
            cl = torch.complex(clover[0].to(rdt), clover[1].to(rdt)).reshape(2, 6, 6, -1)
            if epilogue == "clover_inv":
                acc = clover_mv(cl, acc)
            else:
                x0 = torch.complex(psi0[0].to(rdt), psi0[1].to(rdt)).reshape(4, 3, -1)
                acc = clover_mv(cl, x0) + 1j * tw * g5 * x0 - k2 * acc
        res = torch.stack([acc.real, acc.imag]).reshape(2, 4, 3, T, Z, S)
    if out is None:
        return res.to(psi.dtype)
    return out.copy_(res)
