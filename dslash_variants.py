"""The bfloat16 pair kernel's variants, timed on one NVIDIA GPU at
32^3x64 beside the pair kernel as built and the one-site kernel.

    python3 dslash_variants.py

Each variant is the bfloat16 reconstruct-12 translation unit
(tpuqcd_torch/csrc/dslash_eo_inst.cu) built by nvcc from an edited copy
of csrc/dslash_eo.cuh (VARIANTS: text replacements),
linked with an entry of its own for tq_dslash_eo_bf16, and swapped in as
ops/dslash_cuda.library's library; each is held to the one-site kernel
bit for bit (dagger off and on) before it is timed.  Rows: K2 twist_inv
and xpay_full, K3 clover_inv and clover_xpay, whole and in halo mode on
the one-rank mesh and at the (2, 2) shard (half-spinor faces).  Each row
is timed in turns, every tag and then every tag backwards, three times,
100 launches each after 10; the least of the six is printed.  First the
ptxas registers and spills of each variant's pair instantiations
(D dagger, C clover, H halo).
"""
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from tpuqcd_torch.ops import dslash_cuda as dc  # noqa: E402
from tpuqcd_torch.parallel.mesh import LatticeMesh  # noqa: E402
from tpuqcd_torch.parallel.sharded import cut_halo  # noqa: E402

LB = "__global__ void __launch_bounds__(SINGLE_THREADS)"
PAIR_THREADS = ("      const int threads = SINGLE_THREADS;\n"
                "      const unsigned blocks = (unsigned)((n_sites / 2")
LD = "    const __nv_bfloat162 w = *reinterpret_cast<const __nv_bfloat162*>(p);"
LEG_LD = "    ld_sites<NS, RUN_U>(pu, k * u_ss, v);"
ROLL = "finish<NS, CLOVER, NS == 2 && HALO>"
ANCHOR = "// The neighbour spinors of NS sites"
LD_CS = '''template <int NS, bool RUN, typename R, typename S>
__device__ __forceinline__ void ld_sites_cs(const Sites<NS, S>& a, int64_t off, R (&v)[NS]) {
  if constexpr (NS == 2 && RUN) {
    const __nv_bfloat162 w = __ldcs(reinterpret_cast<const __nv_bfloat162*>(a.p[0] + off));
    v[0] = conv<R>(__low2bfloat16(w));
    v[1] = conv<R>(__high2bfloat16(w));
  } else if constexpr (NS == 2) {
    for (int j = 0; j < NS; ++j) v[j] = conv<R>(__ldcs(a.p[j] + off));
  } else {
    ld_sites<NS, RUN>(a, off, v);
  }
}

'''


def pair_threads(n: int) -> list:
    """The edits that launch the pair kernel with n threads a block."""
    return [(LB, f"__global__ void __launch_bounds__(NS == 2 ? {n} : SINGLE_THREADS)"),
            (PAIR_THREADS, PAIR_THREADS.replace("SINGLE_THREADS", str(n)))]


#: name -> header replacements
VARIANTS = {
    "threads 64": pair_threads(64),
    "threads 256": pair_threads(256),
    "min blocks 5": [(LB, "__global__ void __launch_bounds__(SINGLE_THREADS, NS == 2 ? 5 : 1)")],
    "__ldg": [(LD, LD.replace("*reinterpret_cast", "__ldg(reinterpret_cast").replace(";", ");"))],
    "__ldcs links": [(ANCHOR, LD_CS + ANCHOR),
                     (LEG_LD, LEG_LD.replace("ld_sites<", "ld_sites_cs<"))],
    "clover inline": [(ROLL, "finish<NS, CLOVER, false>")],
}
ENTRY = '''#include <cuda_runtime.h>
#include <stdint.h>
#define TQ_NO_KERNELS
#include "dslash_eo.cuh"
extern "C" int tq_dslash_eo_bf16_r2(TQ_PARAMS);
extern "C" int tq_dslash_eo_bf16(TQ_PARAMS) { return tq_dslash_eo_bf16_r2(TQ_ARGS); }
extern "C" const char* tq_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
'''


def nvcc() -> str:
    return str(Path("/usr/local/cuda/bin/nvcc"))


def pair_ptxas(log: str) -> str:
    """The registers (and spills) of the pair instantiations in a ptxas log."""
    name, spill, out = "", "", []
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.split("Function properties for")[-1].strip()
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln:
            m = re.search(r"kernelILi2E13__nv_bfloat16fLi2ELb(\d)ELb0ELb(\d)ELb(\d)E", name)
            if m:
                flags = "".join(c if b == "1" else "-" for c, b in zip("DCH", m.groups()))
                regs = ln.split("Used")[1].split("registers")[0].strip()
                out.append(f"{flags} {regs}" + ("" if " 0 bytes spill stores" in spill
                                               else f" ({spill})"))
    return ", ".join(out)


def build(work: Path) -> dict:
    """Every variant's library, built side by side; {name: ctypes.CDLL}."""
    csrc = dc.CSRC
    header = (csrc / "dslash_eo.cuh").read_text()
    (work / "entry.cu").write_text(ENTRY)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = header
        for old, new in edits:
            if old not in text:
                sys.exit(f"variant {name!r}: {old!r} is not in the header")
            text = text.replace(old, new)
        d = work / f"v{i}"
        d.mkdir()
        # beside its own copy of the unit, whose #include "dslash_eo.cuh" would
        # otherwise find csrc/'s header first
        (d / "dslash_eo.cuh").write_text(text)
        (d / "dslash_eo_inst.cu").write_text((csrc / "dslash_eo_inst.cu").read_text())
        procs[name] = (d, subprocess.Popen(
            [nvcc(), *dc.NVCC_FLAGS, "-DTQ_STORAGE=__nv_bfloat16", "-DTQ_COMPUTE=float",
             "-DTQ_NROW=2", "-DTQ_NAME=tq_dslash_eo_bf16_r2", "-I", str(d), "-c", "-o",
             str(d / "unit.o"), str(d / "dslash_eo_inst.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    subprocess.run([nvcc(), *dc.NVCC_FLAGS, "-I", str(csrc), "-c", "-o", str(work / "entry.o"),
                    str(work / "entry.cu")], check=True, capture_output=True)
    libs = {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"variant {name!r} does not build:\n{log[-3000:]}")
        subprocess.run([nvcc(), "-shared", "-o", str(d / "lib.so"), str(d / "unit.o"),
                        str(work / "entry.o")], check=True, capture_output=True)
        lib = ctypes.CDLL(str(d / "lib.so"))
        fn = lib.tq_dslash_eo_bf16
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_double] * 2
                       + [ctypes.c_int] * 3 + [ctypes.c_int64] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.tq_error_string.argtypes = [ctypes.c_int]
        lib.tq_error_string.restype = ctypes.c_char_p
        libs[name] = lib
        print(f"  {name}: {pair_ptxas(log)}", flush=True)
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("dslash_variants.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi, _ = cs.card()
    dc.library.get()
    built = dc.library._lib
    print("ptxas, pair instantiations: as built: "
          + (pair_ptxas(dc.library.build_log) or "loaded from tpuqcd_torch/_build, built earlier "
             "(chip_smoke.py phase 2 prints its ptxas lines)"))
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"as built": built, **build(Path(tmp))}
        lat, g, psi64, psi064 = cs.problem(cs.LARGE, dev, seed=2)
        blocks = cs.clover_operands(g["f64"], lat)
        u, psi, psi0 = g["bf16"], psi64.bfloat16(), psi064.bfloat16()
        rows = {}
        for mode, epi, scale in (cs.MODES[1], cs.MODES[3], *cs.CLOVER_MODES[:2]):
            kw = cs._hop_kw(epi, scale, 0, torch.bfloat16, psi0, blocks)
            rows[mode] = (u, psi, lat, kw, None)
            for grid in ((1, 1, 1), (2, 2, 1)):
                m = LatticeMesh(lat, *grid, 0)
                ul, pl, halo = cut_halo(m, u, psi, 0)
                rows[f"halo {mode} {grid[:2]}"] = (ul, pl, m.local_lat, cs._local(m, kw), halo)
        for name, lib in libs.items():
            for uu, pp, ll, kw, halo in rows.values():
                for dagger in (False, True):
                    dc.library._lib = lib
                    a = dc.dslash_eo(uu, pp, 0, ll, halo=halo, dagger=dagger, **kw)
                    b = dc.dslash_eo_one_site(uu, pp, 0, ll, halo=halo, dagger=dagger, **kw)
                    torch.cuda.synchronize()
                    if not torch.equal(a, b):
                        sys.exit(f"variant {name!r} differs from the one-site kernel")
        tags = ["one-site", *libs]
        ms = {}
        for row, (uu, pp, ll, kw, halo) in rows.items():
            for _ in range(3):
                for tag in tags + tags[::-1]:
                    dc.library._lib = built if tag == "one-site" else libs[tag]
                    fn = dc.dslash_eo_one_site if tag == "one-site" else dc.dslash_eo
                    ms.setdefault((row, tag), []).append(cs.time_ms(
                        lambda: fn(uu, pp, 0, ll, halo=halo, **kw), reps=100, warmup=10))
        dc.library._lib = built
    print(f"ms a launch, the least of 6 turns of 100 launches | {smi}")
    print(f"  {'row':26s} " + " ".join(f"{t:>13s}" for t in tags))
    for row in rows:
        print(f"  {row:26s} " + " ".join(f"{min(ms[(row, t)]):13.4f}" for t in tags))


if __name__ == "__main__":
    main()
