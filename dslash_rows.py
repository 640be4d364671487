"""Per-launch times of the Dslash kernel at 32^3x64 on one NVIDIA GPU, for
timing two trees of the port in turns in one run (parent, change, change,
parent): the single-launch rows of the main paths (K1-K3), halo mode (K6)
with the sharded operators' epilogues on the one-rank mesh and at the
(2, 2) shard (32^2x16x32) and one dirs leg in halo mode, and the batched
rows, through ``dslash_eo`` and ``parallel/sharded.cut_halo`` alone, whose
interfaces both trees share.

    cd <tree> && python3 <path>/dslash_rows.py TAG
    python3 dslash_rows.py --against <parent tree> [rounds]

The first imports ``chip_smoke`` (its problem(), time_ms() and card())
and ``tpuqcd_torch`` from the current directory, and prints one JSON line:
{"tree": TAG, "card": nvidia-smi's name and power limit, "ms": {row: ms}}.
The second runs the first in the parent tree and in the current one in
turns (parent, change, change, parent, the given number of rounds, 1 by
default; each its own process) and prints the lines and a table of them.
CUDA events over 50 launches (20 for a batch), the least of 3 such
windows after 10 launches to warm up.
"""
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from tpuqcd_torch.ops.dslash_cuda import dslash_eo, library  # noqa: E402
from tpuqcd_torch.parallel.mesh import LatticeMesh  # noqa: E402
from tpuqcd_torch.parallel.sharded import cut_halo  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("dslash_rows.py needs a CUDA device")
    library.get()
    dev = torch.device("cuda", 0)
    lat, g, psi64, psi064 = cs.problem(cs.LARGE, dev, seed=2)
    gen = torch.Generator().manual_seed(4)
    cl = torch.randn((2, 2, 6, 6, *lat.site_shape), generator=gen).to(dev) * 0.1
    k = dict(kappa=cs.KAPPA, mu=cs.MU)

    def single(name, dt, **kw):
        u, psi = g[name], psi64.to(dt)
        if kw.get("epilogue", "none").endswith("xpay"):
            kw["psi0"] = psi064.to(dt)
        if kw.get("epilogue", "none").startswith("clover"):
            kw["clover"] = cl.to(dt).contiguous()
        return lambda: dslash_eo(u, psi, 0, lat, **k, **kw)

    def halo(name, dt, grid, **kw):
        """The hop of the shard of rank 0 on a (t, z) grid, half-spinor faces."""
        u, psi = g[name], psi64.to(dt)
        m = LatticeMesh(lat, *grid, 1, 0)
        if kw.get("epilogue", "none").endswith("xpay"):
            kw["psi0"] = m.shard(psi064.to(dt)).contiguous()
        if kw.get("epilogue", "none").startswith("clover"):
            kw["clover"] = m.shard(cl.to(dt)).contiguous()
        ul, pl, hl = cut_halo(m, u, psi, 0)
        return lambda: dslash_eo(ul, pl, 0, m.local_lat, halo=hl, **k, **kw)

    def batch(name, dt, n, **kw):
        u = g[name]
        shape = (n, 2, 4, 3, *lat.site_shape)
        psi = torch.randn(shape, generator=gen).to(dev).to(dt)
        if kw.get("epilogue") == "xpay":
            kw["psi0"] = torch.randn(shape, generator=gen).to(dev).to(dt)
        return lambda: dslash_eo(u, psi, 0, lat, **k, **kw)

    full = dict(epilogue="xpay", xpay_scale=cs.KAPPA)
    rows = {
        "f32 none": single("f32", torch.float32),
        "f32 twist_inv": single("f32", torch.float32, epilogue="twist_inv"),
        "f32 xpay": single("f32", torch.float32, epilogue="xpay"),
        "f32 xpay_full": single("f32", torch.float32, **full),
        "bf16 twist_inv": single("bf16", torch.bfloat16, epilogue="twist_inv"),
        "bf16 xpay_full": single("bf16", torch.bfloat16, **full),
        "f64 xpay_full": single("f64", torch.float64, **full),
        "f32 clover_xpay": single("f32", torch.float32, epilogue="clover_xpay"),
        "bf16 clover_inv": single("bf16", torch.bfloat16, epilogue="clover_inv"),
        "bf16 clover_xpay": single("bf16", torch.bfloat16, epilogue="clover_xpay"),
    }
    for grid, tag in (((1, 1), "one-rank"), ((2, 2), "2x2")):
        for epi in ("twist_inv", "xpay", "clover_inv", "clover_xpay"):
            rows[f"bf16 halo {epi} {tag}"] = halo("bf16", torch.bfloat16, grid, epilogue=epi)
        rows[f"f32 halo xpay {tag}"] = halo("f32", torch.float32, grid, epilogue="xpay")
        rows[f"f64 halo xpay {tag}"] = halo("f64", torch.float64, grid, epilogue="xpay")
    rows["f32 halo dirs (t, +1) one-rank"] = halo("f32", torch.float32, (1, 1), dirs=((3, +1),))
    rows.update({
        "f32 xpay N=11": batch("f32", torch.float32, 11, epilogue="xpay"),
        "f32 twist_inv N=11": batch("f32", torch.float32, 11, epilogue="twist_inv"),
        "f32 xpay N=4": batch("f32", torch.float32, 4, epilogue="xpay"),
        "bf16 xpay_full N=4": batch("bf16", torch.bfloat16, 4, **full),
        "f64 xpay_full N=4": batch("f64", torch.float64, 4, **full),
    })
    ms = {name: min(cs.time_ms(fn, reps=20 if "N=" in name else 50, warmup=10 if i == 0 else 2)
                    for i in range(3))
          for name, fn in rows.items()}
    smi, _ = cs.card()
    print(json.dumps({"tree": sys.argv[1] if len(sys.argv) > 1 else "", "card": smi,
                      "ms": ms}), flush=True)


def against(parent: str, rounds: int) -> None:
    script = str(Path(__file__).resolve())
    lines = []
    for tag, tree in (("parent", parent), ("change", "."), ("change", "."),
                      ("parent", parent)) * rounds:
        run = subprocess.run([sys.executable, script, tag], cwd=tree, capture_output=True,
                             text=True)
        if run.returncode != 0:
            sys.exit(f"dslash_rows.py in {tree} failed:\n{run.stdout[-2000:]}{run.stderr[-4000:]}")
        lines.append(json.loads(run.stdout.strip().splitlines()[-1]))
    for line in lines:
        print(json.dumps(line))
    print(f"ms a launch, {lines[0]['card']}: " + " | ".join(x["tree"] for x in lines))
    for row in lines[0]["ms"]:
        print(f"  {row:34s} " + " ".join(f"{x['ms'][row]:8.4f}" for x in lines))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--against"]:
        against(sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3 else 1)
    else:
        main()
