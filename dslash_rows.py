"""Per-launch times of the Dslash kernel at 32^3x64 on one NVIDIA GPU, for
timing two trees of the port in turns in one run (parent, change, change,
parent): the single-launch rows of the main paths and the batched rows,
through ``dslash_eo`` alone, whose interface both trees share.

    cd <tree> && python3 <path>/dslash_rows.py TAG

imports ``chip_smoke`` (its problem(), time_ms() and card()) and
``tpuqcd_torch`` from the current directory, and prints one JSON line:
{"tree": TAG, "card": nvidia-smi's name and power limit, "ms": {row: ms}}.
CUDA events over 50 launches (20 for a batch) after 3 to warm up.
"""
import json
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from tpuqcd_torch.ops.dslash_cuda import dslash_eo, library  # noqa: E402


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
        "bf16 xpay_full": single("bf16", torch.bfloat16, **full),
        "f64 xpay_full": single("f64", torch.float64, **full),
        "f32 clover_xpay": single("f32", torch.float32, epilogue="clover_xpay"),
        "f32 xpay N=11": batch("f32", torch.float32, 11, epilogue="xpay"),
        "f32 twist_inv N=11": batch("f32", torch.float32, 11, epilogue="twist_inv"),
        "f32 xpay N=4": batch("f32", torch.float32, 4, epilogue="xpay"),
        "bf16 xpay_full N=4": batch("bf16", torch.bfloat16, 4, **full),
        "f64 xpay_full N=4": batch("f64", torch.float64, 4, **full),
    }
    ms = {name: cs.time_ms(fn, reps=20 if "N=" in name else 50, warmup=3)
          for name, fn in rows.items()}
    smi, _ = cs.card()
    print(json.dumps({"tree": sys.argv[1] if len(sys.argv) > 1 else "", "card": smi,
                      "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
