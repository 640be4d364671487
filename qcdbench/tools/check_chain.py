"""Check that the frozen heatbath (qcdbench/inputs/heatbath.py) reproduces
the port's chain (tpuqcd_torch/ops/heatbath.thermalize) bit for bit on the
card: the port's chain from the same seed against the links of the gauge
file the benchmark made (ILDG, float64 of the complex64 chain).  A check
tool, not part of a benchmark run (it imports the port's heatbath).

    python3 -m qcdbench.tools.check_chain [config name]
"""
from __future__ import annotations

import json
import sys
import time

import torch

from qcdbench import registry
from qcdbench.inputs import gauge as gauge_input
from qcdbench.inputs.heatbath import gauge_device_to_full
from qcdbench.inputs.lime import read_gauge_f64


def main(name: str = "tm_mg_nearcrit_32c64") -> int:
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.ops.heatbath import thermalize
    cfg = registry.config(registry.load_benchmark(), name)
    g = cfg["gauge"]
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    path, made = gauge_input.ensure(g, dev)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(int(g["seed"]))
    u = thermalize(gen, Lattice(tuple(g["dims"])), g["beta"], g["sweeps"], n_or=g["n_or"],
                   reunit_every=g["reunit_every"])
    port = gauge_device_to_full(u, tuple(g["dims"]))
    seconds = time.perf_counter() - t0
    frozen, _ = read_gauge_f64(str(path), dev)
    same = torch.equal(port, frozen.to(torch.complex64))
    diff = (port.to(torch.complex128) - frozen).abs().max().item()
    print(json.dumps({"config": name, "file": str(path), "made_now": made,
                      "port_chain_s": seconds, "bit_for_bit": same, "max_abs_diff": diff,
                      "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
