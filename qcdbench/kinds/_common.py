"""What the kinds' drivers share: the port's RunConfig of a configuration,
the audit hook, a loose-tolerance copy for warm-ups."""
from __future__ import annotations

import dataclasses

import torch


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Audit:
    """Solver.audit: every solver call's (sources, float64 solutions, flavor)."""

    def __init__(self):
        self.calls = []

    def __call__(self, b_pks, x, flavor):
        self.calls.append((b_pks, x, int(flavor)))

    def take(self):
        out, self.calls = self.calls, []
        return out


def run_config(config: dict, gauge_file: str, traffic: dict | None = None):
    """The port's RunConfig: the configuration's "run" group, the gauge file,
    and the traffic's rhs_batch where it gives one."""
    from tpuqcd_torch.utils.config import config_from_dict
    raw = {k: dict(v) for k, v in config["run"].items()}
    if traffic and "rhs_batch" in traffic:
        raw["solver"]["rhs_batch"] = int(traffic["rhs_batch"])
    g = config["gauge"]
    raw["gauge"] = {"dims": list(g["dims"]), "config_file": gauge_file,
                    "antiperiodic_t": bool(g["antiperiodic_t"])}
    return config_from_dict(raw)


def loose(cfg):
    """cfg at a tolerance of 0.5: a warm-up that runs every shape once."""
    return dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, tol=0.5,
                                                               inner_tol=0.5))


def columns_summary(rec: dict, n: int, tol: float) -> dict:
    """The program's own report of a unit that has to certify n columns."""
    cols = [(r, it) for x in rec["records"] for r, it in zip(x["relres"], x["iters"])]
    certified = sum(r <= tol for r, _ in cols)
    return {"columns": n, "solved": len(cols), "certified": certified,
            "ok": len(cols) == n and certified == n, "iters": [it for _, it in cols],
            "relres_max": max((r for r, _ in cols), default=None)}
