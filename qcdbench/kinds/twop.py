"""Units of kind "twop": traffic {"unit": "twop"}.  A unit is the port's
cli/run_twop.measure on the spec's source position: 24 solves (12 columns,
both flavors), smeared sources and sinks, the correlators projected to
momenta.  The record keeps the stages' seconds, the correlators and the
audit (each solver call's sources and float64 solutions) for the judge."""
from __future__ import annotations

import dataclasses

from ..reference.judge import judge_twop as judge  # noqa: F401
from ._common import Audit, columns_summary, loose, run_config, sync


class Driver:
    def __init__(self, config: dict, traffic: dict, gauge_file: str, device, detail: dict):
        from tpuqcd_torch.cli.common import setup_gauge
        from tpuqcd_torch.cli.run_twop import measure
        self.measure = measure
        self.cfg = run_config(config, gauge_file, traffic)
        self.device = device
        self.gauge = setup_gauge(self.cfg, device)
        detail["gauge_read_s"] = self.gauge.seconds
        self.audit = Audit()
        warm = loose(self.cfg)
        warm = dataclasses.replace(warm, physics=dataclasses.replace(
            warm.physics, smear_n_gauss=min(1, warm.physics.smear_n_gauss),
            smear_n_ape=min(1, warm.physics.smear_n_ape), source_positions=((0, 0, 0, 0),)))
        self.measure(warm, device, gauge=self.gauge, audit=self.audit)
        sync(device)
        self.audit.take()

    def program(self) -> dict:
        return {}

    def run(self, spec: dict) -> dict:
        cfg = dataclasses.replace(self.cfg, physics=dataclasses.replace(
            self.cfg.physics, source_positions=(tuple(spec["position"]),)))
        res = self.measure(cfg, self.device, gauge=self.gauge, audit=self.audit)
        sync(self.device)
        return {"records": [{k: v for k, v in r.items() if k != "x_first"} for r in res.solves],
                "stages": {k: v for k, v in res.seconds.items() if k != "gauge"},
                "correlators": res.correlators, "momenta": res.momenta.tolist(),
                "audit": self.audit.take()}

    def close(self):
        self.gauge = None


def summary(rec: dict, spec: dict, tol: float) -> dict:
    """Both flavors' propagators: 24 columns."""
    return {**columns_summary(rec, 2 * len(spec["columns"]), tol), "stages": rec["stages"]}
