"""Units of kind "solve": traffic {"unit": "solve", "columns": n,
"rhs_batch": r, "flavor": f}.  A unit solves the n point-source columns of
its spec (r of them in lockstep) through the port's
Solver.packed_src_batch, made by cli/common.make_solver; the MG hierarchy
of the flavor is built in set-up.  The record keeps the float32 solutions
the call returned and the audit (each solver call's sources and float64
solutions) for the judge."""
from __future__ import annotations

from ..reference.judge import judge_solve as judge  # noqa: F401
from ..sources import point_columns
from ._common import Audit, columns_summary, loose, run_config, sync


class Driver:
    def __init__(self, config: dict, traffic: dict, gauge_file: str, device, detail: dict):
        from tpuqcd_torch.cli.common import make_solver, setup_gauge
        self.cfg = run_config(config, gauge_file, traffic)
        self.dims = tuple(config["gauge"]["dims"])
        self.device, self.flavor = device, int(traffic.get("flavor", 1))
        self.gauge = setup_gauge(self.cfg, device)
        detail["gauge_read_s"] = self.gauge.seconds
        self.solver = make_solver(self.cfg, self.gauge.lat, self.gauge.u_pk)
        self.audit = Audit()
        self.solver.audit = self.audit
        if self.solver.mg is not None:
            self.solver.mg.setup(self.flavor)
            detail["mg_setup"] = dict(self.solver.mg.hierarchies[self.flavor].setup_seconds)
        # warm-up: the window's call on its column count, at a loose tolerance
        n = int(traffic["columns"])
        warm = point_columns(self.dims, (0, 0, 0, 0), list(range(n)), device)
        holder = self.solver.mg if self.solver.mg is not None else self.solver
        holder.cfg = loose(self.cfg)
        try:
            self.solver.packed_src_batch(warm, flavor=self.flavor)
        finally:
            holder.cfg = self.cfg
        sync(device)
        self.solver.records.clear()
        self.audit.take()

    def program(self) -> dict:
        mg = self.solver.mg
        if mg is None or self.flavor not in mg.hierarchies:
            return {}
        return {"mg_setup_seconds": dict(mg.hierarchies[self.flavor].setup_seconds)}

    def run(self, spec: dict) -> dict:
        b = point_columns(self.dims, spec["position"], spec["columns"], self.device)
        n0 = len(self.solver.records)
        x = self.solver.packed_src_batch(b, flavor=self.flavor)
        sync(self.device)
        recs = self.solver.records[n0:]
        return {"records": [{k: v for k, v in r.items() if k != "x_first"} for r in recs],
                "returned": x, "audit": self.audit.take()}

    def close(self):
        self.solver = self.gauge = None


def summary(rec: dict, spec: dict, tol: float) -> dict:
    return columns_summary(rec, len(spec["columns"]), tol)
