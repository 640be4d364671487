"""The comparison that decides ``correct``: every column the window's
program solved, and in the two-point cell its smeared sources and its
correlators, against the plain float64 reference.  Each unit kind's module
(qcdbench/kinds/) names its judge here.

Numbers compared (each against the configuration's "limits"):

    relres      the largest certified residual over the columns: the
                two-parity |b - M x| / |b| for MG ("residual": "full"),
                the even-odd Schur system's for CG ("schur"), as each
                solver certifies it; the configuration's tolerance
    odd_res     (schur only) the largest |r_o| / |b|, the odd sites the
                Schur residual does not see
    columns_off (solve units) how many of the spec's columns the program
                did not solve as asked: each audited column, in order, has
                to be the reference's own point source of the spec's
                column at the spec's position, of the traffic's flavor,
                and the audited columns as many as the spec's; a column
                left out, added, reordered or another source counts one
    x_gap       (solve units) max |x - x_audit| over the solutions the
                window's call returned against the certified float64 ones
                rounded to float32, as the program rounds them (exact: 0)
    source_gap  the program's smeared sources against the reference's:
                max |b - b_ref| / max |b_ref| over the columns
    corr_gap    every correlator group and momentum: max_t |C - C_ref| /
                max_t |C_ref|, the reference contracting the program's
                solutions (rounded to float32, as the program rounds them)

``control=True`` puts the reference in the program's place one precision
below the configuration's: the solutions carried in float32 (the
configuration certifies float64), and the sources, sink smearing and
contractions rounded to bfloat16 at every stage (the program runs them in
float32).  A sound limit fails the control.
"""
from __future__ import annotations

import torch

from ..inputs.lime import read_gauge_f64
from . import operator as op
from . import twop as tw
from .fields import packed_to_full, parity


def _links(gauge_file: str, device, antiperiodic_t: bool):
    u, dims = read_gauge_f64(gauge_file, device)
    return u, op.phased(u, antiperiodic_t), dims


def _residual_numbers(u_ph, dims, calls, action, kind: str, control: bool) -> dict:
    even = parity(dims, u_ph.device) == 0
    worst = {"relres": 0.0, "odd_res": 0.0}
    for b_pks, x, flavor in calls:
        for j in range(b_pks.shape[0]):
            xj = x[j].float() if control else x[j]
            r = op.residuals(u_ph, packed_to_full(b_pks[j], dims), packed_to_full(xj, dims),
                             action["kappa"], action["mu"], flavor, even)
            worst["relres"] = max(worst["relres"], r[kind])
            worst["odd_res"] = max(worst["odd_res"], r["odd"])
    return worst if kind == "schur" else {"relres": worst["relres"]}


def _columns_off(unit, dims, flavor: int, device) -> int:
    spec, calls = unit["spec"], unit["audit"]
    got = [(bj, f) for bp, _, f in calls for bj in bp]
    off = abs(len(got) - len(spec["columns"]))
    for c, (bj, f) in zip(spec["columns"], got):
        src = tw.point_source(dims, spec["position"], c, device)
        off += f != flavor or not torch.equal(packed_to_full(bj, dims), src)
    return off


def _x_gap(unit) -> float:
    x = [xj for _, xp, _ in unit["audit"] for xj in xp]
    ret = unit["returned"]
    if not x or ret.shape != (len(x), *x[0].shape):
        return float("inf")
    return max((ret[j] - xj.to(ret.dtype)).abs().max().item() for j, xj in enumerate(x))


def judge_solve(units, config: dict, traffic: dict, gauge_file: str, device,
                control=False) -> dict:
    _, u_ph, dims = _links(gauge_file, device, config["gauge"]["antiperiodic_t"])
    out = {"relres": 0.0, "columns_off": 0, "x_gap": 0.0}
    if not units:
        return {k: float("inf") for k in out}
    flavor = int(traffic.get("flavor", 1))
    for unit in units:
        out["columns_off"] += _columns_off(unit, dims, flavor, device)
        out["x_gap"] = max(out["x_gap"], _x_gap(unit))
        if unit["audit"]:
            r = _residual_numbers(u_ph, dims, unit["audit"], config["run"]["action"],
                                  config["residual"], control)
            out["relres"] = max(out["relres"], r["relres"])
    return out


def _gap(a: torch.Tensor, ref: torch.Tensor) -> float:
    return ((a - ref).abs().max() / ref.abs().max()).item()


def _propagator(u_sm, x_cols, dims, ph, rnd) -> torch.Tensor:
    """12 float32-rounded solutions -> the sink-smeared propagator [V, 4, 3, 4, 3]."""
    cols = [tw.gauss_smear(u_sm, packed_to_full(x.float(), dims), ph["smear_alpha_gauss"],
                           ph["smear_n_gauss"], rnd) for x in x_cols]
    s = torch.stack(cols, dim=-1)                     # [T, Z, Y, X, 4, 3, 12]
    return s.reshape(-1, 4, 3, 4, 3)


def _correlators(u_sm, xs_u, xs_d, dims, ph, pos, rnd) -> dict:
    lx, ly, lz, lt = dims
    su, sd = _propagator(u_sm, xs_u, dims, ph, rnd), _propagator(u_sm, xs_d, dims, ph, rnd)
    t, z, y, x = pos
    tag = f"sx{x}sy{y}sz{z}st{t}"
    dens = {}
    for pname in ph["projectors"]:
        proj = tw.PROJECTORS[pname]
        dens[f"twop/proton/{pname}/{tag}"] = tw.proton_density(su, sd, proj, rnd)
        dens[f"twop/neutron/{pname}/{tag}"] = tw.proton_density(sd, su, proj, rnd)
    for chan in ph["meson_channels"]:
        dens[f"twop/{chan}/{tag}"] = tw.meson_density(su, su, tw.MESONS[chan], rnd)
    return {k: tw.project(d.reshape(lt, lz, ly, lx), ph["momenta"], (x, y, z))
            for k, d in dens.items()}


def _columns(calls, flavor):
    b = [bj for bp, _, f in calls if f == flavor for bj in bp]
    x = [xj for _, xp, f in calls if f == flavor for xj in xp]
    return b, x


def judge_twop(units, config: dict, traffic: dict, gauge_file: str, device,
               control=False) -> dict:
    u, u_ph, dims = _links(gauge_file, device, config["gauge"]["antiperiodic_t"])
    ph = config["run"]["physics"]
    rnd = tw.bf16 if control else tw.exact
    u_sm = tw.ape_smear(u, ph["smear_alpha_ape"], ph["smear_n_ape"])
    u_sm_c = tw.ape_smear(u, ph["smear_alpha_ape"], ph["smear_n_ape"], rnd) if control else u_sm
    del u
    out = {"relres": 0.0, "odd_res": 0.0, "source_gap": 0.0, "corr_gap": 0.0}
    if not units:
        return {k: float("inf") for k in out}
    for unit in units:
        calls, pos = unit["audit"], unit["spec"]["position"]
        for k, v in _residual_numbers(u_ph, dims, calls, config["run"]["action"],
                                      config["residual"], control).items():
            out[k] = max(out[k], v)
        b_u, x_u = _columns(calls, +1)
        b_d, x_d = _columns(calls, -1)
        if len(b_u) != 12 or len(b_d) != 12:
            return {k: float("inf") for k in out}
        for c in range(12):
            src = tw.point_source(dims, pos, c, device)
            ref = tw.gauss_smear(u_sm, src, ph["smear_alpha_gauss"], ph["smear_n_gauss"])
            if control:
                gap = _gap(tw.gauss_smear(u_sm_c, src, ph["smear_alpha_gauss"],
                                          ph["smear_n_gauss"], rnd), ref)
            else:
                gap = max(_gap(packed_to_full(b, dims), ref) for b in (b_u[c], b_d[c]))
            out["source_gap"] = max(out["source_gap"], gap)
        ref = _correlators(u_sm, x_u, x_d, dims, ph, pos, tw.exact)
        got = (_correlators(u_sm_c, x_u, x_d, dims, ph, pos, rnd) if control
               else {k: torch.as_tensor(v, device=device) for k, v in unit["correlators"].items()})
        if set(got) != set(ref):
            return {**out, "corr_gap": float("inf")}
        for k in ref:
            for m in range(ref[k].shape[0]):
                out["corr_gap"] = max(out["corr_gap"], _gap(got[k][m], ref[k][m]))
    return out
