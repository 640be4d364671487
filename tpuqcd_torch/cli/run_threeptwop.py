"""Nucleon two- and three-point production run (BASELINE config 5's
connected part).

Counterpart of ``tpuqcd/cli/run_threeptwop.py``: gauge -> APE or stout
smearing -> 12 Gaussian-smeared sources -> 12 forward solves per flavor as
one batched stream -> sink smearing -> proton and neutron two-point
functions -> per baryon, sink time, projector and leg: the sequential
source, its Gaussian smearing, 12 flavor-flipped backward solves as one
batch, the 16 ultra-local and 16 one-derivative insertions -> HDF5; once
per member of an ensemble (common.ensemble_members), each into its own
physics.output.

    python -m tpuqcd_torch.cli.run_threeptwop --config examples/threep.yaml
    python -m tpuqcd_torch.cli.run_threeptwop --config examples/threep.yaml --device cpu

With physics.smear_n_gauss > 0 it is the fixed smeared-sink method: the
two-point functions and the sequential sources come from the sink-smeared
propagators and the sequential source is smeared itself before the
backward solves, while the insertions couple to the unsmeared forward
propagators, which are kept apart.  The neutron is the isospin mirror of
the proton's Wick engine (u and d swapped): its engine leg "u", the
doubly represented quark, is then the physical d.  A backward solve runs
with the flavor opposite to its physical quark's (M^T = conj(g5 M_{-f}
g5)).  Everything after the configuration runs on ``--device``; only the
[n_mom, T] correlators cross to the host.  Datasets, as tpuqcd names them
(<quark> is the leg's physical quark):

    twop/<baryon>/<projector>/sx<x>sy<y>sz<z>st<t>/mom_px_py_pz
    threep/<baryon>/<projector>/<quark>/ts<t_sink>/<source>/<insertion>/mom_px_py_pz
    threep_der/<baryon>/<projector>/<quark>/ts<t_sink>/<source>/der_g<mu>_D<nu>/mom_px_py_pz

The sink momentum's phase is taken relative to the source
(phys/threep_dev.py's docstring says why and where tpuqcd differs).

On a mesh (``mesh.nt/nz/ny`` under torchrun) each rank holds its block of
every field, as in run_twop: the sequential source is built and smeared
on the ranks that hold t_sink (the others hold zeros), the backward
solves run sharded, the covariant derivative exchanges t, z and y faces,
and the projections' partial sums are summed over the ranks.  No field is
gathered; rank 0 alone writes.

    torchrun --nproc_per_node 2 -m tpuqcd_torch.cli.run_threeptwop \\
        --config examples/threep_mesh.yaml --device cpu
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..gammas import INSERTION_GAMMAS, PROJECTORS
from ..io.hdf5io import write_threep, write_twop
from ..parallel import dist as tdist
from ..phys.contract_dev import proton_2pt_site_dev
from ..phys.propagator import (assemble_propagator_pk, sink_smear_prop_pk,
                               sink_smear_timeslice_pk)
from ..phys.threep_dev import (backward_prop_pk, project_momenta_pk, proton_seq_source_pk,
                               threep_one_derivative_all_pk, threep_ultralocal_pk)
from ..utils.config import RunConfig
from ..utils.profile import Profile
from .common import (Gauge, check_in_slice, ensemble_members, log, make_solver, parse_args,
                     setup_gauge)
from .run_twop import mesh_of, smeared_links, smeared_sources, source_tag, stage_timer

#: twisted-mass flavor of each physical quark's forward solve
FLAVOR_OF = {"u": +1, "d": -1}


@dataclasses.dataclass(frozen=True)
class ThreepResult:
    #: two-point group ("twop/proton/P+/sx0sy0sz0st0") -> complex128 [n_mom, T]
    twop: dict
    #: three-point group ("threep/proton/P+/u/ts2/sx0sy0sz0st0", "threep_der/...")
    #: -> {insertion: complex128 [n_mom, T]}
    threep: dict
    #: group -> its source position (t, z, y, x)
    sources: dict
    #: three-point group -> its sink timeslice
    t_sinks: dict
    sink_momentum: tuple
    #: seconds by stage, host clock, device synchronised: gauge, smearing,
    #: sources, solves_u, solves_d, sink_smearing, contractions, projection
    #: (the two-point functions), seq_sources, seq_smearing, solves_bwd,
    #: insertions (ultra-local, contracted and projected), derivatives
    seconds: dict
    #: one entry per solver call (cli/common.Solver.records), forward ones first
    solves: list
    momenta: np.ndarray
    plaquette: float
    #: kept only with keep_fields: the packed float32 gauge; per source tag the
    #: packed sources "b" and the unsmeared forward propagators "u" and "d";
    #: in every entry of ``solves`` the float64 solution of its first column
    u_pk: torch.Tensor | None = None
    fields: dict | None = None


def measure(cfg: RunConfig, device: torch.device, gauge: Gauge | None = None,
            keep_fields: bool = False, audit=None, lmesh=None) -> ThreepResult:
    """The two- and three-point measurement of ``cfg`` on ``device``.
    ``gauge``, what setup_gauge(cfg, device) returned before, saves
    generating it again; ``audit`` goes to the solver (Solver.audit).  On
    the mesh of cfg.mesh, or ``lmesh``, as run_twop.measure."""
    check_in_slice(cfg, threep=True)
    ph = cfg.physics
    lat, u_pk, plaq, gauge_seconds = setup_gauge(cfg, device) if gauge is None else gauge
    solve = make_solver(cfg, lat, u_pk, lmesh)
    solve.keep_first, solve.audit = keep_fields, audit
    lmesh = mesh_of(solve, plaq)
    momenta = np.asarray(ph.momenta)
    snk = tuple(int(q) for q in ph.sink_momentum)
    n_gauss, a_gauss = ph.smear_n_gauss, ph.smear_alpha_gauss
    prof = Profile()
    prof.times["gauge"] = gauge_seconds
    stage = stage_timer(prof, device)
    with stage("smearing"):
        u_sm = smeared_links(cfg, lat, u_pk, lmesh)
    twop, threep, sources, t_sinks, fields = {}, {}, {}, {}, {}
    for src in ph.source_positions:
        tag, xyz = source_tag(src), (src[3], src[2], src[1])
        log.info("source %s (contractions on %s)", tuple(src), device)
        with stage("sources"):
            b_pks = smeared_sources(cfg, lat, src, u_sm, device, lmesh)
        props, props_sm = {}, {}
        for name, flavor in FLAVOR_OF.items():
            log.info(" forward props flavor %s (batched rhs)", name)
            with stage(f"solves_{name}"):
                props[name] = assemble_propagator_pk(solve.packed_src_batch(b_pks, flavor))
            with stage("sink_smearing"):
                props_sm[name] = (sink_smear_prop_pk(u_sm, props[name], lat, a_gauss, n_gauss,
                                                     lmesh) if n_gauss > 0 else props[name])
        for baryon in ph.baryons:
            phys_of = {"u": "u", "d": "d"} if baryon == "proton" else {"u": "d", "d": "u"}
            pu, pd = props_sm[phys_of["u"]], props_sm[phys_of["d"]]
            with stage("contractions"):
                dens = {p: proton_2pt_site_dev(pu, pd, PROJECTORS[p]) for p in ph.projectors}
            with stage("projection"):
                for pname, d in dens.items():
                    group = f"twop/{baryon}/{pname}/{tag}"
                    twop[group] = project_momenta_pk(d, lat, momenta, xyz, lmesh=lmesh)
                    sources[group] = tuple(src)
            del dens
            for t_sink in ph.t_sinks:
                for pname in ph.projectors:
                    for leg in ("u", "d"):
                        phys = phys_of[leg]
                        log.info(" seq source %s tsink=%d proj=%s quark=%s", baryon, t_sink,
                                 pname, phys)
                        with stage("seq_sources"):
                            seq = proton_seq_source_pk(pu, pd, t_sink, leg, lat,
                                                       PROJECTORS[pname], snk, xyz, lmesh)
                        if n_gauss > 0:
                            with stage("seq_smearing"):
                                seq = sink_smear_timeslice_pk(u_sm, seq, lat, t_sink, a_gauss,
                                                              n_gauss, lmesh)
                        flip = -FLAVOR_OF[phys]
                        with stage("solves_bwd"):
                            bwd = backward_prop_pk(
                                seq, lambda bs: solve.packed_src_batch(bs, flip))
                        del seq
                        part = f"{baryon}/{pname}/{phys}/ts{t_sink}/{tag}"
                        with stage("insertions"):
                            threep[f"threep/{part}"] = threep_ultralocal_pk(
                                bwd, props[phys], INSERTION_GAMMAS, lat, momenta, src,
                                lmesh=lmesh)
                        with stage("derivatives"):
                            threep[f"threep_der/{part}"] = threep_one_derivative_all_pk(
                                bwd, props[phys], u_pk, lat, momenta, src, lmesh=lmesh)
                        del bwd
                        for kind in ("threep", "threep_der"):
                            sources[f"{kind}/{part}"] = tuple(src)
                            t_sinks[f"{kind}/{part}"] = int(t_sink)
        if keep_fields:
            fields[tag] = {"b": b_pks, **props}
        del props, props_sm
    return ThreepResult(
        twop={k: v.cpu().numpy() for k, v in twop.items()},
        threep={g: {k: v.cpu().numpy() for k, v in ins.items()} for g, ins in threep.items()},
        sources=sources, t_sinks=t_sinks, sink_momentum=snk, seconds=dict(prof.times),
        solves=solve.records, momenta=momenta, plaquette=plaq,
        u_pk=u_pk if keep_fields else None, fields=fields if keep_fields else None)


def write(cfg: RunConfig, result: ThreepResult) -> None:
    """The correlators into physics.output: the two-point groups as
    write_twop, the three-point groups as write_threep (one subgroup per
    insertion, the group's attributes src_pos, t_sink and sink_momentum); on
    a mesh rank 0 alone writes."""
    if tdist.rank() != 0:
        return
    out = cfg.physics.output
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    for group, corr in result.twop.items():
        write_twop(out, group, corr, result.momenta, result.sources[group])
    meta = {"sink_momentum": np.asarray(result.sink_momentum)}
    for group, ins in result.threep.items():
        names = list(ins)
        write_threep(out, group, np.stack([ins[k] for k in names]), result.momenta, names,
                     result.sources[group], result.t_sinks[group], meta=meta)
    log.info("wrote %d two-point and %d three-point groups -> %s", len(result.twop),
             len(result.threep), out)


def main(argv=None):
    cfg, device = parse_args(__doc__, argv)
    try:
        for ctag, c in ensemble_members(cfg, device):
            if ctag:
                log.info("=== ensemble member %s ===", ctag)
            result = measure(c, device)
            write(c, result)
            log.info("seconds by stage: %s", {k: round(v, 3) for k, v in result.seconds.items()})
    finally:
        tdist.shutdown()


if __name__ == "__main__":
    main()
