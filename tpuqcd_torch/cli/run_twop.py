"""Nucleon and meson two-point production run (BASELINE config 4).

Counterpart of ``tpuqcd/cli/run_twop.py``: gauge (an ILDG file, a heatbath
or random links; per member of an ensemble, common.ensemble_members) and
plaquette check -> APE or stout smearing -> 12 Gaussian-smeared sources ->
12 forward solves per flavor as one batched stream -> sink smearing ->
proton, neutron and meson correlators -> momentum projection -> HDF5.

    python -m tpuqcd_torch.cli.run_twop --config examples/twop.yaml
    python -m tpuqcd_torch.cli.run_twop --config examples/twop.yaml --device cpu

Everything after the configuration runs on ``--device`` (the card unless
the caller says cpu); the propagators stay packed there and only the
[n_mom, T] correlators cross to the host.  The port always takes the
device contraction path (phys/contract_dev.py); tpuqcd's host path
(phys/contract.py) stays its oracle.

With a mesh of more than one rank (``mesh.nt/nz/ny``; torchrun, one
process per card, NCCL, or gloo with ``--device cpu``) each rank holds
only its block of every source, solution and propagator: the gauge is
whole on every rank (the smearing of the links runs on it, then each rank
cuts its block and ghost layer), the Gaussian smearing exchanges z and y
faces, the solves run sharded (cli/common.Solver's mesh branch), the
contractions are site-local and the projections' [n_mom, T] partial sums
are summed over the ranks.  No field is gathered; rank 0 alone writes.

    torchrun --nproc_per_node 2 -m tpuqcd_torch.cli.run_twop \\
        --config examples/twop_mesh.yaml --device cpu

Datasets, as tpuqcd names them:

    twop/proton/<projector>/sx<x>sy<y>sz<z>st<t>/mom_px_py_pz
    twop/neutron/<projector>/<source>/mom_px_py_pz
    twop/<meson channel>/<source>/mom_px_py_pz
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from ..gammas import MESON_CHANNELS, PROJECTORS
from ..io.hdf5io import write_twop
from ..parallel import dist as tdist
from ..phys.contract_dev import meson_2pt_site_dev, proton_2pt_site_dev
from ..phys.propagator import (assemble_propagator_pk, packed_sources, point_sources,
                               sink_smear_prop_pk, smear_sources)
from ..phys.threep_dev import project_momenta_pk
from ..utils.config import RunConfig
from ..utils.profile import Profile, sync
from .common import (Gauge, ensemble_members, log, make_solver, parse_args, setup_gauge,
                     smeared_gauge)


@dataclasses.dataclass(frozen=True)
class TwopResult:
    #: dataset group ("twop/proton/P+/sx0sy0sz0st0") -> complex128 [n_mom, T]
    correlators: dict
    #: dataset group -> its source position (t, z, y, x)
    sources: dict
    #: seconds by stage, host clock, device synchronised: gauge, smearing,
    #: sources, solves_u, solves_d, sink_smearing, contractions (the Wick
    #: contractions to site densities), projection (to momenta)
    seconds: dict
    #: one entry per solver call (cli/common.Solver.records)
    solves: list
    momenta: np.ndarray
    plaquette: float
    #: kept only with keep_fields, for independent checks: the packed float32
    #: gauge; per source tag the packed sources "b" [12, 2(par), 2(ri), ...]
    #: and the sink-smeared propagators "u" and "d"; and in every entry of
    #: ``solves`` the float64 solution of its first column, "x_first"
    u_pk: torch.Tensor | None = None
    fields: dict | None = None


def source_tag(src) -> str:
    return f"sx{src[3]}sy{src[2]}sz{src[1]}st{src[0]}"


def stage_timer(prof: Profile, device: torch.device):
    """stage(name): a context that adds its seconds to prof.times[name], the
    device synchronised before the clock stops."""
    @contextlib.contextmanager
    def stage(name):
        with prof.phase(name):
            yield
            sync(device)
    return stage


def smeared_sources(cfg: RunConfig, lat, src, u_sm: torch.Tensor | None,
                    device: torch.device, lmesh=None) -> torch.Tensor:
    """The 12 point sources at src = (t, z, y, x), packed [12, 2(par), 2(ri),
    4, 3, T, Z, S] on ``device``, Gaussian-smeared on u_sm when
    physics.smear_n_gauss > 0; on a mesh (``lmesh``) this rank's blocks, u_sm
    the block's links with their ghost layer (smeared_links)."""
    ph = cfg.physics
    blk = lat if lmesh is None else lmesh.local_lat
    b_pks = packed_sources(point_sources(lat, tuple(src), device=device, lmesh=lmesh), blk)
    if ph.smear_n_gauss > 0:
        b_pks = smear_sources(u_sm, b_pks, lat, ph.smear_alpha_gauss, ph.smear_n_gauss, lmesh)
    return b_pks


def smeared_links(cfg: RunConfig, lat, u_pk: torch.Tensor, lmesh=None) -> torch.Tensor | None:
    """The links of the Gaussian smearing (common.smeared_gauge) when
    physics.smear_n_gauss > 0, else None; on a mesh (``lmesh``) smeared on
    the whole gauge, then cut to this rank's block with its ghost layer in
    z and y (parallel/sharded.ghost_block)."""
    if cfg.physics.smear_n_gauss <= 0:
        return None
    u_sm = smeared_gauge(cfg, lat, u_pk)
    if lmesh is None:
        return u_sm
    from ..parallel.sharded import ghost_block
    from ..phys.smear import SMEAR_AXES
    return ghost_block(lmesh, u_sm, SMEAR_AXES).contiguous()


def mesh_of(solve, plaquette: float):
    """The solver's LatticeMesh (None on one card), after checking that
    every rank built the same gauge."""
    if solve.lmesh is not None and not tdist.all_processes_agree(plaquette, "plaquette"):
        raise RuntimeError("the ranks built different gauges")
    return solve.lmesh


def measure(cfg: RunConfig, device: torch.device, gauge: Gauge | None = None,
            keep_fields: bool = False, audit=None, lmesh=None) -> TwopResult:
    """The two-point measurement of ``cfg`` on ``device``: the correlators
    by dataset group and the seconds by stage.  ``gauge``, what
    setup_gauge(cfg, device) returned before, saves generating it again;
    ``audit`` goes to the solver (Solver.audit: every column, its source
    and float64 solution).  On the mesh of cfg.mesh, or ``lmesh`` (a
    LatticeMesh; one rank runs the mesh path too), the fields, kept ones
    included, are this rank's blocks and every rank returns the whole
    correlators."""
    ph = cfg.physics
    lat, u_pk, plaq, gauge_seconds = setup_gauge(cfg, device) if gauge is None else gauge
    solve = make_solver(cfg, lat, u_pk, lmesh)
    solve.keep_first = keep_fields
    solve.audit = audit
    lmesh = mesh_of(solve, plaq)
    momenta = np.asarray(ph.momenta)
    prof = Profile()
    prof.times["gauge"] = gauge_seconds
    stage = stage_timer(prof, device)
    with stage("smearing"):
        u_sm = smeared_links(cfg, lat, u_pk, lmesh)
    correlators, sources, fields = {}, {}, {}
    for src in ph.source_positions:
        tag = source_tag(src)
        log.info("source %s (contractions on %s)", tuple(src), device)
        with stage("sources"):
            b_pks = smeared_sources(cfg, lat, src, u_sm, device, lmesh)
        props = {}
        for name, flavor in (("u", +1), ("d", -1)):
            log.info(" forward props flavor %s (batched rhs)", name)
            with stage(f"solves_{name}"):
                xs = solve.packed_src_batch(b_pks, flavor=flavor)
            with stage("sink_smearing"):
                p = assemble_propagator_pk(xs)
                if ph.smear_n_gauss > 0:
                    p = sink_smear_prop_pk(u_sm, p, lat, ph.smear_alpha_gauss, ph.smear_n_gauss,
                                           lmesh)
                props[name] = p
        with stage("contractions"):
            dens = {}
            for pname in ph.projectors:
                proj = PROJECTORS[pname]
                dens[f"twop/proton/{pname}/{tag}"] = proton_2pt_site_dev(
                    props["u"], props["d"], proj)
                # neutron = isospin mirror (the u and d propagators swapped)
                dens[f"twop/neutron/{pname}/{tag}"] = proton_2pt_site_dev(
                    props["d"], props["u"], proj)
            for chan in ph.meson_channels:
                dens[f"twop/{chan}/{tag}"] = meson_2pt_site_dev(
                    props["u"], props["u"], MESON_CHANNELS[chan])
        with stage("projection"):
            for group, d in dens.items():
                correlators[group] = project_momenta_pk(d, lat, momenta,
                                                        (src[3], src[2], src[1]), lmesh=lmesh)
                sources[group] = tuple(src)
            del dens
        if keep_fields:
            fields[tag] = {"b": b_pks, **props}
        del props
    correlators = {k: v.cpu().numpy() for k, v in correlators.items()}
    return TwopResult(correlators=correlators, sources=sources, seconds=dict(prof.times),
                      solves=solve.records, momenta=momenta, plaquette=plaq,
                      u_pk=u_pk if keep_fields else None,
                      fields=fields if keep_fields else None)


def write(cfg: RunConfig, result: TwopResult) -> None:
    """The correlators into physics.output, one group per dataset name; on
    a mesh rank 0 alone writes."""
    if tdist.rank() != 0:
        return
    out = cfg.physics.output
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    for group, corr in result.correlators.items():
        write_twop(out, group, corr, result.momenta, result.sources[group],
                   meta={"kappa": cfg.action.kappa, "mu": cfg.action.mu})
    log.info("wrote %d correlator groups -> %s", len(result.correlators), out)


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
