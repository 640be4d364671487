"""Shared CLI plumbing: arguments, device, scope checks, gauge setup.

Counterpart of ``tpuqcd/cli/common.py:21-77, :183-275``.  The device is
explicit: ``--device`` defaults to ``cuda`` and raises when CUDA is
missing; ``--device cpu`` runs the plain PyTorch versions.
"""
from __future__ import annotations

import argparse
import logging
import sys

import torch

from .. import su3
from ..fields import gauge_full_to_eo
from ..lattice import Lattice
from ..ops.gauge_tools import plaquette
from ..ops.layout import gauge_to_device
from ..phys.propagator import full_to_packed
from ..utils.config import RunConfig, load_config
from ..utils.convert import gauge_from_full

log = logging.getLogger("tpuqcd_torch")


def parse_args(description: str, argv=None) -> tuple[RunConfig, torch.device]:
    ap = argparse.ArgumentParser(description=description,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True, help="YAML run config")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cuda:N runs the kernels; cpu runs "
                         "their plain PyTorch versions")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s",
                        stream=sys.stdout)
    return load_config(args.config), resolve_device(args.device)


def resolve_device(name) -> torch.device:
    """torch.device for ``name``; a CUDA device without CUDA raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not available "
                           f"(torch {torch.__version__}); use --device cpu for the "
                           "plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {name!r}")
    return dev


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported to tpuqcd_torch yet "
                              f"(ROADMAP.md, Queue 1 item {item})")


def check_in_slice(cfg: RunConfig) -> None:
    """Refuse the configurations the port does not run yet."""
    g, a = cfg.gauge, cfg.action
    if cfg.mg.enabled:
        _not_ported("mg.enabled (the multigrid solve)", "7, MG on the main path")
    if a.csw != 0.0:
        _not_ported("action.csw != 0 (twisted clover)", "8, TM-clover")
    if a.epsbar != 0.0:
        _not_ported("action.epsbar (the non-degenerate doublet)", "12, remaining variants")
    if a.mu_list:
        _not_ported("action.mu_list (the multishift mass sweep)", "12, remaining variants")
    if cfg.mesh.nt * cfg.mesh.nz * cfg.mesh.ny > 1:
        _not_ported("mesh (the multi-device solve)", "13, multi-device")
    if cfg.solver.solver == "eigcg":
        _not_ported("solver.solver: eigcg", "11, loops and deflation")
    if g.config_files or g.random_seeds or g.heatbath_n_cfg > 1:
        _not_ported("ensemble members (gauge.config_files, random_seeds, "
                    "heatbath_n_cfg)", "9, config-4 physics end to end")
    if g.config_file:
        _not_ported("gauge.config_file (ILDG reading)", "9, config-4 physics end to end")
    if g.heatbath_beta is not None:
        _not_ported("gauge.heatbath_beta (the quenched heatbath)", "7, MG on the main path")
    if g.fix:
        _not_ported("gauge.fix (gauge fixing)", "12, remaining variants")


def setup_gauge(cfg: RunConfig, device: torch.device) -> tuple[Lattice, torch.Tensor]:
    """Random gauge from gauge.random_seed -> (lat, packed float32 gauge
    [4, 2, 3, 3, 2, T, Z, S] on ``device`` with the boundary phase)."""
    lat = Lattice(tuple(cfg.gauge.dims))
    gen = torch.Generator().manual_seed(int(cfg.gauge.random_seed))
    u_full = su3.random_gauge(lat, gen, device)
    log.info("generated random gauge dims=%s seed=%d", lat.dims, cfg.gauge.random_seed)
    plaq = plaquette(gauge_to_device(gauge_full_to_eo(u_full, lat), lat), lat)
    log.info("plaquette = %.8f", plaq)
    if cfg.gauge.plaquette_check is not None and abs(plaq - cfg.gauge.plaquette_check) > 1e-5:
        raise RuntimeError(f"plaquette check failed: {plaq} != {cfg.gauge.plaquette_check}")
    u_pk = gauge_from_full(u_full, lat, cfg.gauge.antiperiodic_t, torch.float32, device)
    return lat, u_pk


def random_source(lat: Lattice, device: torch.device, seed: int = 99) -> torch.Tensor:
    """Gaussian complex source, drawn in full layout on the CPU generator,
    as packed float32 [2(par), 2(ri), 4, 3, T, Z, S] on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    shape = (*lat.full_shape, 4, 3)
    b = torch.complex(torch.randn(shape, generator=gen), torch.randn(shape, generator=gen))
    return full_to_packed(b.to(device), lat)
