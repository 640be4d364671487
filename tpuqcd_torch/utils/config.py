"""Run configuration: frozen dataclasses, loadable from the YAML files of
``examples/``.

Counterpart of ``tpuqcd/utils/config.py`` for the parameter groups the
port runs: gauge, action, solver, and the switches of the parts not
ported yet (mg, mesh), which ``cli/common.check_in_slice`` refuses.
Keys of other groups (physics) and of unported options are ignored, so
every existing YAML loads.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class GaugeParams:
    dims: tuple[int, int, int, int] = (8, 8, 8, 16)   # (Lx, Ly, Lz, Lt)
    config_file: Optional[str] = None
    random_seed: int = 0
    antiperiodic_t: bool = True
    plaquette_check: Optional[float] = None
    config_files: tuple = ()
    random_seeds: tuple = ()
    fix: str = ""
    heatbath_beta: Optional[float] = None
    heatbath_n_cfg: int = 1


@dataclass(frozen=True)
class ActionParams:
    kappa: float = 0.12
    mu: float = 0.05
    csw: float = 0.0
    epsbar: float = 0.0
    mu_list: tuple = ()


@dataclass(frozen=True)
class SolverParams:
    tol: float = 1e-10
    maxiter: int = 5000
    inner_tol: float = 1e-5
    solver: str = "cg"                   # cg | bicgstab
    sloppy_dtype: str = "float32"        # float32 | bfloat16
    #: parsed so that tpuqcd's YAMLs load; the port's tensor device picks
    #: the kernel or the plain version
    backend: str = "pallas"              # pallas | xla


@dataclass(frozen=True)
class MGParamsCfg:
    enabled: bool = False


@dataclass(frozen=True)
class MeshParams:
    nt: int = 1
    nz: int = 1
    ny: int = 1


@dataclass(frozen=True)
class RunConfig:
    gauge: GaugeParams = field(default_factory=GaugeParams)
    action: ActionParams = field(default_factory=ActionParams)
    solver: SolverParams = field(default_factory=SolverParams)
    mg: MGParamsCfg = field(default_factory=MGParamsCfg)
    mesh: MeshParams = field(default_factory=MeshParams)


class ConfigError(ValueError):
    """An invalid run configuration, raised at load time."""


def validate_config(cfg: RunConfig) -> None:
    dims = tuple(cfg.gauge.dims)
    if len(dims) != 4 or any(d <= 0 or d % 2 for d in dims):
        raise ConfigError(f"gauge.dims must be 4 positive even numbers "
                          f"(Lx, Ly, Lz, Lt), got {dims}")
    if cfg.solver.solver not in ("cg", "bicgstab", "eigcg"):
        raise ConfigError(f"solver.solver must be cg | bicgstab | eigcg, "
                          f"got {cfg.solver.solver!r}")
    if cfg.solver.sloppy_dtype not in ("float32", "bfloat16"):
        raise ConfigError(f"solver.sloppy_dtype must be float32 | bfloat16, "
                          f"got {cfg.solver.sloppy_dtype!r}")
    if cfg.solver.backend not in ("pallas", "xla"):
        raise ConfigError(f"solver.backend must be pallas | xla, "
                          f"got {cfg.solver.backend!r}")
    if not 0.0 < cfg.solver.tol < 1.0:
        raise ConfigError(f"solver.tol must be in (0, 1), got {cfg.solver.tol}")
    if cfg.solver.maxiter <= 0:
        raise ConfigError(f"solver.maxiter must be positive, got {cfg.solver.maxiter}")


def _tupleize(v):
    if isinstance(v, list):
        return tuple(_tupleize(x) for x in v)
    return v


def _build(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: _tupleize(v) for k, v in (d or {}).items() if k in names})


def config_from_dict(raw: dict) -> RunConfig:
    cfg = RunConfig(gauge=_build(GaugeParams, raw.get("gauge")),
                    action=_build(ActionParams, raw.get("action")),
                    solver=_build(SolverParams, raw.get("solver")),
                    mg=_build(MGParamsCfg, raw.get("mg")),
                    mesh=_build(MeshParams, raw.get("mesh")))
    validate_config(cfg)
    return cfg


def load_config(path: str) -> RunConfig:
    import yaml
    with open(path) as f:
        return config_from_dict(yaml.safe_load(f) or {})
