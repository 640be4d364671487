"""Run configuration: frozen dataclasses, loadable from the YAML files of
``examples/``.

Counterpart of ``tpuqcd/utils/config.py`` for the parameter groups the
port runs: gauge (random, heatbath, an ILDG file, an ensemble of files,
seeds or heatbath-chain members, gauge fixing: every key of tpuqcd's
GaugeParams), action (with the non-degenerate doublet's mubar and
epsbar), solver (with the multi-RHS batch keys), mg (every key of
tpuqcd's MGParamsCfg, with the named presets), physics (every key of
tpuqcd's PhysicsParams), mesh, and the mass sweep's action.mu_list.  Keys
of unported options are ignored, so every existing YAML loads.
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
    #: ensemble mode (cli/common.ensemble_members): ILDG paths, or seeds;
    #: member i's physics.output gets '.<tag>' before its suffix
    config_files: tuple = ()
    random_seeds: tuple = ()
    #: gauge fixing of the links before the boundary phase (ops/gauge_fix.py):
    #: "" (none), "landau" or "coulomb"
    fix: str = ""
    fix_sweeps: int = 200
    fix_tol: float = 1e-9
    #: quenched heatbath gauge (ops/heatbath.py) when beta is set:
    #: heatbath_sweeps compound sweeps (1 heatbath + 3 overrelaxation)
    #: from a cold start, seeded by random_seed
    heatbath_beta: Optional[float] = None
    heatbath_sweeps: int = 200
    #: heatbath ensemble (n_cfg > 1): ONE Markov chain, a member every
    #: heatbath_skip compound sweeps after the thermalization, each
    #: written to ILDG under heatbath_dir (default '<output dir>/ensemble')
    #: and read back with its plaquette pinned
    heatbath_n_cfg: int = 1
    heatbath_skip: int = 20
    heatbath_dir: str = ""


@dataclass(frozen=True)
class ActionParams:
    kappa: float = 0.12
    mu: float = 0.05
    csw: float = 0.0
    #: non-degenerate (heavy s/c) doublet: epsbar != 0 selects M_nd = 1 +
    #: 2 i kappa mubar g5 tau3 + 2 kappa epsbar tau1 - kappa D
    mubar: float = 0.0
    epsbar: float = 0.0
    #: the quark-mass sweep (run_invert): every mu solved from one multishift
    #: Krylov space, then certified mass by mass (solve.solve_tm_musweep)
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
    #: multi-device hop: "fused" (face exchange + halo-mode kernel) or
    #: "overlap" (the interior/exterior split, parallel/overlap.py); "auto"
    #: takes fused on one rank and on the CPU, overlap on a y-sharded mesh,
    #: else the faster of the two on the cards (utils/tune.tune_comm_policy)
    comm_policy: str = "auto"            # auto | fused | overlap
    #: propagator columns solved per batched multi-RHS call (1 =
    #: sequential).  The MG path holds about rhs_batch * (2 + 2 * restart)
    #: fine fields; mg/dsolve.solve_certified_batch checks that sum against
    #: the card's free memory before it allocates
    rhs_batch: int = 12
    #: gate of the direct (non-MG) batched path: the first column is solved
    #: alone, and if its matvec count exceeds rhs_batch_gate_iters the other
    #: columns run in batches of rhs_batch_gate_chunk instead of rhs_batch.
    #: Keys and default values are tpuqcd's, so that its YAMLs mean the
    #: same here; they were tuned for its hardware, not for this card.
    #: 0 disables the gate.
    rhs_batch_gate_iters: int = 1500
    rhs_batch_gate_chunk: int = 4


@dataclass(frozen=True)
class MGParamsCfg:
    """The mg: group (tpuqcd/utils/config.py:119-154)."""
    enabled: bool = False
    #: "near_critical" rebases every unset key on MG_PRESETS; explicit
    #: YAML keys win
    preset: Optional[str] = None
    n_vec: tuple[int, ...] = (16,)
    block: tuple = ((4, 4, 4, 4),)
    setup_iters: int = 60
    smoother_iters: int = 4
    #: parsed, as in tpuqcd, where no solver reads it either
    coarse_tol: float = 0.25
    coarse_maxiter: int = 32
    #: flexible-GCR restart length of the outer MG-preconditioned solve
    restart: int = 8
    mu_factor: float = 6.0
    setup_solver: str = "bicgstab"       # bicgstab | cgne
    smoother_dtype: str = "float32"      # float32 | bfloat16
    coarse_dtype: str = "float32"        # float32 | bfloat16
    #: bfloat16 solver buffers: the fine level's outer GCR basis, the
    #: null-vector bank (mg/dsolve.DeviceMGParams)
    gcr_dtype: str = "float32"
    vec_dtype: str = "float32"
    #: hierarchy dumps (utils/checkpoint.py), one file per flavor
    vec_outfile: Optional[str] = None
    vec_infile: Optional[str] = None


#: MGParamsCfg values a preset rebases on (mirrors
#: mg/dsolve.DeviceMGParams.near_critical; coarse_maxiter <-> coarse_iters)
MG_PRESETS = {
    "near_critical": dict(
        n_vec=(16,), block=((4, 4, 4, 4),), setup_iters=300,
        smoother_iters=4, coarse_maxiter=24, restart=24, mu_factor=6.0,
        setup_solver="cgne", smoother_dtype="bfloat16",
        coarse_dtype="bfloat16"),
}


@dataclass(frozen=True)
class PhysicsParams:
    """The physics: group (tpuqcd/utils/config.py:167-206).  The two- and
    three-point runs read the sources, momenta (or mom_max_sq), projectors,
    baryons, channels, sinks, smearing keys and output; the loop run the
    noise, dilution, TSM and deflation keys and output."""
    source_positions: tuple = ((0, 0, 0, 0),)      # (t, z, y, x)
    t_sinks: tuple[int, ...] = ()
    projectors: tuple[str, ...] = ("P+",)
    baryons: tuple[str, ...] = ("proton",)
    momenta: tuple = ((0, 0, 0),)
    sink_momentum: tuple = (0, 0, 0)
    #: if set, momenta is generated as every integer 3-vector with
    #: n.n <= mom_max_sq (long lists take the FFT projection)
    mom_max_sq: Optional[int] = None
    #: gammas.MESON_CHANNELS names; the same Gamma at source and sink
    meson_channels: tuple[str, ...] = ("pion",)
    #: smearing of the Gaussian smearing's links: ape | stout
    smear_type: str = "ape"
    smear_alpha_ape: float = 0.5
    smear_n_ape: int = 10
    smear_rho_stout: float = 0.1
    smear_alpha_gauss: float = 4.0
    smear_n_gauss: int = 30
    n_noise: int = 12
    tsm_cheap: int = 0
    tsm_maxiter_cheap: int = 50
    tsm_tol: float = 1e-3
    n_deflate: int = 0
    eig_outfile: Optional[str] = None
    eig_infile: Optional[str] = None
    dilute_t: int = 1
    dilute_sc: bool = False
    output: str = "results.h5"


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
    physics: PhysicsParams = field(default_factory=PhysicsParams)
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
    if cfg.solver.comm_policy not in ("auto", "fused", "overlap"):
        raise ConfigError(f"solver.comm_policy must be auto | fused | overlap, "
                          f"got {cfg.solver.comm_policy!r}")
    for fld in ("smoother_dtype", "coarse_dtype", "gcr_dtype", "vec_dtype"):
        v = getattr(cfg.mg, fld)
        if v not in ("float32", "bfloat16"):
            raise ConfigError(f"mg.{fld} must be float32 | bfloat16, got {v!r}")
    if cfg.mg.setup_solver not in ("bicgstab", "cgne"):
        raise ConfigError(f"mg.setup_solver must be bicgstab | cgne, "
                          f"got {cfg.mg.setup_solver!r}")
    g = cfg.gauge
    if g.fix not in ("", "landau", "coulomb"):
        raise ConfigError(f"gauge.fix must be '' | landau | coulomb, got {g.fix!r}")
    if g.config_files and g.random_seeds:
        raise ConfigError("gauge.config_files and gauge.random_seeds are exclusive ensemble "
                          "modes: set one")
    if g.config_file and (g.config_files or g.random_seeds):
        raise ConfigError("gauge.config_file is the single-config mode; use only "
                          "gauge.config_files / gauge.random_seeds for ensembles")
    if g.heatbath_beta is not None:
        if g.config_file or g.config_files:
            raise ConfigError("gauge.heatbath_beta generates the gauge in-process: "
                              "exclusive with config_file(s)")
        if g.heatbath_beta <= 0:
            raise ConfigError(f"gauge.heatbath_beta must be > 0, got {g.heatbath_beta}")
        if g.heatbath_sweeps <= 0:
            raise ConfigError("gauge.heatbath_sweeps must be > 0")
        if g.heatbath_n_cfg < 1:
            raise ConfigError("gauge.heatbath_n_cfg must be >= 1")
        if g.heatbath_n_cfg > 1:
            if g.heatbath_skip <= 0:
                raise ConfigError("gauge.heatbath_skip must be > 0 in ensemble mode")
            if g.random_seeds:
                raise ConfigError("gauge.heatbath_n_cfg ensemble (one Markov chain) is "
                                  "exclusive with gauge.random_seeds (per-seed fields)")
    if cfg.mg.enabled:
        _validate_mg(cfg.mg, dims)
    if not 0.0 < cfg.solver.tol < 1.0:
        raise ConfigError(f"solver.tol must be in (0, 1), got {cfg.solver.tol}")
    if cfg.solver.maxiter <= 0:
        raise ConfigError(f"solver.maxiter must be positive, got {cfg.solver.maxiter}")
    if cfg.solver.rhs_batch < 1:
        raise ConfigError(f"solver.rhs_batch must be >= 1, got {cfg.solver.rhs_batch}")
    _validate_physics(cfg.physics, dims)
    a = cfg.action
    if a.epsbar != 0.0:
        t, e = 2.0 * a.kappa * a.mubar, 2.0 * a.kappa * a.epsbar
        if 1.0 + t * t - e * e <= 0.0:
            raise ConfigError(f"ndeg doublet needs 1 + (2 k mubar)^2 > (2 k epsbar)^2 for the "
                              f"site-term inverse; got mubar={a.mubar}, epsbar={a.epsbar}")
        if cfg.mg.enabled or cfg.solver.solver == "eigcg" or a.csw != 0.0:
            raise ConfigError("the ndeg doublet path (action.epsbar != 0) supports the plain "
                              "mixed-precision CG solver only (no mg/eigcg/csw yet)")
    if a.mu_list and (a.csw != 0.0 or a.epsbar != 0.0 or cfg.mg.enabled
                      or cfg.solver.solver != "cg"):
        # tpuqcd/utils/config.py:312-318
        raise ConfigError("action.mu_list (multishift mass sweep) supports the plain "
                          "twisted-mass operator with solver: cg — unset csw/epsbar/mg or drop "
                          "mu_list (a mesh is fine: the sweep runs through the sharded fine "
                          "level)")
    _validate_mesh(cfg.mesh, dims, cfg.solver.comm_policy)
    if cfg.mg.enabled:
        _validate_mg_mesh(cfg.mg, cfg.mesh, dims)


def _validate_mg_mesh(mg: MGParamsCfg, mesh: MeshParams, dims) -> None:
    """tpuqcd's sharded-MG check: the fine aggregates stay shard-local, so
    the first block divides every local extent that is split."""
    if mesh.nt * mesh.nz * mesh.ny == 1:
        return
    _, ly, lz, lt = dims
    bt, bz, by, _ = mg.block[0]
    for name, extent, n, b in (("T", lt, mesh.nt, bt), ("Z", lz, mesh.nz, bz),
                               ("Y", ly, mesh.ny, by)):
        if n > 1 and (extent // n) % b:
            raise ConfigError(f"sharded MG needs the local {name} extent {extent // n} "
                              f"divisible by the {name.lower()}-block {b} (aggregates must "
                              f"stay shard-local)")


def _validate_physics(ph: PhysicsParams, dims) -> None:
    """tpuqcd's physics checks (utils/config.py:270-277, :365-385)."""
    from ..gammas import MESON_CHANNELS, PROJECTORS
    lx, ly, lz, lt = dims
    bad = [c for c in ph.meson_channels if c not in MESON_CHANNELS]
    if bad:
        raise ConfigError(f"physics.meson_channels: unknown {bad!r}; known: "
                          f"{sorted(MESON_CHANNELS)}")
    if ph.smear_type not in ("ape", "stout"):
        raise ConfigError(f"physics.smear_type must be ape | stout, got {ph.smear_type!r}")
    if len(ph.sink_momentum) != 3:
        raise ConfigError(f"physics.sink_momentum must be a 3-vector, got {ph.sink_momentum}")
    for b in ph.baryons:
        if b not in ("proton", "neutron"):
            raise ConfigError(f"physics.baryons entries must be proton | neutron, got {b!r}")
    for pos in ph.source_positions:
        if len(pos) != 4:
            raise ConfigError(f"physics.source_positions entries must be (t, z, y, x), "
                              f"got {pos}")
        t, z, y, x = pos
        if not (0 <= t < lt and 0 <= z < lz and 0 <= y < ly and 0 <= x < lx):
            raise ConfigError(f"source position {pos} (t,z,y,x) outside lattice (T,Z,Y,X) = "
                              f"{(lt, lz, ly, lx)}")
    for ts in ph.t_sinks:
        if not 0 <= ts < lt:
            raise ConfigError(f"physics.t_sinks entry {ts} outside 0..{lt - 1}")
    for q in ph.momenta:
        if len(q) != 3:
            raise ConfigError(f"physics.momenta entries must be 3-vectors, got {q}")
    for p in ph.projectors:
        if p not in PROJECTORS:
            raise ConfigError(f"physics.projectors entries must be one of "
                              f"{sorted(PROJECTORS)}, got {p!r}")
    if ph.tsm_cheap < 0 or ph.n_deflate < 0 or ph.n_noise <= 0:
        raise ConfigError(f"physics noise counts must be sane: n_noise {ph.n_noise} > 0, "
                          f"tsm_cheap {ph.tsm_cheap} >= 0, n_deflate {ph.n_deflate} >= 0")
    if not 1 <= ph.dilute_t <= lt:
        raise ConfigError(f"physics.dilute_t must be in 1..Lt = {lt}, got {ph.dilute_t}")


def _validate_mesh(mesh: MeshParams, dims, comm_policy: str) -> None:
    """tpuqcd's mesh checks: every split extent divides and stays even
    (the eo masks are per shard); ny > 1 needs the overlap engine."""
    nt, nz, ny = mesh.nt, mesh.nz, mesh.ny
    _, ly, lz, lt = dims
    if nt < 1 or nz < 1 or ny < 1:
        raise ConfigError(f"mesh.nt/nz/ny must be >= 1, got ({nt}, {nz}, {ny})")
    if nt * nz * ny == 1:
        return
    if lt % nt or (lt // nt) % 2:
        raise ConfigError(f"mesh.nt = {nt} must divide Lt = {lt} with an even local extent "
                          f"(eo parity masks are per-shard)")
    if lz % nz or (nz > 1 and (lz // nz) % 2):
        raise ConfigError(f"mesh.nz = {nz} must divide Lz = {lz} with an even local extent")
    if ly % ny or (ny > 1 and (ly // ny) % 2):
        raise ConfigError(f"mesh.ny = {ny} must divide Ly = {ly} with an even local extent")
    if ny > 1 and comm_policy == "fused":
        raise ConfigError("mesh.ny > 1 needs the interior/exterior overlap engine: set "
                          "solver.comm_policy to overlap or auto (there is no fused halo_y "
                          "kernel mode)")


def _validate_mg(mg: MGParamsCfg, dims) -> None:
    """tpuqcd's MG checks: one block per n_vec entry, each block
    dividing its level's extents, an even x block on the fine level."""
    if len(mg.n_vec) != len(mg.block):
        raise ConfigError(f"mg.n_vec ({len(mg.n_vec)} entries) and mg.block "
                          f"({len(mg.block)} entries) must list one entry per "
                          f"coarsening level")
    lx, ly, lz, lt = dims
    ds = [lt, lz, ly, lx]                   # (T, Z, Y, X) extents per level
    for depth, blk in enumerate(mg.block):
        if len(blk) != 4:
            raise ConfigError(f"mg.block[{depth}] must be (bt, bz, by, bx), got {blk}")
        if depth == 0 and blk[3] % 2:
            raise ConfigError(f"mg.block[0] x-extent must be even (eo packing), "
                              f"got bx={blk[3]}")
        for name, d, b in zip("tzyx", ds, blk):
            if b <= 0 or d % b:
                raise ConfigError(f"mg.block[{depth}] {name}-extent {b} must divide the "
                                  f"level-{depth} lattice extent {d} (lattice {dims}, "
                                  f"blocks {mg.block})")
        ds = [d // b for d, b in zip(ds, blk)]
    if any(nv <= 0 for nv in mg.n_vec):
        raise ConfigError(f"mg.n_vec entries must be positive, got {mg.n_vec}")


def _apply_mg_preset(raw_mg: dict) -> dict:
    """Merge a named preset under the explicit mg keys."""
    preset = (raw_mg or {}).get("preset")
    if not preset:
        return raw_mg
    if preset not in MG_PRESETS:
        raise ConfigError(f"unknown mg.preset {preset!r}; known: {sorted(MG_PRESETS)}")
    return {**MG_PRESETS[preset], **raw_mg}


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
                    mg=_build(MGParamsCfg, _apply_mg_preset(raw.get("mg"))),
                    physics=_build(PhysicsParams, raw.get("physics")),
                    mesh=_build(MeshParams, raw.get("mesh")))
    if cfg.physics.mom_max_sq is not None:
        q2 = int(cfg.physics.mom_max_sq)
        if q2 < 0:
            raise ConfigError(f"physics.mom_max_sq must be >= 0, got {q2}")
        if (raw.get("physics") or {}).get("momenta") is not None:
            raise ConfigError("physics.momenta and physics.mom_max_sq are exclusive")
        r = range(-int(q2 ** 0.5), int(q2 ** 0.5) + 1)
        moms = tuple((nx, ny, nz) for nx in r for ny in r for nz in r
                     if nx * nx + ny * ny + nz * nz <= q2)
        cfg = dataclasses.replace(cfg, physics=dataclasses.replace(cfg.physics, momenta=moms))
    validate_config(cfg)
    return cfg


def load_config(path: str) -> RunConfig:
    import yaml
    with open(path) as f:
        return config_from_dict(yaml.safe_load(f) or {})
