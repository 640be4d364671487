"""The three-point slice of the port as a whole against tpuqcd: the run
of examples/threep.yaml (2x2x2x4; projectors P+ and P5z; proton and
neutron; t_sink 2; Gaussian smearing 1.0 x 2), its HDF5 file, the CLI
and its refusals.

tpuqcd's side is its own run function, tpuqcd.cli.run_threeptwop._measure
(the host contraction path: two-point function, sequential sources,
flavor-flipped backward solves, insertions, writers), on a numpy gauge
that both packages get, with three stand-ins for speed: the solver is the
exact inverse of tpuqcd's full-lattice TMOperator (utils/dense.py, as
tests/test_threep.py solves), and the full-layout source and sink
smearings go through tpuqcd's packed sink_smear_prop_pk (about 10 s a
call otherwise; tests/test_threep_dev.py holds the two equal).  The
port's side is run_threeptwop.measure on the CPU with its own CG solver
(certified to examples/threep.yaml's 1e-8).  Every dataset of tpuqcd's
file, in every group, agrees with the port's within rtol 1e-4 and atol
1e-4 of the largest value of its dataset: float32 propagators on both
sides, one side solved exactly and the other to 1e-8.  Serial cost about
40 s (2 torch threads)."""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd.cli import run_threeptwop as j_run
from tpuqcd.fields import apply_boundary_phase as j_apply_boundary_phase
from tpuqcd.fields import eo_to_full as j_eo_to_full, gauge_full_to_eo as j_gauge_full_to_eo
from tpuqcd.operators import TMOperator
from tpuqcd.ops.layout import gauge_to_device as j_gauge_to_device
from tpuqcd.phys import contract_dev as jdev
from tpuqcd.phys import propagator as jprop
from tpuqcd.utils.config import load_config as j_load_config
from tpuqcd.utils.dense import all_to_all_propagator
from tpuqcd.utils.packed import pack_gauge as j_pack_gauge

from tpuqcd_torch.cli import run_threeptwop
from tpuqcd_torch.cli.common import Gauge, check_in_slice
from tpuqcd_torch.io import hdf5io
from tpuqcd_torch.ops.gauge_tools import plaquette
from tpuqcd_torch.solve import full_system_relres
from tpuqcd_torch.utils.config import ConfigError, config_from_dict, load_config
from tpuqcd_torch.utils.packed import unpack_gauge

from _torch_inputs import gauge_full, jax_gauge_pk, lattices, t

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = str(ROOT / "examples/threep.yaml")
LAT, JLAT = lattices((2, 2, 2, 4))
TAG = "sx0sy0sz0st0"
h5py = pytest.importorskip("h5py")


class _DenseSolve:
    """tpuqcd's solve(b_full, flavor) by the exact inverse of its TMOperator."""
    lmesh = None

    def __init__(self, cfg, u_full):
        self.inv = {}
        for flavor in (+1, -1):
            m = TMOperator(JLAT, kappa=cfg.action.kappa, mu=cfg.action.mu, flavor=flavor)
            ap = jax.jit(lambda v, m=m: m.apply(u_full, v.reshape(*JLAT.full_shape, 4, 3))
                         .reshape(*JLAT.full_shape, 12))
            self.inv[flavor] = all_to_all_propagator(ap, JLAT).reshape(12 * JLAT.volume, -1)

    def __call__(self, b, flavor=+1):
        x = self.inv[flavor] @ np.asarray(b, np.complex128).reshape(-1)
        return jnp.asarray(x.reshape(*JLAT.full_shape, 4, 3).astype(np.complex64))


def _smear_full(u_sm, prop, lat, alpha, n_steps):
    """tpuqcd's sink_smear_propagator by its packed sink_smear_prop_pk."""
    pk = jprop.sink_smear_prop_pk(j_pack_gauge(u_sm), jdev.prop_to_device(prop, lat), lat,
                                  alpha, n_steps)
    c = (pk[0] + 1j * pk[1]).reshape(2, 4, 3, 4, 3, lat.Lt, lat.Lz, lat.Ly, lat.Lx // 2)
    return j_eo_to_full(jnp.moveaxis(c, (1, 2, 3, 4), (5, 6, 7, 8)), lat)


def _smear_sources(u_sm, srcs, lat, alpha, n_steps):
    """tpuqcd's smear_sources: the 12 sources as the columns of a propagator."""
    prop = jnp.transpose(srcs, (2, 3, 4, 5, 6, 7, 0, 1))
    return jnp.transpose(_smear_full(u_sm, prop, lat, alpha, n_steps), (6, 7, 0, 1, 2, 3, 4, 5))


def _read_all(path) -> dict:
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda k, v: out.__setitem__(k, v[()]) if isinstance(v, h5py.Dataset)
                     else None)
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(tpuqcd's datasets by name, the port's ThreepResult, cfg, the
    audit's (flavor, independent residual) of every column)."""
    tmp = tmp_path_factory.mktemp("threep")
    jcfg = j_load_config(EXAMPLE)
    jcfg = dataclasses.replace(jcfg, physics=dataclasses.replace(
        jcfg.physics, output=str(tmp / "ref.h5")))
    u_np = gauge_full(LAT, 3)
    u_full = j_apply_boundary_phase(jnp.asarray(u_np.astype(np.complex64)), JLAT)
    u_dev = j_gauge_to_device(j_gauge_full_to_eo(u_full, JLAT), JLAT)
    gauge = (JLAT, u_full, j_pack_gauge(u_dev), u_dev)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("TPUQCD_DEVICE_CONTRACT", raising=False)     # tpuqcd's host path
        mp.setattr(j_run, "setup_gauge", lambda cfg: gauge)
        mp.setattr(j_run, "make_solver", lambda cfg, lat, u_pk, u: _DenseSolve(cfg, u_full))
        mp.setattr(jprop, "smear_sources", _smear_sources)
        mp.setattr(jprop, "sink_smear_propagator", _smear_full)
        j_run._measure(jcfg)
    ref = _read_all(jcfg.physics.output)
    # the port: the same gauge through run_threeptwop.measure on the CPU
    cfg = load_config(EXAMPLE)
    cfg = dataclasses.replace(cfg, physics=dataclasses.replace(cfg.physics,
                                                               output=str(tmp / "port.h5")))
    tu = t(jax_gauge_pk(u_np, JLAT, True, jnp.float32))
    plaq = plaquette(unpack_gauge(t(jax_gauge_pk(u_np, JLAT, False, jnp.float32))), LAT)
    audited = []

    def audit(b, x, flavor):
        audited.extend((flavor, full_system_relres(tu, b[i], x[i], LAT, kappa=cfg.action.kappa,
                                                   mu=cfg.action.mu, flavor=flavor))
                       for i in range(b.shape[0]))
    res = run_threeptwop.measure(cfg, torch.device("cpu"), Gauge(LAT, tu, plaq, 0.0),
                                 keep_fields=True, audit=audit)
    return ref, res, cfg, audited


def _port_datasets(res) -> dict:
    out = {}
    for group, corr in res.twop.items():
        for i, p in enumerate(res.momenta):
            out[f"{group}/mom_{p[0]}_{p[1]}_{p[2]}"] = corr[i]
    for group, ins in res.threep.items():
        for name, corr in ins.items():
            for i, p in enumerate(res.momenta):
                out[f"{group}/{name}/mom_{p[0]}_{p[1]}_{p[2]}"] = corr[i]
    return out


@pytest.mark.parametrize("kind", ["twop", "threep", "threep_der"])
@pytest.mark.parametrize("baryon", ["proton", "neutron"])
def test_every_dataset_matches_tpuqcd(both, baryon, kind):
    ref, res, cfg, _ = both
    got = _port_datasets(res)
    names = sorted(k for k in ref if k.startswith(f"{kind}/{baryon}/"))
    per_group = 1 if kind == "twop" else 2 * 16           # two legs, 16 insertions
    assert len(names) == len(cfg.physics.projectors) * per_group
    assert sorted(k for k in got if k.startswith(f"{kind}/{baryon}/")) == names
    for name in names:
        want = ref[name]
        assert got[name].shape == want.shape == (LAT.Lt,) and np.isfinite(got[name]).all()
        np.testing.assert_allclose(got[name], want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)


def test_proton_vector_charges_are_about_two_and_one():
    """An oracle-free check at 4x4x4x8 (random gauge, heavy quarks, t_sink 4):
    the proton's gt insertion at p = 0 counts the u quarks of its u leg and
    the d quark of its d leg, so on the timeslices between source and sink
    the ratio u / d is about 2 (2.13-2.19 on this gauge: the local current
    is not the conserved one, and the excited states of a random gauge are
    not suppressed).  About 6 s."""
    cfg = config_from_dict({"gauge": {"dims": [4, 4, 4, 8], "random_seed": 2},
                            "action": {"kappa": 0.115, "mu": 0.08}, "solver": {"tol": 1e-8},
                            "physics": {"t_sinks": [4], "smear_n_ape": 0, "smear_n_gauss": 2,
                                        "smear_alpha_gauss": 1.0}})
    res = run_threeptwop.measure(cfg, torch.device("cpu"))
    u, d = (res.threep[f"threep/proton/P+/{q}/ts4/{TAG}"]["gt"][0] for q in ("u", "d"))
    ratio = (u / d)[1:4]
    assert np.all((1.8 < ratio.real) & (ratio.real < 2.4)) and np.abs(ratio.imag).max() < 0.1


def test_every_column_is_certified_and_timed(both):
    """By the solver, and by an independent float64 residual of every
    column's solution before its float32 rounding (Solver.audit)."""
    _, res, cfg, audited = both
    # rhs_batch 12 with the gate: a probe column, then the other 11, per call
    assert [(r["first_column"], r["columns"]) for r in res.solves] == [(0, 1), (1, 11)] * 10
    assert sum(r["columns"] for r in res.solves) == 24 + 96
    assert all(max(r["relres"]) <= cfg.solver.tol for r in res.solves)
    # forward u, d; then per baryon, projector and leg the flipped flavor of
    # the leg's physical quark (proton u, d; neutron: engine u is the d quark)
    flavors = [r["flavor"] for r in res.solves[::2]]
    assert flavors == [1, -1] + [-1, 1] * 2 + [1, -1] * 2
    assert len(audited) == 120 and max(r for _, r in audited) <= cfg.solver.tol
    assert [f for f, _ in audited] == [f for r in res.solves for f in [r["flavor"]] * r["columns"]]
    # keep_fields: the forward sources and unsmeared propagators, each call's first solution
    f = res.fields[TAG]
    assert f["b"].shape == (12, 2, 2, 4, 3, *LAT.site_shape)
    assert f["u"].shape == f["d"].shape == (2, 2, 4, 3, 4, 3, *LAT.site_shape)
    for rec in res.solves[:4]:
        rel = full_system_relres(res.u_pk, f["b"][rec["first_column"]], rec["x_first"], LAT,
                                 kappa=cfg.action.kappa, mu=cfg.action.mu, flavor=rec["flavor"])
        assert rec["x_first"].dtype == torch.float64 and rel <= cfg.solver.tol
    assert set(res.seconds) == {"gauge", "smearing", "sources", "solves_u", "solves_d",
                                "sink_smearing", "contractions", "projection", "seq_sources",
                                "seq_smearing", "solves_bwd", "insertions", "derivatives"}


def test_write_gives_tpuqcd_file_layout(both):
    ref, res, cfg, _ = both
    run_threeptwop.write(cfg, res)
    mine = _read_all(cfg.physics.output)
    assert sorted(mine) == sorted(ref)
    for name, want in mine.items():
        np.testing.assert_array_equal(want, _port_datasets(res)[name])
    group = f"threep_der/neutron/P5z/u/ts2/{TAG}"
    with h5py.File(cfg.physics.output, "r") as f:
        attrs = dict(f[group].attrs)
        assert sorted(f[group]) == sorted(f"der_g{m}_D{n}" for m in range(4) for n in range(4))
    assert attrs["t_sink"] == 2 and list(attrs["src_pos"]) == [0, 0, 0, 0]
    assert list(attrs["sink_momentum"]) == [0, 0, 0]


def test_run_threeptwop_cli_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run_threeptwop.main(["--config", EXAMPLE, "--device", "cpu"])
    names = _read_all("threep_demo.h5")
    for kind, count in (("twop", 4), ("threep", 4 * 2 * 16), ("threep_der", 4 * 2 * 16)):
        assert sum(k.startswith(f"{kind}/") for k in names) == count, kind


def test_cli_runs_on_cuda_by_default_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_threeptwop.main(["--config", EXAMPLE])


def test_a_run_without_t_sinks_is_refused():
    cfg = config_from_dict({"gauge": {"dims": [2, 2, 2, 4]}, "physics": {"t_sinks": []}})
    check_in_slice(cfg)                                   # the two-point run takes it
    with pytest.raises(ConfigError, match="t_sinks"):
        check_in_slice(cfg, threep=True)
    with pytest.raises(ConfigError, match="t_sinks"):
        run_threeptwop.measure(cfg, torch.device("cpu"))
