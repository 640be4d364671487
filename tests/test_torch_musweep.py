"""The port's quark-mass sweep (action.mu_list) against tpuqcd on the CPU,
at 4^3x8 with a numpy-seeded gauge and source handed to both packages:
multishift CG on the same normal operator, solve_tm_musweep on tpuqcd's
unsorted mu_list, the certified masses, the reference fault that tpuqcd
leaves its sweep uncertified (ROADMAP.md, Queue 3), the configuration
gate and run_invert's CLI.

Tolerances: shifted residuals < 2e-5 at tol 1e-6 (tpuqcd's
tests/test_multishift_stout.py:19-37); the multishift x_i within 1e-4
relative of tpuqcd's (float32 sums in another order); certified x_i
within 1e-7 relative of a cold solve_tm (both certified to 1e-10).
Cost: about 45 s serial, most of it tpuqcd's XLA compiles."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tpuqcd.operators import PackedTMOperatorPC as JPackedTMOperatorPC
from tpuqcd.solve import full_system_relres as j_full_system_relres
from tpuqcd.solve import solve_tm_musweep as j_solve_tm_musweep
from tpuqcd.solvers.multishift import multishift_cg as j_multishift_cg
from tpuqcd.utils.config import ConfigError as JConfigError, load_config as j_load_config

from tpuqcd_torch.cli import run_invert
from tpuqcd_torch.cli.common import check_in_slice
from tpuqcd_torch.operators import PackedTMOperatorPC
from tpuqcd_torch.solve import (certify_musweep, full_system_relres, solve_tm,
                                solve_tm_musweep)
from tpuqcd_torch.solvers.multishift import multishift_cg
from tpuqcd_torch.solvers.reductions import norm2
from tpuqcd_torch.utils.config import ConfigError, config_from_dict, load_config

from _torch_inputs import gauge_full, jax_gauge_pk, lattices, n, spinor_pk, t

LAT, JLAT = lattices((4, 4, 4, 8))
KAPPA = 0.115
#: tpuqcd's sweep test's masses, deliberately unsorted
MU_LIST = (0.2, 0.05, 0.1)
ROOT = Path(__file__).resolve().parents[1]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def problem():
    """A float32-valued gauge (as the CLI makes it) and a two-parity source."""
    u = jax_gauge_pk(gauge_full(LAT, 60), JLAT, True, jnp.float32)
    return u, jnp.asarray(spinor_pk(LAT, 61, parities=2), jnp.float32)


@pytest.fixture(scope="module")
def sweeps(problem):
    """tpuqcd's sweep and the port's, then the port's certification, at
    the stage tolerance 1e-8 of tpuqcd's test."""
    u, b = problem
    j_xs, j_rel, j_iters = j_solve_tm_musweep(u, b, JLAT, kappa=KAPPA, mu_list=MU_LIST,
                                              tol=1e-8, maxiter=2000, backend="xla")
    xs, rel, iters = solve_tm_musweep(t(u), t(b), LAT, kappa=KAPPA, mu_list=MU_LIST, tol=1e-8,
                                      maxiter=2000)
    certs = certify_musweep(t(u), t(b), LAT, xs, kappa=KAPPA, mu_list=MU_LIST, tol=1e-10)
    return dict(j=(np.asarray(j_xs), [float(r) for r in j_rel], int(j_iters)),
                port=(xs, rel, iters), certs=certs)


def test_multishift_cg_matches_tpuqcd(problem):
    """The same normal operator and shifts: every shifted system solved
    from one Krylov space, x_i as tpuqcd's."""
    u, _ = problem
    kappa, mu, shifts = 0.115, 0.08, [0.0, 0.05, 0.2]
    b = spinor_pk(LAT, 62).astype(np.float32)
    jpc = JPackedTMOperatorPC(JLAT, kappa=kappa, mu=mu, backend="xla")
    want = j_multishift_cg(lambda x: jpc.apply_dagger(u, jpc.apply(u, x)), jnp.asarray(b),
                           shifts, tol=1e-6, maxiter=600)
    pc, ut = PackedTMOperatorPC(LAT, kappa=kappa, mu=mu), t(u)

    def normal(x):
        return pc.normal(ut, x)
    got = multishift_cg(normal, t(b), shifts, tol=1e-6, maxiter=600)
    assert got.xs.shape == (3, *b.shape) and got.xs.dtype == torch.float32
    assert got.relres.dtype == torch.float64 and got.iters == int(want.iters)
    for i, s in enumerate(shifts):
        r = t(b) - (normal(got.xs[i]) + s * got.xs[i])
        assert (norm2(r) / norm2(t(b))).sqrt().item() < 2e-5, (i, s)
        assert _rel(n(got.xs[i]), want.xs[i]) <= 1e-4, (i, s)
    np.testing.assert_allclose(got.relres.numpy(), np.asarray(want.relres), rtol=1e-2)


def test_solve_tm_musweep_matches_tpuqcd(sweeps):
    (j_xs, j_rel, j_iters), (xs, rel, iters) = sweeps["j"], sweeps["port"]
    assert xs.shape == (3, 2, 2, 4, 3, *LAT.site_shape) and xs.dtype == torch.float32
    assert abs(iters - j_iters) <= 2, (iters, j_iters)
    for i, mu in enumerate(MU_LIST):
        assert _rel(n(xs[i]), j_xs[i]) <= 1e-4, mu
        # tpuqcd's test's own limit on its uncertified stage
        assert rel[i] < 5e-6 and j_rel[i] < 5e-6, (mu, rel[i], j_rel[i])


def test_certified_sweep_against_cold_solves(problem, sweeps):
    """Each mass certified to 1e-10 by the solver, by the port's float64
    operator and by tpuqcd's; within 1e-7 of a cold solve_tm at that mass,
    which takes more sloppy matvecs than the warm-started certification."""
    u, b = problem
    for i, (mu, cert) in enumerate(zip(MU_LIST, sweeps["certs"])):
        assert cert.relres <= 1e-10 and cert.x.dtype == torch.float64
        assert full_system_relres(t(u), t(b), cert.x, LAT, kappa=KAPPA, mu=mu) <= 1e-10
        assert j_full_system_relres(u.astype(jnp.float64), b.astype(jnp.float64),
                                    jnp.asarray(n(cert.x)), JLAT, kappa=KAPPA, mu=mu) <= 1e-10
        cold = solve_tm(t(u), t(b), LAT, kappa=KAPPA, mu=mu, tol=1e-10)
        assert _rel(n(cert.x), n(cold.x)) <= 1e-7, mu
        assert 0 < cert.refinements and cert.iters < cold.iters, (mu, cert.iters, cold.iters)


def test_tpuqcd_sweep_misses_its_tolerance_the_port_certifies(problem):
    """ROADMAP.md Queue 3: tpuqcd's sweep asked for 1e-10 returns the
    float32 x_i, whose float64 residuals stay above it; the port's
    certified sweep meets it for every mass."""
    u, b = problem
    _, j_rel, _ = j_solve_tm_musweep(u, b, JLAT, kappa=KAPPA, mu_list=MU_LIST, tol=1e-10,
                                     maxiter=2000, backend="xla")
    assert max(float(r) for r in j_rel) > 1e-10
    xs, rel, _ = solve_tm_musweep(t(u), t(b), LAT, kappa=KAPPA, mu_list=MU_LIST, tol=1e-5)
    assert min(rel) > 1e-10
    certs = certify_musweep(t(u), t(b), LAT, xs, kappa=KAPPA, mu_list=MU_LIST, tol=1e-10)
    assert all(full_system_relres(t(u), t(b), c.x, LAT, kappa=KAPPA, mu=mu) <= 1e-10
               for c, mu in zip(certs, MU_LIST))


def test_a_mass_and_its_negative_share_a_shift_not_a_solution(problem):
    u, b = problem
    mus = (0.1, -0.1)
    xs, rel, _ = solve_tm_musweep(t(u), t(b), LAT, kappa=KAPPA, mu_list=mus, tol=1e-6)
    assert max(rel) < 1e-5 and _rel(n(xs[0]), n(xs[1])) > 1e-2
    for x, mu in zip(xs, mus):
        assert full_system_relres(t(u), t(b), x, LAT, kappa=KAPPA, mu=mu) < 1e-5


GATE = {"csw": {"action": {"csw": 1.0}}, "epsbar": {"action": {"epsbar": 0.1, "mubar": 0.2}},
        "mg": {"mg": {"enabled": True}}, "bicgstab": {"solver": {"solver": "bicgstab"}},
        "eigcg": {"solver": {"solver": "eigcg"}}, "mesh": {"mesh": {"nt": 2}},
        "mesh-y": {"mesh": {"ny": 2}, "solver": {"comm_policy": "overlap"}}, "plain": {}}


@pytest.mark.parametrize("name", list(GATE))
def test_config_gate_mirrors_tpuqcd(name, tmp_path):
    """mu_list runs with the plain twisted-mass operator and solver cg
    only, on one device or a mesh, in both packages."""
    raw = {"gauge": {"dims": [8, 8, 8, 16]}, "action": {"mu_list": [0.05, 0.1]}}
    for key, val in GATE[name].items():
        raw[key] = {**raw.get(key, {}), **val}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(raw))
    if name.startswith("mesh") or name == "plain":
        cfg, jcfg = load_config(str(path)), j_load_config(str(path))
        assert tuple(cfg.action.mu_list) == tuple(jcfg.action.mu_list) == (0.05, 0.1)
        check_in_slice(cfg)
        return
    with pytest.raises(JConfigError, match="mu_list"):
        j_load_config(str(path))
    with pytest.raises(ConfigError, match="mu_list"):
        config_from_dict(raw)


def test_run_invert_musweep_cli_cpu(capsys, tmp_path):
    """The RESULT line and the InvertResult's sweep fields."""
    raw = {"gauge": {"dims": list(LAT.dims), "random_seed": 3},
           "action": {"kappa": KAPPA, "mu": 0.05, "mu_list": list(MU_LIST)},
           "solver": {"tol": 1e-10, "inner_tol": 1e-5}}
    path = tmp_path / "sweep.yaml"
    path.write_text(yaml.safe_dump(raw))
    run_invert.main(["--config", str(path), "--device", "cpu"])
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("RESULT ")]
    assert len(line) == 1
    f = dict(kv.split("=", 1) for kv in re.findall(r"\w+=\S+", line[0]))
    assert [float(m) for m in f["mu"].split(",")] == list(MU_LIST)
    assert all(float(r) <= 1e-10 for r in f["relres"].split(","))
    assert len(f["refine_iters"].split(",")) == 3 and int(f["multishift_iters"]) > 0
    assert float(f["solve_seconds"]) > 0

    cfg = config_from_dict(raw)
    res = run_invert.invert(cfg, torch.device("cpu"))
    sw = res.sweep
    assert sw.mu_list == MU_LIST and sw.xs.shape == (3, 2, 2, 4, 3, *LAT.site_shape)
    assert sw.xs.dtype == torch.float64 and max(sw.relres) <= 1e-10
    assert max(sw.solver_relres) <= 1e-10 and min(sw.multishift_relres) > 1e-10
    assert max(sw.multishift_relres) < 1e-4
    assert res.iters == sw.multishift_iters and res.refinements == sum(sw.refinements)
    assert res.relres == max(sw.relres) and torch.equal(res.x, sw.xs[0])
    assert set(sw.seconds) == {"multishift", "refinement", "total"}
    for x, mu, rel in zip(sw.xs, MU_LIST, sw.relres):
        assert full_system_relres(res.u_pk, res.b_pk, x, LAT, kappa=KAPPA, mu=mu) == rel
