"""The port's certified solve and its CLI, on the CPU (plain Dslash).

Each solution is checked with tpuqcd's float64 operator as in
test_solve.py: full two-parity |b - M x| / |b| < 1e-9 for a solve to
1e-10 on the preconditioned system."""
import glob
import os
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd.ops.dslash_xla import dslash_eo_dev_ri
from tpuqcd.operators import twist_apply_pk
from tpuqcd.solve import full_system_relres as j_full_system_relres
from tpuqcd.solvers.reductions import norm2 as j_norm2
from tpuqcd.utils.profile import solve_flops as j_solve_flops

from tpuqcd_torch.cli import run_invert
from tpuqcd_torch.cli.common import check_in_slice, resolve_device
from tpuqcd_torch.solve import full_system_relres, solve_tm
from tpuqcd_torch.solvers.cg import cg, cg_normal
from tpuqcd_torch.solvers.reductions import cdot, norm2, redot
from tpuqcd_torch.utils.config import config_from_dict, load_config
from tpuqcd_torch.utils.profile import solve_flops

from _torch_inputs import gauge_full, jax_gauge_pk, lattices, n, spinor_pk, t

LAT, JLAT = lattices((4, 4, 4, 8))
KAPPA, MU = 0.115, 0.08
ROOT = Path(__file__).resolve().parents[1]


def _problem(antiperiodic_t=True):
    # a float32 gauge, as the CLI makes it: exact in the f64 operators
    u = jax_gauge_pk(gauge_full(LAT, 30), JLAT, antiperiodic_t, jnp.float32)
    return u, jnp.asarray(spinor_pk(LAT, 31, parities=2), jnp.float32)


def _tpuqcd_relres(u, b, x):
    """test_solve.py:51-64: the full system through tpuqcd's f64 operator."""
    u64, b64, x = u.astype(jnp.float64), b.astype(jnp.float64), jnp.asarray(n(x))
    re = twist_apply_pk(x[0], KAPPA, MU) - KAPPA * dslash_eo_dev_ri(u64, x[1], 1, JLAT)
    ro = twist_apply_pk(x[1], KAPPA, MU) - KAPPA * dslash_eo_dev_ri(u64, x[0], 0, JLAT)
    num = float(j_norm2(b64[0] - re) + j_norm2(b64[1] - ro))
    return (num / float(j_norm2(b64[0]) + j_norm2(b64[1]))) ** 0.5


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_solve_tm_certified(solver):
    u, b = _problem()
    res = solve_tm(t(u), t(b), LAT, kappa=KAPPA, mu=MU, tol=1e-10, solver=solver)
    assert res.relres < 1e-10 and res.x.dtype == torch.float64
    assert res.x.shape == (2, 2, 4, 3, *LAT.site_shape)
    assert _tpuqcd_relres(u, b, res.x) < 1e-9
    # the port's certification agrees with tpuqcd's full_system_relres
    mine = full_system_relres(t(u), t(b), res.x, LAT, kappa=KAPPA, mu=MU)
    ref = j_full_system_relres(u, b, jnp.asarray(n(res.x)), JLAT, kappa=KAPPA, mu=MU)
    assert mine < 1e-9 and abs(mine - ref) < 1e-13
    # warm start from the solution: nothing left to do
    again = solve_tm(t(u), t(b), LAT, kappa=KAPPA, mu=MU, tol=1e-10, solver=solver,
                     x0_e=res.x[0])
    assert again.iters == 0 and again.relres < 1e-10


def test_solve_tm_bf16_sloppy_and_periodic_links():
    """bf16 storage in the iteration, periodic T links (t_boundary=+1)."""
    u, b = _problem(antiperiodic_t=False)
    res = solve_tm(t(u), t(b), LAT, kappa=KAPPA, mu=MU, tol=1e-10, inner_tol=3e-2,
                   sloppy_dtype=torch.bfloat16, t_boundary=1)
    assert res.relres < 1e-10 and res.refinements > 1
    assert _tpuqcd_relres(u, b, res.x) < 1e-9


def test_solve_tm_refuses_unknown_solver():
    u, b = _problem()
    with pytest.raises(ValueError, match="solver"):
        solve_tm(t(u), t(b), LAT, kappa=KAPPA, mu=MU, solver="gcr")


def test_cg_and_reductions():
    rng = np.random.default_rng(32)
    a = rng.standard_normal((40, 40))
    a = torch.from_numpy(a @ a.T + 40 * np.eye(40))
    x_true = torch.from_numpy(rng.standard_normal(40))
    b = a @ x_true
    res = cg(lambda v: a @ v, b, tol=1e-12, maxiter=500)
    assert res.converged and res.relres <= 1e-12
    torch.testing.assert_close(res.x, x_true, atol=1e-9, rtol=0)
    m = torch.from_numpy(rng.standard_normal((40, 40))) + 10 * torch.eye(40, dtype=torch.float64)
    res = cg_normal(lambda v: m @ v, lambda v: m.T @ v, b, tol=1e-12, maxiter=500)
    assert res.relres <= 1e-11
    z = torch.complex(*torch.from_numpy(rng.standard_normal((2, 7))).to(torch.float32))
    w = torch.complex(*torch.from_numpy(rng.standard_normal((2, 7))).to(torch.float32))
    ref = np.vdot(z.numpy().astype(np.complex128), w.numpy().astype(np.complex128))
    re, im = cdot(z, w)
    assert abs(complex(re, im) - ref) < 1e-12 and abs(redot(z, w) - ref.real) < 1e-12
    assert norm2(z).dtype == torch.float64
    assert abs(norm2(z) - np.vdot(z.numpy(), z.numpy()).real) < 1e-5


def test_solve_flops_matches_tpuqcd():
    assert solve_flops(LAT, 17) == j_solve_flops(JLAT, 17)


def test_run_invert_cli_cpu(capsys):
    run_invert.main(["--config", str(ROOT / "examples/invert.yaml"), "--device", "cpu"])
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("RESULT ")]
    assert len(line) == 1
    fields = dict(kv.split("=", 1) for kv in re.findall(r"\w+=\S+", line[0]))
    assert float(fields["relres"]) <= 1e-10
    assert float(fields["solve_seconds"]) > 0 and float(fields["gflops"]) > 0


@pytest.mark.parametrize("antiperiodic_t,want", [(True, -1), (False, 1)])
def test_run_invert_passes_t_boundary(monkeypatch, antiperiodic_t, want):
    """The CLI hands solve_tm the phase its links carry (tpuqcd's
    run_invert.py:73-79 leaves t_boundary at its default)."""
    seen = {}
    real = run_invert.solve_tm

    def spy(*a, **kw):
        seen["t_boundary"] = kw["t_boundary"]
        return real(*a, **kw)
    monkeypatch.setattr(run_invert, "solve_tm", spy)
    cfg = config_from_dict({"gauge": {"dims": [4, 4, 4, 4], "random_seed": 3,
                                      "antiperiodic_t": antiperiodic_t},
                            "action": {"kappa": KAPPA, "mu": MU}})
    res = run_invert.invert(cfg, torch.device("cpu"))
    assert seen["t_boundary"] == want and res.relres <= 1e-10


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_invert.main(["--config", str(ROOT / "examples/invert.yaml")])


@pytest.mark.parametrize("section,key,value", [
    ("action", "csw", 1.0), ("action", "epsbar", 0.1),
    ("action", "mu_list", [0.01, 0.02]), ("mesh", "nt", 2),
    ("gauge", "config_file", "cfg.lime"),
    ("gauge", "fix", "landau"), ("gauge", "random_seeds", [1, 2]),
    ("gauge", "config_files", ["a.lime", "b.lime"]), ("solver", "solver", "eigcg")])
def test_out_of_slice_config_raises(section, key, value):
    """On a mesh everything, the mass sweep too, is in every program's slice
    since the loop run came to the mesh."""
    raw = {"gauge": {"dims": [4, 4, 4, 8]}, section: {key: value}}
    if section == "gauge":
        raw["gauge"][key] = value
    if key == "csw":    # twisted clover is in the slice, and so is its sharded solve
        raw["mesh"] = {"nt": 2}
    if key == "epsbar":  # the doublet is in the slice, also on a y-sharded mesh
        raw["mesh"] = {"nt": 2, "ny": 2}
    if value == "eigcg" or section == "gauge":
        # eigCG is in the slice since the loop run, the gauge input (ILDG files,
        # ensembles, gauge fixing) since it came; on a mesh both are run_invert's
        check_in_slice(config_from_dict(raw))
        raw["mesh"] = {"nt": 2}
    if key == "mu_list":    # the mass sweep is in the slice, and so is its sharded run
        check_in_slice(config_from_dict(raw))
        raw["mesh"] = {"nt": 2}
    cfg = config_from_dict(raw)
    check_in_slice(cfg)
    assert cfg.mesh.nt * cfg.mesh.nz * cfg.mesh.ny > 1


@pytest.mark.parametrize("path", sorted(glob.glob(str(ROOT / "examples" / "*.yaml"))),
                         ids=os.path.basename)
def test_every_example_config_loads(path):
    cfg = load_config(path)
    assert cfg.solver.backend in ("pallas", "xla")
    if os.path.basename(path) in ("invert.yaml", "invert_mg.yaml", "invert_mg_heatbath.yaml"):
        check_in_slice(cfg)
