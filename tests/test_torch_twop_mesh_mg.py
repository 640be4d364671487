"""run_twop on a mesh, continued from tests/test_torch_twop_mesh.py: the
multigrid case of tpuqcd's test_twop_mesh_mg_tiny (its lattice, action,
tolerance, physics and hierarchy, tests/test_cli_mesh_fast.py:17-27 and
61-80) on 2 gloo ranks over t against the port's one-rank MG run, within
1e-5 of each dataset's largest value; and measure on a one-rank mesh with
LatticeMesh.all_gather and gather raising (on one rank they would return
their input), equal to the one-card run.  Cost: about 50 s serial (one
torchrun launch, 40 s: the sharded V-cycle a column at a time)."""
import numpy as np
import torch

from tpuqcd_torch.cli import run_twop
from tpuqcd_torch.cli.common import setup_gauge
from tpuqcd_torch.parallel.mesh import LatticeMesh
from tpuqcd_torch.solve import full_system_relres
from tpuqcd_torch.utils.config import load_config

from _torch_twop_mesh import CPU, TWOP_RAW, _yaml, assert_runs_agree, h5_all, one_rank, \
    run_mesh

#: tpuqcd's test_twop_mesh_mg_tiny: its lattice, action, tolerance, physics
#: and hierarchy
MG_RAW = {
    "gauge": {"dims": [2, 2, 2, 4], "random_seed": 3},
    "action": {"kappa": 0.11, "mu": 0.07},
    "solver": {"tol": 1.0e-7, "backend": "xla"},
    "physics": {"source_positions": [[0, 0, 0, 0]], "momenta": [[0, 0, 0]], "smear_n_ape": 0,
                "smear_n_gauss": 1, "smear_alpha_gauss": 1.0, "projectors": ["P+"]},
    "mg": {"enabled": True, "n_vec": [2], "block": [[2, 2, 2, 2]], "setup_iters": 4,
           "smoother_iters": 2, "coarse_maxiter": 4},
}


def test_twop_mesh_mg_tiny(tmp_path):
    """The sharded MG solver in the two-point pipeline (2 ranks over t)
    equals the one-rank MG run, as tpuqcd's test of the same name holds
    its mesh run to its single-device run."""
    out = run_mesh(tmp_path, (2, 1, 1), "run_twop", MG_RAW)
    assert_runs_agree(out["h5"], one_rank(tmp_path, MG_RAW))
    assert all(r["relres"].max() <= 1e-7 and r["columns"].sum() == 24 for r in out["ranks"])


def test_the_mesh_path_gathers_no_field(monkeypatch, tmp_path):
    """The torchrun runs refuse every gather (the worker's forbid_gathers);
    here measure on a one-rank mesh, whose gathers would return their
    input, runs with them raising and equals the one-card run
    (tests/test_torch_twop_mesh.py's physics at 2x2x2x4, tol 1e-10, the
    source at (3, 1, 1, 1)).  The audit and keep_first see the rank's
    blocks (here the whole lattice): every column's float64 solution holds
    1e-10 by the plain operator."""
    raw = {**TWOP_RAW, "gauge": {"dims": [2, 2, 2, 4], "random_seed": 5},
           "physics": {**TWOP_RAW["physics"], "source_positions": [[3, 1, 1, 1]]}}
    want = one_rank(tmp_path, raw)

    def refuse(*args, **kwargs):
        raise AssertionError("a field was gathered on the mesh path")
    monkeypatch.setattr(LatticeMesh, "all_gather", refuse)
    monkeypatch.setattr(LatticeMesh, "gather", refuse)
    cfg = load_config(_yaml(tmp_path / "cfg.yaml", raw, tmp_path / "m.h5"))
    gauge, audited = setup_gauge(cfg, CPU), []

    def audit(b, x, flavor):
        audited.extend(full_system_relres(gauge.u_pk.double(), bi.double(), xi, gauge.lat,
                                          kappa=cfg.action.kappa, mu=cfg.action.mu,
                                          flavor=flavor) for bi, xi in zip(b, x))
    lat = gauge.lat
    res = run_twop.measure(cfg, CPU, gauge, keep_fields=True, audit=audit,
                           lmesh=LatticeMesh(lat, 1))
    run_twop.write(cfg, res)
    assert all(max(r["relres"]) <= 1e-10 for r in res.solves)
    assert [r["columns"] for r in res.solves] == [1] * 24    # the mesh path, a column a call
    assert len(audited) == 24 and max(audited) <= 1e-10
    assert res.solves[0]["x_first"].shape == (2, 2, 4, 3, *lat.site_shape)
    assert_runs_agree(h5_all(tmp_path / "m.h5"), want)
    assert np.isfinite(np.concatenate([v.ravel() for v in want.values()])).all()
