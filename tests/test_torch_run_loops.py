"""The loop slice of the port as a whole against tpuqcd: the run of
examples/loops.yaml's lattice (2x2x2x4) plain and with deflation and the
clover term, its HDF5 file, the CLI on both examples and the refusals;
with TSM in test_torch_run_loops_tsm.py.

tpuqcd's side is its own device estimator, tpuqcd.cli.run_loops.
_run_device (reached through its _measure with TPUQCD_DEVICE_CONTRACT=1),
on a numpy gauge that both packages get, with three stand-ins: the port's
Z4 noises (seeds 17 and 23 on torch's stream) in place of tpuqcd's
(loops_dev.z4_noise_pk), the port's Lanczos start vector (seed 9) in
place of tpuqcd's, and an exact solver, the dense inverse of tpuqcd's own
full-lattice operator (its TMOperator, or its twisted clover) on the same
float32 links (tests/_torch_loops_run.py); the port's operator serves
only the audit of the port's columns.  The port's side is run_loops.measure on the
CPU with its own certified solver (tol 1e-8).  Every dataset of tpuqcd's
file agrees with the port's within 1e-4 of the largest value of its
dataset: float32 fields on both sides, one side solved exactly and the
other to 1e-8, float32 Lanczos bases from the same start vector.  Serial
cost about 35 s (2 torch threads), most of it tpuqcd's XLA compiles."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuqcd_torch.cli import run_loops
from tpuqcd_torch.cli.common import check_in_slice, make_solver
from tpuqcd_torch.utils.config import ConfigError, config_from_dict, load_config

from _torch_loops_run import (LAT, check_basis, check_columns_and_stages, check_datasets,
                              raw_config, read_all, run_both)

ROOT = Path(__file__).resolve().parents[1]
h5py = pytest.importorskip("h5py")


@pytest.fixture(scope="module", params=["plain", "clover"])
def both(request, tmp_path_factory):
    return (request.param, *run_both(request.param, tmp_path_factory.mktemp(request.param)))


def test_every_dataset_matches_tpuqcd(both):
    case, ref, got, _, cfg, _ = both
    check_datasets(case, ref, got, cfg)


def test_every_column_is_certified_and_the_stages_timed(both):
    _, _, _, res, cfg, audited = both
    check_columns_and_stages(res, cfg, audited)


def test_deflation_basis_is_orthonormal_and_saved(both):
    _, _, _, res, cfg, _ = both
    check_basis(res, cfg)


def test_cheap_solves_take_the_links_phase(monkeypatch):
    """The truncated TSM solves get the links' t-boundary phase (tpuqcd's
    run_loops.py:143-149 passes none: ROADMAP Queue 3)."""
    cfg = config_from_dict({**raw_config("plain", "unused.h5"),
                            "gauge": {"dims": list(LAT.dims), "antiperiodic_t": False}})
    cfg = dataclasses.replace(cfg, physics=dataclasses.replace(cfg.physics, n_noise=1,
                                                               tsm_cheap=1))
    seen = []
    import tpuqcd_torch.solve as tsolve
    real = tsolve.solve_tm_batch

    def spy(*args, **kw):
        seen.append((kw["maxiter"], kw["tol"], kw["inner_tol"], kw["t_boundary"]))
        return real(*args, **kw)
    monkeypatch.setattr(tsolve, "solve_tm_batch", spy)
    res = run_loops.measure(cfg, torch.device("cpu"))
    cheap = [s for s in seen if s[0] == cfg.physics.tsm_maxiter_cheap]
    assert cheap == [(50, 1e-3, 1e-3, 1)] * 2          # the cheap noise, the correction noise
    assert all(s[3] == 1 for s in seen) and np.isfinite(res.loops["loops/oneend"]["g5"]).all()


@pytest.mark.parametrize("example", ["loops.yaml", "loops_strange.yaml"])
def test_run_loops_cli_cpu(example, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = load_config(str(ROOT / "examples" / example))
    run_loops.main(["--config", str(ROOT / "examples" / example), "--device", "cpu"])
    names = read_all(cfg.physics.output)
    assert sorted({k.rsplit("/", 1)[0] for k in names}) == ["loops/oneend", "loops/oneend_der"]
    assert sum(k.startswith("loops/oneend/") for k in names) == 16
    assert sum(k.startswith("loops/oneend_der/") for k in names) == 64
    assert all(np.isfinite(v).all() and v.shape == (1, LAT.Lt) for v in names.values())
    with h5py.File(cfg.physics.output, "r") as f:
        assert f["loops/oneend"].attrs["dilute_t"] == cfg.physics.dilute_t


def test_cli_runs_on_cuda_by_default_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_loops.main(["--config", str(ROOT / "examples/loops.yaml")])


@pytest.mark.parametrize("dilute_t", [0, 5])
def test_dilute_t_outside_the_lattice_is_refused(dilute_t):
    raw = raw_config("plain", "unused.h5")
    raw["physics"]["dilute_t"] = dilute_t
    with pytest.raises(ConfigError, match="dilute_t"):
        config_from_dict(raw)
    raw["physics"]["dilute_t"] = LAT.Lt
    assert config_from_dict(raw).physics.dilute_t == LAT.Lt


def test_eigcg_is_in_the_slice_and_refuses_clover():
    raw = raw_config("plain", "unused.h5")
    raw["solver"]["solver"] = "eigcg"
    cfg = config_from_dict(raw)
    check_in_slice(cfg)
    u = torch.zeros((4, 2, 3, 3, 2, *LAT.site_shape))
    assert make_solver(cfg, LAT, u).eigcg == {}
    raw["action"]["csw"] = 1.0
    with pytest.raises(NotImplementedError, match="eigcg runs on the plain twisted-mass"):
        make_solver(config_from_dict(raw), LAT, u)
    # MG takes the eigCG config; gauge fixing and ILDG files are in the slice since the
    # gauge input came, action.mu_list since the mass sweep (read by run_invert alone,
    # as in tpuqcd), a mesh since the loop run came to it (the sharded eigCG), where
    # eigCG still refuses clover
    for key, value in (("mg", {"enabled": True, "block": [[2, 2, 2, 2]]}),
                       ("action", {"mu_list": [0.1]}),
                       ("gauge", {"dims": list(LAT.dims), "fix": "landau"}),
                       ("gauge", {"dims": list(LAT.dims), "config_file": "x.ildg"}),
                       ("mesh", {"nt": 2})):
        check_in_slice(config_from_dict({**raw_config("plain", "unused.h5"), key: value}))
    from tpuqcd_torch.parallel.mesh import LatticeMesh
    clover_mesh = config_from_dict({**raw, "mesh": {"nt": 2}})
    check_in_slice(clover_mesh)
    with pytest.raises(NotImplementedError, match="eigcg runs on the plain twisted-mass"):
        make_solver(clover_mesh, LAT, u, LatticeMesh(LAT, 2))
