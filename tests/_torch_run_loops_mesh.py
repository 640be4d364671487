"""Shared pieces of run_loops' gloo-mesh tests: the runs (RUNS), their
configurations and launches, and the tests of every run.
test_torch_run_loops_mesh.py launches (t) on 2 ranks,
test_torch_run_loops_mesh_mg.py the MG branch and eigCG on 2 ranks,
test_torch_run_loops_mesh_4.py (t, z) and (t, y) on 4: one torchrun
launch a file, so that --dist loadfile spreads them over workers.

run_loops on a mesh of gloo ranks, the user's path: run_loops.main under
torchrun (tests/_torch_physics_mesh_worker.py), with every gather of a
field made to raise but the eigenpair file's write.

* (t) on 2 ranks at 2x2x2x4 (local T = 2, time dilution in 3 classes, so
  that the second rank's classes start at global t = 2), with TSM (two
  cheap noises, 8 steps) and deflation by a shared physics.eig_infile,
  so that every side deflates with the same basis: held to the port's
  one-rank run and to tpuqcd's run_loops._measure on one device through
  tests/_torch_loops_run.py's stand-ins (the port's noises, the exact
  dense solver) within that file's 1e-4, on a gauge file tpuqcd wrote;
* (t, z) and (t, y) on 4 ranks at 4x4x4x8 without TSM, deflated by a
  shared eig_infile, 33 momenta (the one-rank run projects by the FFT,
  the mesh by the phase sum);
* the MG branch on 2 ranks, with one cheap noise and the Lanczos basis on
  the mesh written to physics.eig_outfile (gathered to rank 0 a vector at
  a time, the only gather), which the one-rank run then reads as its
  eig_infile; the file's eigenvalues within 1e-5 of a one-card Lanczos;
* eigCG on 2 ranks with one cheap noise (CG on the sharded operators).

Every dataset within 1e-5 of its largest value of the port's one-rank run
(the mesh solves column by column and sums over the ranks: float32
solutions differ near 1e-7); every full and low-mode column certified to
the configured tol on every rank; rank 0 alone writing, under tpuqcd's
dataset names."""
import numpy as np
import pytest

from tpuqcd_torch.cli import run_loops
from tpuqcd_torch.cli.common import setup_gauge
from tpuqcd_torch.utils.checkpoint import save_eigenpairs
from tpuqcd_torch.utils.config import config_from_dict, load_config

from _torch_inputs import gauge_full, lattices
from _torch_physics_mesh_worker import momenta
from _torch_mesh import torchrun
from _torch_twop_mesh import CPU, _yaml, assert_runs_agree, h5_all

h5py = pytest.importorskip("h5py")

SMALL, JSMALL = lattices((2, 2, 2, 4))
BASE = {"action": {"kappa": 0.11, "mu": 0.07}, "solver": {"tol": 1.0e-8, "backend": "xla"}}
#: the runs: (mesh, gauge, physics); an eig_infile "shared" is written from
#: the port's one-card Lanczos on the run's gauge before the runs
RUNS = {
    "t": ((2, 1, 1), {"dims": list(SMALL.dims)},
          {"n_noise": 2, "dilute_t": 3, "tsm_cheap": 2, "tsm_maxiter_cheap": 8,
           "n_deflate": 3, "eig_infile": "shared", "momenta": [[0, 0, 0], [1, 0, 0]]}),
    "tz": ((2, 2, 1), {"dims": [4, 4, 4, 8], "random_seed": 6},
           {"n_noise": 1, "dilute_t": 2, "n_deflate": 2, "eig_infile": "shared",
            "momenta": momenta().tolist()}),
    "ty": ((2, 1, 2), {"dims": [4, 4, 4, 8], "random_seed": 6},
           {"n_noise": 1, "dilute_t": 2, "n_deflate": 2, "eig_infile": "shared",
            "momenta": momenta().tolist()}),
    "mg": ((2, 1, 1), {"dims": list(SMALL.dims), "random_seed": 3},
           {"n_noise": 1, "dilute_t": 2, "tsm_cheap": 1, "tsm_maxiter_cheap": 8,
            "n_deflate": 2, "eig_outfile": "mesh", "momenta": [[0, 0, 0]]}),
    "eigcg": ((2, 1, 1), {"dims": list(SMALL.dims), "random_seed": 3},
              {"n_noise": 1, "dilute_t": 2, "tsm_cheap": 1, "tsm_maxiter_cheap": 8,
               "momenta": [[0, 0, 0]]}),
}
EXTRA = {"mg": {"mg": {"enabled": True, "n_vec": [2], "block": [[2, 2, 2, 2]],
                       "setup_iters": 4, "smoother_iters": 2, "coarse_maxiter": 4}},
         "eigcg": {"solver": {**BASE["solver"], "solver": "eigcg"}}}


@pytest.fixture(scope="module")
def gauge_file(tmp_path_factory):
    """The (t) run's links, as an ILDG file tpuqcd writes (so that tpuqcd's
    run reads the same links as the port's)."""
    from tpuqcd.io.lime import write_ildg_gauge as j_write_ildg_gauge
    path = tmp_path_factory.mktemp("gauge") / "conf.lime"
    j_write_ildg_gauge(str(path), gauge_full(SMALL, 8), JSMALL)
    return path


def raw_of(name: str, tmp, gauge_file) -> dict:
    """The run's configuration without its mesh; a shared eig_infile is
    written here from the port's one-card Lanczos."""
    _, gauge, physics = RUNS[name]
    raw = {**BASE, **EXTRA.get(name, {}), "gauge": dict(gauge),
           "physics": {**physics, "output": str(tmp / "unused.h5")}}
    if name == "t":
        raw["gauge"]["config_file"] = str(gauge_file)
    ph = raw["physics"]
    if ph.get("eig_infile") == "shared":
        ph["eig_infile"] = str(tmp / "shared_eig.npz")
        cfg = config_from_dict({**raw, "physics": {**ph, "eig_infile": None}})
        lat, u_pk, _, _ = setup_gauge(cfg, CPU)
        evals, evecs = run_loops.deflation_basis(cfg, lat, u_pk)
        save_eigenpairs(ph["eig_infile"], evals, evecs, layout="packed")
    if ph.get("eig_outfile") == "mesh":
        ph["eig_outfile"] = str(tmp / "mesh_eig.npz")
    return raw


def one_rank(tmp, raw) -> dict:
    """The port's run on one card (no mesh): its output file's datasets."""
    cfg = load_config(_yaml(tmp / "one.yaml", raw, tmp / "one.h5"))
    run_loops.write(cfg, run_loops.measure(cfg, CPU))
    return h5_all(tmp / "one.h5")


def launched_on(names, tmp, gauge_file) -> dict:
    """The runs ``names`` of RUNS (meshes of one size), each on its mesh: one
    torchrun launch, which runs main on their configurations in turn.
    name -> (the run's configuration, its directory, each rank's record,
    its output file's datasets)."""
    nproc = int(np.prod(RUNS[names[0]][0]))
    runs, configs = {}, []
    for name in names:
        (tmp / name).mkdir()
        runs[name] = (raw_of(name, tmp / name, gauge_file), tmp / name)
        configs.append(_yaml(tmp / name / "cfg.yaml", runs[name][0], tmp / name / "mesh.h5",
                             RUNS[name][0]))
    torchrun(nproc, "tests/_torch_physics_mesh_worker.py", "--out", str(tmp / "out.npz"),
             "--main", "run_loops", "--config", *configs)
    for i, name in enumerate(names):
        rec = "out.{}.npz" if len(names) == 1 else f"out.{i}.{{}}.npz"
        ranks = [dict(np.load(tmp / rec.format(r))) for r in range(nproc)]
        runs[name] += (ranks, h5_all(tmp / name / "mesh.h5"))
    return runs


def mesh_run_of(name: str, launched: dict):
    """(name, the run's configuration, {"ranks": records, "h5": datasets}, the
    port's one-rank run's datasets, deflated with the mesh run's basis)."""
    raw, tmp, ranks, h5 = launched[name]
    ph = raw["physics"]
    one = raw
    if ph.get("eig_outfile"):
        one = {**raw, "physics": {**ph, "eig_infile": ph["eig_outfile"], "eig_outfile": None}}
    return name, raw, {"ranks": ranks, "h5": h5}, one_rank(tmp, one)


def test_run_loops_on_the_mesh_matches_one_rank(mesh_run):
    _, raw, out, want = mesh_run
    groups = 4 if raw["physics"].get("n_deflate") else 2
    assert len(want) == groups // 2 * (16 + 64)
    assert_runs_agree(out["h5"], want)


def test_every_column_is_certified_and_rank_0_alone_writes(mesh_run):
    name, raw, out, _ = mesh_run
    ranks, ph = out["ranks"], raw["physics"]
    cfg = config_from_dict(raw)
    assert len(ranks) == int(np.prod(RUNS[name][0]))
    columns = ph["n_noise"] * ph["dilute_t"] + ph.get("n_deflate", 0)
    stages = {"gauge", "solves", "loops", "derivatives"}
    stages |= {"tsm_cheap", "solves_correction"} if ph.get("tsm_cheap") else set()
    stages |= {"lanczos", "lowmode"} if ph.get("n_deflate") else set()
    for rank, r in enumerate(ranks):
        assert r["relres"].max() <= cfg.solver.tol and r["columns"].sum() == columns
        assert set(r["stages"]) == stages | ({"write"} if rank == 0 else set())
        # the eigenpair write gathers each basis vector once, and nothing else is gathered
        assert int(r["gathered"]) == (ph["n_deflate"] if ph.get("eig_outfile") else 0)
    assert int(ranks[0]["written"]) == (4 if ph.get("n_deflate") else 2)
    assert all(int(r["written"]) == 0 for r in ranks[1:])
