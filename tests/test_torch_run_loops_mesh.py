"""run_loops on 2 gloo ranks over t, the user's path: run_loops.main under
torchrun (tests/_torch_physics_mesh_worker.py) on the (t) run of
tests/_torch_run_loops_mesh.py (which describes it and holds the tests of
every run), held to the port's one-rank run and to tpuqcd's
run_loops._measure on one device.  The MG and eigCG runs:
test_torch_run_loops_mesh_mg.py; the 4-rank runs: _4.py.  Cost: about
80 s serial (the launch, tpuqcd's run with TSM once, 60 s)."""
import numpy as np
import pytest

from _torch_inputs import gauge_full
from _torch_loops_run import run_tpuqcd
from _torch_run_loops_mesh import (SMALL, gauge_file, launched_on, mesh_run_of,  # noqa: F401
                                   test_every_column_is_certified_and_rank_0_alone_writes,
                                   test_run_loops_on_the_mesh_matches_one_rank)

pytest.importorskip("h5py")


@pytest.fixture(scope="module")
def launched(tmp_path_factory, gauge_file):  # noqa: F811
    return launched_on(["t"], tmp_path_factory.mktemp("loops_mesh"), gauge_file)


@pytest.fixture(scope="module", params=["t"])
def mesh_run(request, launched):
    return mesh_run_of(request.param, launched)


@pytest.mark.parametrize("mesh_run", ["t"], indirect=True)
def test_the_t_mesh_run_matches_tpuqcd(mesh_run, gauge_file):
    """tpuqcd's _run_device on one device on the same links, noises and
    eig_infile, with the exact solver, against the run over t."""
    _, raw, out, _ = mesh_run
    raw = {**raw, "gauge": {"dims": raw["gauge"]["dims"]},
           "physics": {**raw["physics"], "output": str(gauge_file.parent / "tpuqcd.h5")}}
    want = run_tpuqcd(raw, gauge_full(SMALL, 8))
    assert sorted(out["h5"]) == sorted(want) and len(want) == 2 * (16 + 64)
    for k, w in want.items():
        np.testing.assert_allclose(out["h5"][k], w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=k)
