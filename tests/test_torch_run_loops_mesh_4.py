"""run_loops on 4 gloo ranks, the user's path: run_loops.main under torchrun
(tests/_torch_physics_mesh_worker.py) on the (t, z) and (t, y) runs of
tests/_torch_run_loops_mesh.py (which describes them and holds their
tests), in one launch.  The 2-rank runs: test_torch_run_loops_mesh.py
and _mg.py.
Cost: about 40 s serial."""
import pytest

from _torch_run_loops_mesh import (gauge_file, launched_on, mesh_run_of,  # noqa: F401
                                   test_every_column_is_certified_and_rank_0_alone_writes,
                                   test_run_loops_on_the_mesh_matches_one_rank)

pytest.importorskip("h5py")


@pytest.fixture(scope="module")
def launched(tmp_path_factory, gauge_file):  # noqa: F811
    return launched_on(["tz", "ty"], tmp_path_factory.mktemp("loops_mesh"), gauge_file)


@pytest.fixture(scope="module", params=["tz", "ty"])
def mesh_run(request, launched):
    return mesh_run_of(request.param, launched)
