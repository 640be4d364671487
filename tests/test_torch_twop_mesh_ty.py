"""run_twop on 4 ranks over (t, y), the overlap engine (torchrun,
tests/_torch_physics_mesh_worker.py), at 4x4x4x8 with the source off the
origin on a rank other than 0: the pieces and the whole run held by the
tests of tests/_torch_twop_mesh.py (the (t) mesh and the heatbath chain
under torchrun: test_torch_twop_mesh.py).  One torchrun launch a file, so
that --dist loadfile spreads the meshes over workers.  Cost: about 35 s
serial (the launch, the one-rank reference run)."""
import pytest

from _torch_twop_mesh import (gauge_file, mesh_run_of, pieces_inputs, reference,  # noqa: F401
                              test_every_column_is_certified_and_rank_0_alone_writes,
                              test_pieces_match_one_card,
                              test_run_twop_on_the_mesh_matches_one_rank)


@pytest.fixture(scope="module", params=["ty"])
def mesh_run(request, tmp_path_factory, pieces_inputs, gauge_file):  # noqa: F811
    return mesh_run_of(request.param, tmp_path_factory, pieces_inputs, gauge_file)
