"""run_threeptwop on 4 ranks over (t, z) (fused faces) (torchrun,
tests/_torch_physics_mesh_worker.py) at 4x4x4x8, the source off the origin
on a rank other than 0 and t_sink on another t-block: the pieces and the
whole run held by the tests of tests/_torch_threep_mesh.py, which
describes them.  One torchrun launch a file (the meshes: test_torch_threep_mesh.py,
_tz.py, _ty.py), so that --dist loadfile spreads them over workers.
Cost: about 30-50 s serial (the launch, the one-rank reference run)."""
import pytest

from _torch_threep_mesh import (mesh_run_of, pieces_inputs, reference,  # noqa: F401
                                test_every_column_is_certified_and_rank_0_alone_writes,
                                test_pieces_match_one_card,
                                test_run_threeptwop_on_the_mesh_matches_one_rank)


@pytest.fixture(scope="module", params=["tz"])
def mesh_run(request, tmp_path_factory, pieces_inputs):  # noqa: F811
    return mesh_run_of(request.param, tmp_path_factory, pieces_inputs)
