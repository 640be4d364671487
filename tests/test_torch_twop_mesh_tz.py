"""run_twop on 4 ranks over (t, z), fused faces (torchrun,
tests/_torch_physics_mesh_worker.py), at 4x4x4x8 with the source off the
origin on a rank other than 0: the pieces and the whole run held by the
tests of tests/_torch_twop_mesh.py (the (t) mesh and the heatbath chain
under torchrun: test_torch_twop_mesh.py); and the mesh examples load as
in tpuqcd.  One torchrun launch a file, so
that --dist loadfile spreads the meshes over workers.  Cost: about 35 s
serial (the launch, the one-rank reference run)."""
import os

import numpy as np
import pytest

from tpuqcd_torch.utils.config import load_config

from _torch_twop_mesh import (gauge_file, mesh_run_of, pieces_inputs, reference,  # noqa: F401
                              test_every_column_is_certified_and_rank_0_alone_writes,
                              test_pieces_match_one_card,
                              test_run_twop_on_the_mesh_matches_one_rank)


@pytest.fixture(scope="module", params=["tz"])
def mesh_run(request, tmp_path_factory, pieces_inputs, gauge_file):  # noqa: F811
    return mesh_run_of(request.param, tmp_path_factory, pieces_inputs, gauge_file)


def test_the_mesh_examples_load_as_in_tpuqcd():
    from tpuqcd.utils.config import load_config as j_load_config
    for name in ("twop_mesh.yaml", "threep_mesh.yaml"):
        path = os.path.join(os.path.dirname(__file__), "..", "examples", name)
        cfg, jcfg = load_config(path), j_load_config(path)
        mesh = (cfg.mesh.nt, cfg.mesh.nz, cfg.mesh.ny)
        assert mesh == (jcfg.mesh.nt, jcfg.mesh.nz, jcfg.mesh.ny) and np.prod(mesh) > 1, name
        for key in ("source_positions", "momenta", "projectors", "smear_n_gauss", "t_sinks"):
            assert getattr(cfg.physics, key) == getattr(jcfg.physics, key), (name, key)
