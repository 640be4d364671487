"""run_loops on 2 gloo ranks over t through the MG branch and through eigCG,
the user's path: run_loops.main under torchrun
(tests/_torch_physics_mesh_worker.py) on the MG and eigCG runs of
tests/_torch_run_loops_mesh.py (which describes them and holds the tests
of every run), in one launch; the MG run's eig_outfile, written from the
mesh, held to a one-card Lanczos; the mesh example loads as in tpuqcd.
Cost: about 30 s serial."""
import os

import numpy as np
import pytest
import torch

from tpuqcd_torch.cli import run_loops
from tpuqcd_torch.cli.common import setup_gauge
from tpuqcd_torch.utils.checkpoint import load_eigenpairs
from tpuqcd_torch.utils.config import config_from_dict, load_config

from _torch_run_loops_mesh import (CPU, gauge_file, launched_on, mesh_run_of,  # noqa: F401
                                   test_every_column_is_certified_and_rank_0_alone_writes,
                                   test_run_loops_on_the_mesh_matches_one_rank)

pytest.importorskip("h5py")


@pytest.fixture(scope="module")
def launched(tmp_path_factory, gauge_file):  # noqa: F811
    return launched_on(["mg", "eigcg"], tmp_path_factory.mktemp("loops_mesh"), gauge_file)


@pytest.fixture(scope="module", params=["mg", "eigcg"])
def mesh_run(request, launched):
    return mesh_run_of(request.param, launched)


@pytest.mark.parametrize("mesh_run", ["mg"], indirect=True)
def test_the_mesh_basis_is_a_lanczos_basis(mesh_run):
    """The MG run's eig_outfile, written from the mesh: orthonormal, and its
    eigenvalues those of a one-card Lanczos on the same operator."""
    _, raw, _, _ = mesh_run
    evals, evecs = load_eigenpairs(raw["physics"]["eig_outfile"], expect_layout="packed")
    cfg = config_from_dict({**raw, "physics": {**raw["physics"], "eig_outfile": None}})
    lat, u_pk, _, _ = setup_gauge(cfg, CPU)
    want, _ = run_loops.deflation_basis(cfg, lat, u_pk)
    np.testing.assert_allclose(evals, want, rtol=1e-5, atol=0)
    v = torch.stack(evecs).reshape(len(evecs), 2, -1).double()
    c = torch.complex(v[:, 0], v[:, 1])
    np.testing.assert_allclose((c.conj() @ c.T).numpy(), np.eye(len(evecs)), atol=1e-5)


def test_the_mesh_example_loads_as_in_tpuqcd():
    from tpuqcd.utils.config import load_config as j_load_config
    path = os.path.join(os.path.dirname(__file__), "..", "examples", "loops_mesh.yaml")
    cfg, jcfg = load_config(path), j_load_config(path)
    mesh = (cfg.mesh.nt, cfg.mesh.nz, cfg.mesh.ny)
    assert mesh == (jcfg.mesh.nt, jcfg.mesh.nz, jcfg.mesh.ny) == (2, 1, 1)
    for key in ("n_noise", "tsm_cheap", "n_deflate", "eig_outfile", "momenta"):
        assert getattr(cfg.physics, key) == getattr(jcfg.physics, key), key
