"""The mass sweep and the three-level multigrid on gloo ranks
(tests/_torch_mesh_worker.py, tasks "musweep" and "mg3"): the sweep on 2
ranks over t (the fused K6 hops) and on a y-sharded mesh of 2 ranks (the
overlap engine), each against the one-rank sweep (x within 1e-6, the same
iterations) and certified to 1e-10 mass by mass; a three-level
hierarchy (8^4 -> 4^4 -> 2^4, replicated coarse levels) on 2 ranks over
t against the one-rank hierarchy from the same seed (both levels' coarse
links, the inner iterations, the certified x), as tests/_torch_mg_mesh.py
holds the two-level one (run_invert's CLI with action.mu_list on 2 gloo
ranks: test_torch_musweep_mesh_cli.py).  Cost: about 45 s serial (three
torchrun launches)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd_torch.parallel.mesh import LatticeMesh
from tpuqcd_torch.solve import full_system_relres

from _torch_inputs import gauge_full, jax_gauge_pk, lattices, n, spinor_pk, t
from _torch_mesh import KAPPA, LAT, MU, inputs, run_worker
from _torch_mesh_worker import MG3_PARAMS, MUSWEEP_MU, mg_solve, musweep

#: the sweep's meshes of 2 ranks: (t) under fused, (y) under overlap
SWEEP_CASES = {"t-fused": ((2, 1, 1), "fused"), "y-overlap": ((1, 1, 2), "overlap")}
LAT3, JLAT3 = lattices((8, 8, 8, 8))


@functools.lru_cache(maxsize=None)
def inputs3() -> dict:
    """The three-level test's global inputs at 8^4 (float32-valued gauge)."""
    u = jax_gauge_pk(gauge_full(LAT3, 130), JLAT3, True, jnp.float32)
    return dict(u=np.asarray(u, np.float64),
                b=spinor_pk(LAT3, 131, parities=2).astype(np.float32),
                dims=np.array(LAT3.dims), kappa=KAPPA, mu=MU, t_boundary=-1)


@functools.lru_cache(maxsize=None)
def one_rank_sweep():
    inp = inputs(True)
    xs, rel, iters, certs = musweep(LatticeMesh(LAT, 1), t(inp["u"], torch.float32),
                                    t(inp["b"]), KAPPA, -1, "fused")
    return n(xs), rel, iters, [n(c.x) for c in certs]


@pytest.fixture(scope="module", params=list(SWEEP_CASES))
def sweep_ranks(request, tmp_path_factory):
    mesh, policy = SWEEP_CASES[request.param]
    return run_worker(tmp_path_factory.mktemp("sweep"), inputs(True), mesh, policy,
                      ["musweep"])


def test_sharded_sweep_matches_one_rank(sweep_ranks):
    xs, rel, iters, _ = one_rank_sweep()
    assert int(sweep_ranks["sweep_iters"]) == iters
    np.testing.assert_allclose(sweep_ranks["sweep_x"], xs, atol=1e-6 * np.abs(xs).max(), rtol=0)
    # the float64 residuals of float32 x_i near 1e-6, on the ranks and on one
    assert sweep_ranks["sweep_relres"].max() < 2e-6 and max(rel) < 2e-6


def test_sharded_sweep_certifies_every_mass(sweep_ranks):
    """Each mass's certification meets 1e-10 on the ranks and by the
    unsharded float64 operator on the gathered x, and agrees with the
    one-rank certification."""
    inp = inputs(True)
    _, _, _, certs = one_rank_sweep()
    assert sweep_ranks["cert_relres"].max() <= 1e-10
    for i, mu in enumerate(MUSWEEP_MU):
        x = sweep_ranks["cert_x"][i]
        assert full_system_relres(t(inp["u"]), t(inp["b"]), t(x), LAT, kappa=KAPPA,
                                  mu=mu) <= 1e-10
        np.testing.assert_allclose(x, certs[i], atol=1e-8 * np.abs(certs[i]).max(), rtol=0)


@functools.lru_cache(maxsize=None)
def one_rank_mg3():
    inp = inputs3()
    x, relres, iters, links = mg_solve(LatticeMesh(LAT3, 1), t(inp["u"], torch.float32), None,
                                       KAPPA, MU, t(inp["b"]), "fused", params=MG3_PARAMS)
    assert relres <= 1e-12
    return n(x), iters, [n(torch.view_as_real(lc).double()) for lc in links]


@pytest.fixture(scope="module")
def mg3_ranks(tmp_path_factory):
    return run_worker(tmp_path_factory.mktemp("mg3"), inputs3(), (2, 1, 1), "fused", ["mg3"])


def test_sharded_three_level_builds_the_one_rank_hierarchy(mg3_ranks):
    """Both replicated coarse levels equal the one-rank hierarchy's from the
    same seed (to float32 summation order), and the solve takes the
    one-rank inner iterations."""
    _, iters, links = one_rank_mg3()
    assert len(links) == 2
    for i, want in enumerate(links, 1):
        scale = np.abs(want).max()
        np.testing.assert_allclose(mg3_ranks[f"mg3_links{i}"] / scale, want / scale, atol=3e-5,
                                   rtol=0, err_msg=f"level {i}")
    assert int(mg3_ranks["mg3_iters"]) == iters


def test_sharded_three_level_matches_one_rank(mg3_ranks):
    x, _, _ = one_rank_mg3()
    inp = inputs3()
    assert mg3_ranks["mg3_relres"] <= 1e-12
    np.testing.assert_allclose(mg3_ranks["mg3_x"], x, atol=1e-10, rtol=0)
    assert full_system_relres(t(inp["u"]), t(inp["b"]), t(mg3_ranks["mg3_x"]), LAT3,
                              kappa=KAPPA, mu=MU) <= 1e-11
