"""The checks of the sharded multigrid on gloo ranks, shared by
tests/test_torch_mg_mesh.py ((t) and (t, z) meshes) and
test_torch_mg_mesh_y.py ((t, y)): the workers' results (_torch_mesh.run_worker,
task "mg") against the port's one-rank MG from the same seed and against
tpuqcd's one-device solve_tm of the same system."""
import functools

import jax.numpy as jnp
import numpy as np
import torch

from tpuqcd.solve import solve_tm as j_solve_tm

from tpuqcd_torch.ops.clover import clover_twist_inverse
from tpuqcd_torch.parallel.mesh import LatticeMesh
from tpuqcd_torch.utils.packed import pack_clover

from _torch_inputs import n, t
from _torch_mesh import CSW, JLAT, KAPPA, LAT, MU, inputs
from _torch_mesh_worker import mg_solve

#: the worker's results of twisted mass and of twisted clover, and their test ids
NAMES, IDS = ["mg", "mgc"], ["tm", "clover"]


@functools.lru_cache(maxsize=None)
def one_rank(name):
    """The one-rank MG's (x, inner iterations, coarse links)."""
    inp = inputs(True)
    cl = None if name == "mg" else t(inp["cl"])
    x, relres, iters, (links,) = mg_solve(LatticeMesh(LAT, 1), t(inp["u"], torch.float32), cl,
                                            KAPPA, MU, t(inp["b"]), "fused")
    assert relres <= 1e-12
    return n(x), iters, n(torch.view_as_real(links).double())


@functools.lru_cache(maxsize=None)
def tpuqcd_solution(name):
    inp = inputs(True)
    kw = dict(kappa=KAPPA, mu=MU, tol=1e-12, backend="xla")
    if name == "mgc":
        # the odd twisted inverses of the same A in complex128, so that the
        # direct even-odd system is the MG path's M to float64 precision
        cl = t(inp["cl"], torch.float64)
        a = torch.complex(cl[:, 0], cl[:, 1])
        inv = [n(pack_clover(clover_twist_inverse(a, KAPPA, MU, f, 1), torch.float64))
               for f in (1, -1)]
        kw.update(csw=CSW, clover=(jnp.asarray(inp["cl"]), *map(jnp.asarray, inv)))
    return np.asarray(j_solve_tm(jnp.asarray(inp["u"], jnp.float32), jnp.asarray(inp["b"]),
                                 JLAT, **kw).x)


def check_matches_one_rank(ranks, name):
    assert ranks[f"{name}_relres"] <= 1e-12
    np.testing.assert_allclose(ranks[f"{name}_x"], one_rank(name)[0], atol=1e-10, rtol=0)


def check_builds_the_one_rank_hierarchy(ranks, name):
    """The hierarchy itself, not only the certified x (which any converging
    preconditioner reaches): the replicated coarse links equal the one-rank
    MG's from the same seed to float32 summation order, and the solve takes
    the one-rank inner iterations."""
    _, iters, links = one_rank(name)
    scale = np.abs(links).max()
    np.testing.assert_allclose(ranks[f"{name}_links"] / scale, links / scale, atol=3e-5,
                               rtol=0)
    assert ranks[f"{name}_iters"] == iters


def check_matches_tpuqcd_solution(ranks, name):
    """The certified MG solution against tpuqcd's one-device solve_tm (for
    clover: tpuqcd's A blocks, which the MG fine level applies, with their
    odd twisted inverses in complex128)."""
    np.testing.assert_allclose(ranks[f"{name}_x"], tpuqcd_solution(name), atol=1e-10, rtol=0)
