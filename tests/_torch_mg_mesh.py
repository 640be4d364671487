"""The checks of the sharded multigrid on gloo ranks, shared by
tests/test_torch_mg_mesh.py ((t), fused), test_torch_mg_mesh_tz.py ((t, z),
overlap) and test_torch_mg_mesh_y.py ((t, y), overlap), one torchrun launch
a file: the workers' results (_torch_mesh.run_worker, task "mg"; with
"mgbf" the bfloat16 solver buffers) against the port's one-rank MG from
the same seed and against tpuqcd's one-device solve_tm of the same
system."""
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
from _torch_mesh_worker import MGBF_PARAMS, mg_solve

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


@functools.lru_cache(maxsize=None)
def one_rank_bf16():
    """The one-rank MG with bfloat16 buffers: (x, inner iterations, links)."""
    inp = inputs(True)
    x, relres, iters, (links,) = mg_solve(LatticeMesh(LAT, 1), t(inp["u"], torch.float32),
                                          None, KAPPA, MU, t(inp["b"]), "fused",
                                          params=MGBF_PARAMS)
    assert relres <= 1e-12
    return n(x), iters, n(torch.view_as_real(links).double())


def check_bf16_buffers_match_one_rank(ranks):
    """The bfloat16 GCR basis and null-vector bank on the ranks: the same
    inner iterations as the one-rank hierarchy from the same seed, x within
    1e-10 (both certified to 1e-12), and the replicated coarse links within
    1e-3 of their largest value.  The ranks round the same null vectors to
    bfloat16 (their float32 values summed over the ranks in another order,
    1e-7 apart); where one falls on the other side of a rounding midpoint,
    an element moves by a bfloat16 ulp (2^-8 of itself), which float32
    summation order's 3e-5 does not cover."""
    x, iters, want = one_rank_bf16()
    assert ranks["mgbf_relres"] <= 1e-12
    assert ranks["mgbf_iters"] == iters
    np.testing.assert_allclose(ranks["mgbf_x"], x, atol=1e-10, rtol=0)
    scale = np.abs(want).max()
    np.testing.assert_allclose(ranks["mgbf_links"] / scale, want / scale, atol=1e-3, rtol=0)
