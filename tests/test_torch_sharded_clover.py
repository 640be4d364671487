"""The port's sharded twisted-mass and twisted-clover operators and
solve_tm_sharded on gloo ranks, under both communication policies, on
(t), (t, z) and (t, y) meshes.

The ranks run tests/_torch_mesh_worker.py (tpuqcd_torch only).  References:
tpuqcd's unsharded operators (backend="xla") on the same numpy inputs,
with tpuqcd's own clover construction handed to both packages; the port's
one-rank solve; tpuqcd's one-device solve_tm.  Tolerances: float32
(reconstruct-12) 3e-5 absolute, float64 1e-12, solutions of two solves to
1e-12 agree to 1e-10.  Cost: about 60 s serial (five torchrun launches)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd.operators import PackedTMCloverOperatorPC as JClover
from tpuqcd.operators import PackedTMOperatorPC as JTM
from tpuqcd.solve import solve_tm as j_solve_tm

from tpuqcd_torch.parallel.mesh import LatticeMesh
from tpuqcd_torch.parallel.sharded import (ShardedTMCloverOperatorPC, ShardedTMOperatorPC,
                                           clover_fields_to, extend_gauge)
from tpuqcd_torch.solve import solve_tm_sharded

from _torch_inputs import n, t
from _torch_mesh import CSW, JLAT, KAPPA, LAT, MESHES, MU, inputs, run_worker

TOL = {"f32": 3e-5, "f64": 1e-12}
#: (mesh, policy, antiperiodic_t) of each launch: both policies on (t) and
#: (t, z), overlap on (t, y), and the periodic phase under overlap
CASES = [("t", "fused", True), ("tz", "fused", True), ("t", "overlap", False),
         ("tz", "overlap", True), ("ty", "overlap", True)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}-"
                f"{'anti' if c[2] else 'per'}")
def ranks(request, tmp_path_factory):
    mesh, policy, anti = request.param
    inp = inputs(anti)
    out = run_worker(tmp_path_factory.mktemp(f"{mesh}{policy}{anti}"), inp, MESHES[mesh],
                     policy, ["ops", "solve"])
    return out, inp


def _jfields(inp, dtype=jnp.float64):
    return tuple(jnp.asarray(inp[k], dtype) for k in ("u", "cl", "clp", "clm"))


def _reference(op_name, method, inp, flavor=1):
    """tpuqcd's unsharded operator (18-real links, the phase in them)."""
    if op_name == "tm":
        op, fields = JTM(JLAT, kappa=KAPPA, mu=MU, backend="xla"), jnp.asarray(inp["u"])
    else:
        op = JClover(JLAT, kappa=KAPPA, mu=MU, csw=CSW, flavor=flavor, backend="xla")
        fields = _jfields(inp)
    x, b = jnp.asarray(inp["psi"]), jnp.asarray(inp["b"], jnp.float64)
    if method == "prepare":
        return np.asarray(op.prepare(fields, b))
    if method == "reconstruct":
        return np.asarray(op.reconstruct(fields, x, b))
    return np.asarray(getattr(op, method)(fields, x))


@pytest.mark.parametrize("method", ["apply", "apply_dagger", "prepare", "reconstruct"])
@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("op_name", ["tm", "clover"])
def test_sharded_operator_matches_tpuqcd(ranks, op_name, prec, method):
    out, inp = ranks
    np.testing.assert_allclose(out[f"{op_name}_{prec}_{method}"],
                               _reference(op_name, method, inp), atol=TOL[prec], rtol=0)


def test_sharded_clover_flavor_minus(ranks):
    out, inp = ranks
    np.testing.assert_allclose(out["clover_f64_apply_m"], _reference("clover", "apply", inp, -1),
                               atol=1e-12, rtol=0)


@functools.lru_cache(maxsize=None)
def _one_rank_solve(name, anti):
    """The port's solve on a one-rank mesh from the same inputs."""
    inp = inputs(anti)
    lmesh = LatticeMesh(LAT, 1)
    kw = dict(kappa=KAPPA, mu=MU, t_boundary=int(inp["t_boundary"]), lmesh=lmesh)
    ug = extend_gauge(lmesh, t(inp["u"]))
    if name == "tm":
        op, fs, fh = ShardedTMOperatorPC(LAT, **kw), ug.to(torch.float32, 2), ug.to(torch.float64)
    else:
        op = ShardedTMCloverOperatorPC(LAT, **kw)
        f64 = (ug, *(t(inp[k], torch.float64) for k in ("cl", "clp", "clm")))
        fs, fh = clover_fields_to(f64, torch.float32, 2), clover_fields_to(f64, torch.float64)
    return solve_tm_sharded(op, fs, fh, t(inp["b"]), tol=1e-12)


@pytest.mark.parametrize("name", ["tm", "clover"])
def test_sharded_solve_matches_one_rank_and_tpuqcd(ranks, name):
    """solve_tm_sharded's x against the port's one-rank solve from the
    same inputs and, antiperiodic, against tpuqcd's one-device solve_tm
    (the clover construction handed to both)."""
    out, inp = ranks
    anti = int(inp["t_boundary"]) == -1
    assert out[f"{name}_relres"] <= 1e-12
    np.testing.assert_allclose(out[f"{name}_x"], n(_one_rank_solve(name, anti).x), atol=1e-10,
                               rtol=0)
    if anti:
        np.testing.assert_allclose(out[f"{name}_x"], _tpuqcd_solve(name), atol=1e-10, rtol=0)


@functools.lru_cache(maxsize=None)
def _tpuqcd_solve(name):
    """tpuqcd's one-device solve_tm of the antiperiodic system, x as numpy."""
    inp = inputs(True)
    kw = dict(kappa=KAPPA, mu=MU, tol=1e-12, backend="xla", t_boundary=int(inp["t_boundary"]))
    if name == "clover":
        kw.update(csw=CSW, clover=_jfields(inp, jnp.float32)[1:])
    ref = j_solve_tm(jnp.asarray(inp["u"], jnp.float32), jnp.asarray(inp["b"]), JLAT, **kw)
    return np.asarray(ref.x)
