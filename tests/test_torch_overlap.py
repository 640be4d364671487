"""The port's overlap engine (parallel/overlap.py: the interior launch on
the shard's lattice with local-periodic wraps, then the slab repairs) in
one process: every shard of an emulated mesh takes its faces cut from the
global fields (parallel/sharded.cut_halo), and the shards' results are
stitched.

References: tpuqcd's unsharded twisted-mass and twisted-clover operators
(backend="xla") through whole operators whose hops are the emulated
overlap hops, on (2, 1, 1), (2, 2, 1) and (2, 1, 2) meshes, both boundary
conditions (reconstruct-12 links rebuild the phase by the shard rule);
tpuqcd's own overlap operators (ShardedTMOperatorPC and
ShardedTMCloverOperatorPC with overlap=True, backend="xla") on conftest's
8 CPU devices, a (2, 2, 2) mesh; the port's unsharded plain version for
the MG modes (xpay with the kappa scale, dirs) and bfloat16.  Tolerances:
float64 1e-12, float32 (reconstruct-12) 3e-5 absolute, bfloat16 1e-2 of
the largest value.  Cost: about 60 s serial, most of it tpuqcd's compiles
of its sharded programs."""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd.operators import PackedTMCloverOperatorPC as JClover
from tpuqcd.operators import PackedTMOperatorPC as JTM
from tpuqcd.ops.dslash_xla import dslash_eo_dev_ri
from tpuqcd.parallel.mesh import LatticeMesh as JMesh
from tpuqcd.parallel.sharded import ShardedTMCloverOperatorPC as JShClover
from tpuqcd.parallel.sharded import ShardedTMOperatorPC as JShTM

from tpuqcd_torch.operators import PackedTMCloverOperatorPC, PackedTMOperatorPC
from tpuqcd_torch.ops.dslash_cuda import dslash_eo_plain
from tpuqcd_torch.parallel.mesh import LatticeMesh
from tpuqcd_torch.parallel.overlap import dslash_overlap
from tpuqcd_torch.parallel.sharded import cut_halo

from _torch_inputs import n, spinor_pk, t
from _torch_mesh import CSW, JLAT, KAPPA, LAT, MU, inputs

GRIDS = [(2, 1, 1), (2, 2, 1), (2, 1, 2)]
PREC = {"f64": (torch.float64, 3, 1e-12), "f32": (torch.float32, 2, 3e-5)}


def emulated_hop(grid, u, psi, parity, dagger=False, **kw):
    """Every shard's overlap hop, its faces cut from the global fields,
    stitched into the global result."""
    out = torch.empty_like(psi)
    for r in range(int(np.prod(grid))):
        m = LatticeMesh(LAT, *grid, r)
        ul, pl, halo = cut_halo(m, u, psi, parity, dagger)
        loc = {k: m.shard(v).contiguous() if torch.is_tensor(v) else v for k, v in kw.items()}
        m.shard(out)[...] = dslash_overlap(ul, pl, parity, m, halo, dagger=dagger, **loc)
    return out


@dataclasses.dataclass(frozen=True)
class EmulatedTM(PackedTMOperatorPC):
    """The port's twisted-mass operator, every hop an emulated overlap hop."""
    grid: tuple = (2, 1, 1)

    def _hop(self, u, psi, parity, dagger=False, epilogue="none", flavor=None, psi0=None,
             xpay_scale=None):
        return emulated_hop(self.grid, u, psi, parity, dagger, epilogue=epilogue,
                            kappa=self.kappa, mu=self.mu,
                            flavor=self.flavor if flavor is None else flavor, psi0=psi0,
                            t_boundary=self.t_boundary, xpay_scale=xpay_scale)


@dataclasses.dataclass(frozen=True)
class EmulatedClover(PackedTMCloverOperatorPC):
    """The port's twisted-clover operator, every hop an emulated overlap hop."""
    grid: tuple = (2, 1, 1)

    def _hop(self, u, psi, parity, dagger=False, epilogue="none", flavor=None, psi0=None,
             clover=None):
        return emulated_hop(self.grid, u, psi, parity, dagger, epilogue=epilogue,
                            kappa=self.kappa, mu=self.mu,
                            flavor=self.flavor if flavor is None else flavor, psi0=psi0,
                            t_boundary=self.t_boundary, clover=clover)


def _methods(op, fields, psi, b):
    return {"apply": op.apply(fields, psi), "apply_dagger": op.apply_dagger(fields, psi),
            "prepare": op.prepare(fields, b), "reconstruct": op.reconstruct(fields, psi, b)}


@pytest.mark.parametrize("prec,anti", [("f64", True), ("f32", True), ("f32", False)],
                         ids=["f64", "f32-antiperiodic", "f32-periodic"])
@pytest.mark.parametrize("op_name", ["tm", "clover"])
@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_emulated_overlap_operator_matches_tpuqcd(grid, op_name, prec, anti):
    """Every epilogue of the operators (twist_inv, xpay, none; clover_inv,
    clover_xpay, flavor +1, and -1 in float64) through the overlap engine;
    both boundary conditions where the links are rebuilt (reconstruct-12:
    the 18 reals of float64 carry the phase as they are)."""
    inp = inputs(anti)
    dt, rows, tol = PREC[prec]
    tb = int(inp["t_boundary"])
    u = t(inp["u"][:, :, :rows], dt)
    psi, b = t(inp["psi"], dt), t(inp["b"], dt)
    jpsi, jb = jnp.asarray(inp["psi"]), jnp.asarray(inp["b"], jnp.float64)
    for flavor in ((1, -1) if op_name == "clover" and prec == "f64" else (1,)):
        if op_name == "tm":
            op = EmulatedTM(LAT, kappa=KAPPA, mu=MU, t_boundary=tb, grid=grid)
            ref, fields, jfields = JTM(JLAT, kappa=KAPPA, mu=MU, backend="xla"), u, \
                jnp.asarray(inp["u"])
        else:
            op = EmulatedClover(LAT, kappa=KAPPA, mu=MU, flavor=flavor, t_boundary=tb, grid=grid)
            ref = JClover(JLAT, kappa=KAPPA, mu=MU, csw=CSW, flavor=flavor, backend="xla")
            fields = (u, *(t(inp[k], dt) for k in ("cl", "clp", "clm")))
            jfields = tuple(jnp.asarray(inp[k], jnp.float64) for k in ("u", "cl", "clp", "clm"))
        want = _methods(ref, jfields, jpsi, jb)
        for name, got in _methods(op, fields, psi, b).items():
            np.testing.assert_allclose(n(got), np.asarray(want[name]), atol=tol, rtol=0,
                                       err_msg=f"{name} flavor {flavor}")


@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_emulated_overlap_mg_modes_and_bf16(grid):
    """The MG fine operator's xpay with the kappa scale and the probing's
    single dirs legs (float64, against tpuqcd's hop for dirs), and
    bfloat16 storage with every epilogue, both parities, dagger off and
    on, against the port's unsharded plain version."""
    inp = inputs(True)
    psi0 = t(spinor_pk(LAT, 130))
    u64, psi = t(inp["u"]), t(inp["psi"])
    ci = t(inp["clp"])
    cl_even = t(inp["cl"][0])
    for parity, dagger in itertools.product((0, 1), (False, True)):
        for leg in ((3, -1), (2, +1), (1, -1), (1, +1)):
            got = emulated_hop(grid, u64, psi, parity, dagger, dirs=(leg,))
            ref = dslash_eo_dev_ri(jnp.asarray(inp["u"]), jnp.asarray(inp["psi"]), parity, JLAT,
                                   dagger=dagger, dirs=(leg,))
            np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-12, rtol=0)
        kw = dict(epilogue="xpay", kappa=KAPPA, mu=MU, psi0=psi0, xpay_scale=KAPPA)
        np.testing.assert_allclose(n(emulated_hop(grid, u64, psi, parity, dagger, **kw)),
                                   n(dslash_eo_plain(u64, psi, parity, LAT, dagger=dagger, **kw)),
                                   atol=1e-12, rtol=0)
        ub = u64[:, :, :2].to(torch.bfloat16).contiguous()
        for epi, extra in (("none", {}), ("twist_inv", {}), ("xpay", {"psi0": psi0}),
                           ("clover_inv", {"clover": ci}),
                           ("clover_xpay", {"clover": cl_even, "psi0": psi0})):
            kw = dict(epilogue=epi, kappa=KAPPA, mu=MU,
                      **{k: v.to(torch.bfloat16) for k, v in extra.items()})
            got = emulated_hop(grid, ub, psi.to(torch.bfloat16), parity, dagger, **kw).double()
            ref = dslash_eo_plain(ub, psi.to(torch.bfloat16), parity, LAT, dagger=dagger,
                                  **kw).double()
            assert (got - ref).abs().max() <= 1e-2 * ref.abs().max(), (epi, parity, dagger)


# --------------------------------------------------------------------------
# against tpuqcd's own overlap operators

@pytest.mark.parametrize("anti", [True, False], ids=["antiperiodic", "periodic"])
def test_overlap_matches_tpuqcd_overlap_operators(cpu_devices, anti):
    """tpuqcd's ShardedTMOperatorPC and ShardedTMCloverOperatorPC with
    overlap=True on a (2, 2, 2) mesh of 8 CPU devices against the port's
    engine on the same emulated mesh: twisted mass apply (twist_inv,
    xpay) and prepare (none), twisted clover apply (clover_inv,
    clover_xpay), float64."""
    inp = inputs(anti)
    grid = (2, 2, 2)
    jm = JMesh.make(JLAT, *grid, devices=cpu_devices)
    u_pk = jnp.asarray(inp["u"])
    psi_sh = jm.shard_spinor(jnp.asarray(inp["psi"]))
    b_sh = jax.device_put(jnp.asarray(inp["b"], jnp.float64),
                          jax.NamedSharding(jm.mesh, jax.P(None, *jm.spinor_spec())))
    tb = int(inp["t_boundary"])
    jtm = JShTM(JLAT, jm, kappa=KAPPA, mu=MU, backend="xla", overlap=True)
    u_ext = jax.jit(jtm.extend_gauge)(jm.shard_gauge(u_pk))
    jcl = JShClover(JLAT, jm, kappa=KAPPA, mu=MU, csw=CSW, backend="xla", overlap=True)
    jf = jcl.extend_fields(u_pk, *(jnp.asarray(inp[k], jnp.float64) for k in ("cl", "clp", "clm")))
    tm = EmulatedTM(LAT, kappa=KAPPA, mu=MU, t_boundary=tb, grid=grid)
    cl = EmulatedClover(LAT, kappa=KAPPA, mu=MU, t_boundary=tb, grid=grid)
    u, psi, b = t(inp["u"]), t(inp["psi"]), t(inp["b"], torch.float64)
    fields = (u, *(t(inp[k], torch.float64) for k in ("cl", "clp", "clm")))
    pairs = [("tm apply", tm.apply(u, psi), jax.jit(jtm.apply)(u_ext, psi_sh)),
             ("tm prepare", tm.prepare(u, b), jax.jit(jtm.prepare)(u_ext, b_sh)),
             ("clover apply", cl.apply(fields, psi), jax.jit(jcl.apply)(jf, psi_sh))]
    for what, got, want in pairs:
        np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-12, rtol=0, err_msg=what)
