"""The batch axis of the port against tpuqcd: the Dslash on N right-hand
sides, the batched solvers and the lockstep MG solve.

Tolerances: a batched plain Dslash against ``jax.vmap`` of the Pallas
kernel in interpret mode 1e-5 of max|ref| (float32 sums in another
order); solve_tm_batch against the port's own single solve_tm 1e-12 of
max|x| with equal matvec counts (a column's float64 reductions differ
from its single solve's in summation order only, 1e-14 relative, and
the step sizes are rounded to float32), and against tpuqcd's solve_tm_batch 1e-8
(two certified solutions of one system); cg_batched against tpuqcd's
1e-5 (float32 iterates); the lockstep MG solve against tpuqcd's on the
same hierarchy 1e-6, as tests/test_torch_mg_solve.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd.mg import device as jdevice
from tpuqcd.mg.dsolve import DeviceMG as JDeviceMG, DeviceMGParams as JParams
from tpuqcd.ops.dslash_pallas import dslash_eo_pallas
from tpuqcd.solve import solve_tm_batch as j_solve_tm_batch
from tpuqcd.solvers.cg import cg_batched as j_cg_batched
from tpuqcd.utils import checkpoint as jcheckpoint

from tpuqcd_torch.mg.device import DeviceFineLevel
from tpuqcd_torch.mg.dsolve import DeviceMGParams
from tpuqcd_torch.operators import PackedTMOperatorPC
from tpuqcd_torch.ops import dslash_cuda
from tpuqcd_torch.ops.dslash_cuda import dslash_eo
from tpuqcd_torch.solve import (full_system_relres, solve_tm, solve_tm_batch, solve_tm_mg,
                                solve_tm_mg_batch)
from tpuqcd_torch.solvers.cg import cg_batched, cg_refined
from tpuqcd_torch.solvers.reductions import norm2, norm2_cols, redot, redot_cols
from tpuqcd_torch.utils import pkalg as pk
from tpuqcd_torch.utils.checkpoint import load_device_mg

from _torch_inputs import gauge_full, jax_gauge_pk, lattices, n, spinor_pk, t

LAT, JLAT = lattices((4, 4, 4, 8))
KAPPA, MU = 0.115, 0.08
MG_PARAMS = dict(n_vec=(4,), block=((2, 2, 2, 2),), setup_iters=20, smoother_iters=3,
                 coarse_iters=12, restart=6)


def _gauge(dtype=jnp.float32):
    return jax_gauge_pk(gauge_full(LAT, 30), JLAT, True, dtype)


def _batch(n_rhs, seed, parities=2, dtype=np.float32):
    """N random packed fields; column 1 a thousand times smaller."""
    b = np.stack([spinor_pk(LAT, seed + i, parities) for i in range(n_rhs)]).astype(dtype)
    if n_rhs > 1:
        b[1] *= 1e-3
    return b


# --- the Dslash on a batch ---------------------------------------------------

@pytest.mark.parametrize("n_rhs", [3, 5])    # 5: a width the kernel's column warps do not divide
@pytest.mark.parametrize("epilogue,parity,dagger", [("none", 0, False), ("twist_inv", 1, True),
                                                    ("xpay", 0, False)])
def test_batched_dslash_matches_vmap_of_pallas(epilogue, parity, dagger, n_rhs):
    u12 = _gauge()[:, :, :2]
    psi, psi0 = jnp.asarray(_batch(n_rhs, 1, 1)), jnp.asarray(_batch(n_rhs, 11, 1))
    kw = dict(dagger=dagger, epilogue=epilogue, kappa=KAPPA, mu=MU)
    if epilogue == "xpay":
        ref = jax.vmap(lambda a, b: dslash_eo_pallas(u12, a, parity, JLAT, interpret=True,
                                                     psi0_pk=b, **kw))(psi, psi0)
    else:
        ref = jax.vmap(lambda a: dslash_eo_pallas(u12, a, parity, JLAT, interpret=True,
                                                  **kw))(psi)
    ref = np.asarray(ref)
    out = dslash_eo(t(u12), t(psi), parity, LAT,
                    psi0=t(psi0) if epilogue == "xpay" else None, **kw)
    assert out.shape == (n_rhs, 2, 4, 3, *LAT.site_shape)
    assert np.abs(n(out) - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_batched_dslash_equals_single_calls_on_mg_views(dtype):
    """psi, psi0 and out as parity views of a batched MG field
    [N, 2(ri), 2(par), ...]; nothing outside the output view is written."""
    u12 = t(_gauge()[:, :, :2], dtype)
    field = t(np.stack([spinor_pk(LAT, 20 + i, 2).swapaxes(0, 1) for i in range(3)]), dtype)
    out = torch.zeros_like(field)
    kw = dict(epilogue="xpay", kappa=KAPPA, mu=MU, xpay_scale=KAPPA)
    got = dslash_eo(u12, field[:, :, 1], 1, LAT, psi0=field[:, :, 0], out=out[:, :, 0], **kw)
    assert got.data_ptr() == out.data_ptr() and out[:, :, 1].abs().max().item() == 0.0
    tol = {torch.float64: 1e-14, torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7}[dtype]
    for i in range(3):
        one = dslash_eo(u12, field[i, :, 1].contiguous(), 1, LAT,
                        psi0=field[i, :, 0].contiguous(), **kw)
        assert (out[i, :, 0].double() - one.double()).abs().max().item() \
            <= tol * one.double().abs().max().item()


def test_batch_refusals_and_count_key():
    u12 = t(_gauge()[:, :, :2])
    psi = t(_batch(2, 1, 1))
    with pytest.raises(ValueError, match="batch"):
        dslash_eo(u12, psi, 0, LAT, legs_out=True)
    with pytest.raises(ValueError, match="psi shape"):
        dslash_eo(u12, psi[None], 0, LAT)
    with pytest.raises(ValueError, match="psi0 must match"):
        dslash_eo(u12, psi, 0, LAT, epilogue="xpay", psi0=psi[0])
    dslash_cuda.reset_counts()
    dslash_eo(u12, psi, 0, LAT, dirs=((0, 1),))
    assert dict(dslash_cuda.counts) == {"plain": 1}    # the CPU runs the plain version


# --- reductions and CG on a batch --------------------------------------------

def test_column_reductions_equal_single_reductions():
    x, y = t(_batch(3, 50)), t(_batch(3, 60))
    # one float64 reduction over the flattened columns: another summation order
    np.testing.assert_allclose(n(norm2_cols(x)), [norm2(c).item() for c in x], rtol=1e-14)
    np.testing.assert_allclose(n(redot_cols(x, y)),
                               [redot(a, b).item() for a, b in zip(x, y)], rtol=1e-14)
    re, im = pk.cdot(x[:, 0], y[:, 0], cols=True)
    nn = pk.norm2(x[:, 0], cols=True)
    for i in range(3):
        r1, i1 = pk.cdot(x[i, 0], y[i, 0])
        np.testing.assert_allclose([re[i].item(), im[i].item(), nn[i].item()],
                                   [r1.item(), i1.item(), pk.norm2(x[i, 0]).item()], rtol=1e-5)
    assert re.shape == (3, 1, 1, 1, 1, 1, 1)           # broadcasts over x [3, 2, 4, 3, T, Z, S]


def test_cg_batched_matches_tpuqcd():
    u = _gauge()
    b = _batch(3, 70, parities=1)
    pc = PackedTMOperatorPC(LAT, kappa=KAPPA, mu=MU)
    from tpuqcd.operators import PackedTMOperatorPC as JPC
    jpc = JPC(JLAT, kappa=KAPPA, mu=MU, backend="xla")
    ju = u
    ref = j_cg_batched(lambda v: jpc.apply_dagger(ju, jpc.apply(ju, v)), jnp.asarray(b),
                       tol=1e-5, maxiter=200)
    res = cg_batched(lambda v: pc.normal(t(u), v), t(b), tol=1e-5, maxiter=200)
    assert res.converged and bool(ref.converged) and res.iters == int(ref.iters)
    assert max(res.relres.tolist()) <= 1e-5
    assert np.abs(n(res.x) - np.asarray(ref.x)).max() <= 1e-5 * np.abs(np.asarray(ref.x)).max()


def test_cg_refined_certifies():
    u = t(_gauge())
    pc = PackedTMOperatorPC(LAT, kappa=KAPPA, mu=MU)
    b = t(spinor_pk(LAT, 80))
    u64 = u.double()
    res = cg_refined(lambda v: pc.normal(u, v), lambda v: pc.normal(u64, v), b, tol=1e-10)
    assert res.converged and res.relres <= 1e-10 and res.x.dtype == torch.float64
    r = b - pc.normal(u64, res.x)
    assert (norm2(r) / norm2(b)).sqrt().item() <= 1e-10


# --- solve_tm_batch ----------------------------------------------------------

@pytest.fixture(scope="module")
def tm_batch():
    u = _gauge()
    b = _batch(3, 90)
    return u, b, solve_tm_batch(t(u), t(b), LAT, kappa=KAPPA, mu=MU, tol=1e-10)


def test_solve_tm_batch_equals_single_solves(tm_batch):
    u, b, res = tm_batch
    assert res.x.shape == (3, 2, 2, 4, 3, *LAT.site_shape) and res.x.dtype == torch.float64
    for i in range(3):
        one = solve_tm(t(u), t(b[i]), LAT, kappa=KAPPA, mu=MU, tol=1e-10)
        assert one.iters == res.iters[i] and one.refinements == res.refinements[i]
        assert one.relres == pytest.approx(res.relres[i], rel=1e-9)
        assert (res.x[i] - one.x).abs().max().item() <= 1e-12 * one.x.abs().max().item()
        assert full_system_relres(t(u), t(b[i]), res.x[i], LAT, kappa=KAPPA, mu=MU) < 1e-9


def test_solve_tm_batch_matches_tpuqcd(tm_batch):
    u, b, res = tm_batch
    ref = j_solve_tm_batch(u, jnp.asarray(b), JLAT, kappa=KAPPA, mu=MU, tol=1e-10,
                           backend="xla")
    assert float(jnp.max(ref.relres)) <= 1e-10 and max(res.relres) <= 1e-10
    x_ref = np.asarray(ref.x)
    for i in range(3):
        assert np.abs(n(res.x[i]) - x_ref[i]).max() <= 1e-8 * np.abs(x_ref[i]).max()


@pytest.mark.parametrize("solver,csw", [("bicgstab", 0.0), ("cg", 1.0), ("bicgstab", 1.0)])
def test_solve_tm_batch_variants_equal_single_solves(solver, csw):
    u, b = t(_gauge()), t(_batch(2, 95))
    kw = dict(kappa=KAPPA, mu=MU, tol=1e-10, solver=solver, csw=csw, flavor=-1)
    res = solve_tm_batch(u, b, LAT, **kw)
    for i in range(2):
        one = solve_tm(u, b[i], LAT, **kw)
        assert one.iters == res.iters[i] and res.relres[i] <= 1e-10
        assert (res.x[i] - one.x).abs().max().item() <= 1e-12 * one.x.abs().max().item()


# --- the lockstep MG solve ----------------------------------------------------

@pytest.fixture(scope="module")
def hierarchies(tmp_path_factory):
    """tpuqcd's hierarchy on the shared gauge, and the port's loaded from
    its npz dump."""
    kappa, mu = 0.15, 0.1
    ju = jax_gauge_pk(gauge_full(LAT, 0), JLAT, True, jnp.float32)
    jmg = JDeviceMG(jdevice.DeviceFineLevel(JLAT, ju, kappa, mu, backend="xla"),
                    JParams(**MG_PARAMS))
    path = str(tmp_path_factory.mktemp("mg") / "jax_mg.npz")
    jcheckpoint.save_device_mg(path, jmg)
    mg = load_device_mg(path, DeviceFineLevel(LAT, t(ju), kappa, mu), DeviceMGParams(**MG_PARAMS))
    return jmg, mg


def test_solve_certified_batch_matches_tpuqcd(hierarchies):
    jmg, mg = hierarchies
    b = np.stack([np.random.default_rng(40 + i).standard_normal(
        (2, 2, 4, 3, *LAT.site_shape)).astype(np.float32) for i in range(3)])
    b[1] *= 1e-3
    b[2] = 0.0
    res = mg.solve_certified_batch(t(b), tol=1e-10, inner_tol=1e-4, max_refine=20)
    assert max(res.relres) <= 1e-10 and res.relres[2] == 0.0
    assert res.x.dtype == torch.float64 and res.x[2].abs().max().item() == 0.0
    x_j, rel_j, _ = jmg.solve_certified_batch(jnp.asarray(b), tol=1e-10, inner_tol=1e-4,
                                              max_refine=20)
    assert rel_j.max() <= 1e-10
    for i in range(2):
        got, want = n(res.x[i]), np.asarray(x_j[i])
        assert np.linalg.norm(got - want) <= 1e-6 * np.linalg.norm(want)


def test_solve_tm_mg_batch_against_single_solves(hierarchies):
    _, mg = hierarchies
    b = t(_batch(2, 45))
    res = solve_tm_mg_batch(mg, b, tol=1e-10, inner_tol=1e-4)
    assert res.x.shape == b.shape and max(res.relres) <= 1e-10
    assert len(set(res.iters)) == 1                     # the common count
    for i in range(2):
        one = solve_tm_mg(mg, b[i], tol=1e-10, inner_tol=1e-4)
        assert (res.x[i] - one.x).abs().max().item() <= 1e-8 * one.x.abs().max().item()


def test_batch_memory_sum(hierarchies):
    _, mg = hierarchies
    # a float32 fine field and a float32 field of the coarse level: a column
    # counts both levels' bases and work fields (DeviceMG.batch_buffers)
    fine = 4 * 2 * 2 * 12 * LAT.half_volume
    coarse = 4 * 2 * mg.levels[1].n * mg.levels[1].Vc
    basis = 2 * MG_PARAMS["restart"]
    assert mg.batch_bytes(3) - mg.batch_bytes(0) == 3 * ((basis + 16) * fine
                                                         + (basis + 23) * coarse)
    mg._check_batch_fits(10 ** 6)                       # no card here: nothing to check
