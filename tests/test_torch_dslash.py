"""The port's Dslash (ops/dslash_cuda.py) against tpuqcd.

On the CPU the dispatch runs the plain PyTorch version; the CUDA kernel
is held against that plain version on the card (test_torch_kernels_gpu,
chip_smoke.py).  Tolerances: float64 18-real against dslash_eo_dev_ri
1e-12 abs (both are f64 sums of the same terms); float32 reconstruct-12
against the Pallas kernel in interpret mode 2e-5 abs, as in
test_dslash_pallas.py; bfloat16 storage one bf16 ulp relative (2^-7),
since both round the same float32 result.  The leg modes (K4: dirs,
legs_out) against the Pallas kernel in interpret mode, 2e-5 abs, as in
test_dslash_pallas.py:172-215."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd.ops.dslash_pallas import dslash_eo_pallas
from tpuqcd.ops.dslash_xla import dslash_eo_dev_ri

from tpuqcd_torch.ops import dslash_cuda
from tpuqcd_torch.ops.dslash_cuda import LEG_ORDER, dslash_eo, dslash_eo_plain, hop_index

from _torch_inputs import gauge_full, jax_gauge_pk, lattices, n, spinor_pk, t

LAT, JLAT = lattices((4, 6, 4, 8))
KAPPA, MU = 0.13, 0.06


def _fields(dtype=np.float64, antiperiodic_t=True):
    """(jax gauge, jax psi, jax psi0) packed, all of numpy dtype ``dtype``."""
    jd = {np.float64: jnp.float64, np.float32: jnp.float32}[dtype]
    u = jax_gauge_pk(gauge_full(LAT, 0), JLAT, antiperiodic_t, jd)
    return u, jnp.asarray(spinor_pk(LAT, 1), jd), jnp.asarray(spinor_pk(LAT, 2), jd)


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("dagger", [False, True])
def test_plain_f64_matches_dslash_eo_dev_ri(parity, dagger):
    u, psi, _ = _fields()
    ref = np.asarray(dslash_eo_dev_ri(u, psi, parity, JLAT, dagger=dagger))
    out = dslash_eo(t(u), t(psi), parity, LAT, dagger=dagger)
    assert out.dtype == torch.float64 and out.shape == psi.shape
    np.testing.assert_allclose(n(out), ref, atol=1e-12, rtol=0)


@pytest.mark.parametrize("epilogue,parity,dagger", [
    ("none", 0, False), ("none", 1, False), ("none", 0, True), ("none", 1, True),
    ("twist_inv", 0, False), ("twist_inv", 1, True),
    ("xpay", 1, False), ("xpay", 0, True)])
def test_plain_f32_recon12_matches_pallas(epilogue, parity, dagger):
    u, psi, psi0 = _fields(np.float32)
    u12 = u[:, :, :2]
    kw = dict(dagger=dagger, epilogue=epilogue, kappa=KAPPA, mu=MU, t_boundary=-1)
    ref = np.asarray(dslash_eo_pallas(u12, psi, parity, JLAT, interpret=True,
                                      psi0_pk=psi0 if epilogue == "xpay" else None, **kw))
    out = dslash_eo(t(u12), t(psi), parity, LAT,
                    psi0=t(psi0) if epilogue == "xpay" else None, **kw)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(n(out), ref, atol=2e-5, rtol=0)


def test_plain_bf16_storage_matches_pallas():
    u, psi, psi0 = _fields(np.float32)
    u12, psi, psi0 = (x.astype(jnp.bfloat16) for x in (u[:, :, :2], psi, psi0))
    kw = dict(epilogue="xpay", kappa=KAPPA, mu=MU)
    ref = np.asarray(dslash_eo_pallas(u12, psi, 1, JLAT, interpret=True, psi0_pk=psi0,
                                      **kw).astype(jnp.float32))
    out = dslash_eo(t(u12.astype(jnp.float32), torch.bfloat16),
                    t(psi.astype(jnp.float32), torch.bfloat16), 1, LAT,
                    psi0=t(psi0.astype(jnp.float32), torch.bfloat16), **kw)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(n(out), ref, rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("antiperiodic_t", [True, False])
def test_recon12_restores_the_boundary_phase(antiperiodic_t):
    """Reconstruct-12 with t_boundary equal to the folded phase gives the
    18-real hop; a wrong t_boundary does not."""
    u, psi, _ = _fields(antiperiodic_t=antiperiodic_t)
    tb = -1 if antiperiodic_t else 1
    u18, u12, x = t(u), t(u[:, :, :2]), t(psi)
    for parity in (0, 1):
        full = dslash_eo(u18, x, parity, LAT)
        torch.testing.assert_close(dslash_eo(u12, x, parity, LAT, t_boundary=tb), full,
                                   atol=1e-12, rtol=0)
        assert (dslash_eo(u12, x, parity, LAT, t_boundary=-tb) - full).abs().max() > 1e-3


def test_xpay_scale_gives_the_full_operator_row():
    """xpay with xpay_scale=kappa is (1 + i tw g5) psi0 - kappa D psi."""
    u, psi, psi0 = (t(a) for a in _fields())
    d = dslash_eo(u, psi, 0, LAT)
    tw = 2 * KAPPA * MU
    g5 = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=torch.float64)[:, None, None, None, None]
    ref = torch.stack([psi0[0] - tw * g5 * psi0[1], psi0[1] + tw * g5 * psi0[0]]) - KAPPA * d
    out = dslash_eo(u, psi, 0, LAT, epilogue="xpay", kappa=KAPPA, mu=MU, psi0=psi0,
                    xpay_scale=KAPPA)
    torch.testing.assert_close(out, ref, atol=1e-13, rtol=0)


def test_hop_index_is_a_permutation_with_the_eo_x_rule():
    T, Z, S = LAT.site_shape
    Xh = LAT.Lx // 2
    for p in (0, 1):
        idx = hop_index(LAT, p)
        assert idx.shape == (4, 2, T * Z * S)
        for mu in range(4):
            for d in range(2):
                assert torch.equal(idx[mu, d].sort().values, torch.arange(T * Z * S))
        # x legs: forward and backward are inverse maps
        fwd, bwd = idx[0, 0], idx[0, 1]
        site = torch.arange(T * Z * S)
        o_p = ((site // (Xh * LAT.Ly * Z) + site // (Xh * LAT.Ly) % Z
                + site // Xh % LAT.Ly + p) % 2) == 1
        assert torch.equal(fwd[o_p], site[o_p]) and torch.equal(bwd[~o_p], site[~o_p])


def test_dispatch_checks_and_counts():
    u, psi, psi0 = (t(a) for a in _fields(np.float32))
    dslash_cuda.reset_counts()
    dslash_eo(u, psi, 0, LAT)
    assert dslash_cuda.counts == {"plain": 1}
    with pytest.raises(ValueError, match="not contiguous"):
        dslash_eo(u[:, :, :2], psi, 0, LAT)         # a reconstruct-12 view
    with pytest.raises(ValueError, match="dtype"):
        dslash_eo(u, psi.double(), 0, LAT)
    with pytest.raises(ValueError, match="psi0"):
        dslash_eo(u, psi, 0, LAT, epilogue="xpay")
    with pytest.raises(ValueError, match="epilogue"):
        dslash_eo(u, psi, 0, LAT, epilogue="clover_inv")
    with pytest.raises(ValueError, match="src_parity"):
        dslash_eo(u, psi, 2, LAT)
    with pytest.raises(ValueError, match="psi shape"):
        dslash_eo(u, psi[:, :, :, :4], 0, LAT)
    with pytest.raises(ValueError, match="float32, bfloat16 or float64"):
        dslash_eo(u.half(), psi.half(), 0, LAT)
    assert dslash_cuda.counts == {"plain": 1}
    out = dslash_eo_plain(u, psi, 1, LAT, epilogue="xpay", kappa=KAPPA, mu=MU, psi0=psi0)
    assert out.shape == psi.shape and dslash_cuda.counts == {"plain": 2}


@pytest.mark.parametrize("rows,parity,dagger", [(2, 0, False), (2, 1, True), (3, 1, False),
                                                (3, 0, True)])
def test_plain_legs_out_matches_pallas(rows, parity, dagger):
    """legs_out: the 8 legs in LEG_ORDER against the Pallas kernel's
    legs_out slots; each single dirs leg against its slot; the slots sum
    to the full hop."""
    u, psi, _ = _fields(np.float32)
    u_j = u[:, :, :rows]
    kw = dict(dagger=dagger, t_boundary=-1)
    ref = np.asarray(dslash_eo_pallas(u_j, psi, parity, JLAT, interpret=True, legs_out=True,
                                      **kw))
    uu, x = t(u_j), t(psi)
    legs = dslash_eo(uu, x, parity, LAT, legs_out=True, **kw)
    assert legs.shape == (8, *psi.shape) and legs.dtype == torch.float32
    np.testing.assert_allclose(n(legs), ref, atol=2e-5, rtol=0)
    for i, leg in enumerate(LEG_ORDER):
        np.testing.assert_allclose(n(dslash_eo(uu, x, parity, LAT, dirs=(leg,), **kw)),
                                   ref[i], atol=2e-5, rtol=0, err_msg=str(leg))
    full = dslash_eo(uu, x, parity, LAT, **kw)
    torch.testing.assert_close(legs.sum(0), full, atol=5e-5, rtol=0)


@pytest.mark.parametrize("parity,dagger", [(0, False), (1, True)])
def test_plain_dirs_single_legs_match_pallas(parity, dagger):
    """dirs with one leg each against the Pallas dirs filter, and a
    three-leg dirs sum with the twist_inv epilogue on top."""
    u, psi, _ = _fields(np.float32)
    u12 = u[:, :, :2]
    for leg in LEG_ORDER:
        ref = np.asarray(dslash_eo_pallas(u12, psi, parity, JLAT, interpret=True,
                                          dirs=(leg,), dagger=dagger))
        out = dslash_eo(t(u12), t(psi), parity, LAT, dirs=(leg,), dagger=dagger)
        np.testing.assert_allclose(n(out), ref, atol=2e-5, rtol=0, err_msg=str(leg))
    dirs = ((2, -1), (0, +1), (3, +1))
    kw = dict(dirs=dirs, dagger=dagger, epilogue="twist_inv", kappa=KAPPA, mu=MU)
    ref = np.asarray(dslash_eo_pallas(u12, psi, parity, JLAT, interpret=True, **kw))
    np.testing.assert_allclose(n(dslash_eo(t(u12), t(psi), parity, LAT, **kw)), ref,
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("parity", [0, 1])
def test_plain_legs_out_subset_slot_order(parity):
    """A dirs subset given out of order: the slots follow LEG_ORDER, as
    the Pallas kernel's do."""
    u, psi, _ = _fields(np.float32)
    u12 = u[:, :, :2]
    subset = ((3, -1), (0, +1), (2, +1))
    ref = np.asarray(dslash_eo_pallas(u12, psi, parity, JLAT, interpret=True, legs_out=True,
                                      dirs=subset))
    out = dslash_eo(t(u12), t(psi), parity, LAT, legs_out=True, dirs=subset)
    assert out.shape == (3, *psi.shape)
    np.testing.assert_allclose(n(out), ref, atol=2e-5, rtol=0)
    for slot, leg in zip(out, sorted(subset, key=LEG_ORDER.index)):
        torch.testing.assert_close(slot, dslash_eo(t(u12), t(psi), parity, LAT, dirs=(leg,)),
                                   atol=0, rtol=0)


def test_leg_modes_on_parity_views_and_checks():
    """The MG field layout: operands and outputs as parity views of
    [2(ri), 2(par), ...] fields, written in place; and the leg checks."""
    u, psi, psi0 = (t(a) for a in _fields(np.float32))
    field = torch.stack([psi0, psi], dim=1)              # [2, 2(par), 4, 3, T, Z, S]
    out = torch.zeros_like(field)
    ret = dslash_eo(u, field[:, 1], 1, LAT, epilogue="xpay", kappa=KAPPA, mu=MU,
                    psi0=field[:, 0], out=out[:, 0])
    assert ret.data_ptr() == out.data_ptr()
    torch.testing.assert_close(out[:, 0], dslash_eo(u, psi, 1, LAT, epilogue="xpay",
                                                    kappa=KAPPA, mu=MU, psi0=psi0),
                               atol=0, rtol=0)
    assert out[:, 1].abs().max() == 0
    bank = torch.zeros((8, *field.shape))
    dslash_eo(u, field[:, 1], 1, LAT, legs_out=True, out=bank[:, :, 0])
    torch.testing.assert_close(bank[:, :, 0], dslash_eo(u, psi, 1, LAT, legs_out=True),
                               atol=0, rtol=0)
    with pytest.raises(ValueError, match="legs_out composes"):
        dslash_eo(u, psi, 0, LAT, legs_out=True, epilogue="twist_inv")
    with pytest.raises(ValueError, match="dirs entries"):
        dslash_eo(u, psi, 0, LAT, dirs=((4, 1),))
    with pytest.raises(ValueError, match="twice"):
        dslash_eo(u, psi, 0, LAT, dirs=((1, 1), (1, 1)))
    with pytest.raises(ValueError, match="empty"):
        dslash_eo(u, psi, 0, LAT, dirs=())
    with pytest.raises(ValueError, match="out must be"):
        dslash_eo(u, psi, 0, LAT, legs_out=True, out=torch.empty_like(psi))
    with pytest.raises(ValueError, match="within its re/im planes"):
        dslash_eo(u, psi.transpose(-1, -2).contiguous().transpose(-1, -2), 0, LAT)
