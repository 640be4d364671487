"""The port's PackedTMOperatorPC against tpuqcd's.

float64 (18-real gauge): against tpuqcd's backend "xla", 1e-12 abs.
float32 (reconstruct-12 gauge, as solve_tm builds it): against tpuqcd's
backend "pallas" in interpret mode, 3e-5 abs as in test_dslash_pallas.py.
The full two-parity M (the certification operator of full_system_relres)
against tpuqcd's DeviceFineLevel, backend "xla", 1e-12 abs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd.mg.device import DeviceFineLevel
from tpuqcd.operators import (PackedTMOperatorPC as JOp, gamma5_apply_pk as j_g5,
                              twist_apply_pk as j_twist, twist_inv_apply_pk as j_twist_inv)

from tpuqcd_torch.operators import (PackedTMOperatorPC, gamma5_apply_pk, twist_apply_pk,
                                    twist_inv_apply_pk)

from _torch_inputs import gauge_full, jax_gauge_pk, lattices, n, spinor_pk, t

LAT, JLAT = lattices((4, 6, 4, 8))
KAPPA, MU = 0.13, 0.06


def _problem(jdtype):
    u = jax_gauge_pk(gauge_full(LAT, 20), JLAT, True, jdtype)
    psi = jnp.asarray(spinor_pk(LAT, 21), jdtype)
    b = jnp.asarray(spinor_pk(LAT, 22, parities=2), jdtype)
    return u, psi, b


@pytest.mark.parametrize("flavor", [1, -1])
def test_twist_helpers_match(flavor):
    psi = spinor_pk(LAT, 23)
    for port, ref in ((twist_apply_pk, j_twist), (twist_inv_apply_pk, j_twist_inv)):
        np.testing.assert_allclose(n(port(t(psi), KAPPA, MU, flavor)),
                                   np.asarray(ref(jnp.asarray(psi), KAPPA, MU, flavor)),
                                   atol=1e-15, rtol=0)
    np.testing.assert_array_equal(n(gamma5_apply_pk(t(psi))), np.asarray(j_g5(jnp.asarray(psi))))
    # A^{-1} A = 1
    torch.testing.assert_close(
        twist_inv_apply_pk(twist_apply_pk(t(psi), KAPPA, MU, flavor), KAPPA, MU, flavor),
        t(psi), atol=1e-14, rtol=0)


@pytest.mark.parametrize("flavor", [1, -1])
def test_operator_f64_matches_tpuqcd_xla(flavor):
    u, psi, b = _problem(jnp.float64)
    ref = JOp(JLAT, kappa=KAPPA, mu=MU, flavor=flavor, backend="xla")
    op = PackedTMOperatorPC(LAT, kappa=KAPPA, mu=MU, flavor=flavor)
    tu, tpsi, tb = t(u), t(psi), t(b)
    pairs = [(op.apply(tu, tpsi), ref.apply(u, psi)),
             (op.apply_dagger(tu, tpsi), ref.apply_dagger(u, psi)),
             (op.normal(tu, tpsi), ref.normal(u, psi)),
             (op.prepare(tu, tb), ref.prepare(u, b)),
             (op.reconstruct(tu, tpsi, tb), ref.reconstruct(u, psi, b))]
    for got, want in pairs:
        np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-12, rtol=0)


def test_operator_f32_recon12_matches_tpuqcd_pallas():
    u, psi, b = _problem(jnp.float32)
    ref = JOp(JLAT, kappa=KAPPA, mu=MU, backend="pallas", interpret=True)
    op = PackedTMOperatorPC(LAT, kappa=KAPPA, mu=MU)
    tu12, tpsi, tb = t(u[:, :, :2]), t(psi), t(b)
    pairs = [(op.apply(tu12, tpsi), ref.apply(u, psi)),
             (op.apply_dagger(tu12, tpsi), ref.apply_dagger(u, psi)),
             (op.prepare(tu12, tb), ref.prepare(u, b)),
             (op.reconstruct(tu12, tpsi, tb), ref.reconstruct(u, psi, b))]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(n(got), np.asarray(want), atol=3e-5, rtol=0)


def test_dagger_is_the_adjoint():
    """<chi, Mhat psi> = <Mhat^dag chi, psi> (complex inner product)."""
    u, psi, b = (t(a) for a in _problem(jnp.float64))
    chi = b[0]
    op = PackedTMOperatorPC(LAT, kappa=KAPPA, mu=MU)

    def cdot(x, y):
        xc, yc = torch.complex(x[0], x[1]), torch.complex(y[0], y[1])
        return torch.sum(xc.conj() * yc)
    lhs = cdot(chi, op.apply(u, psi))
    rhs = cdot(op.apply_dagger(u, chi), psi)
    assert abs(lhs - rhs) < 1e-10 * abs(lhs)


def test_apply_full_matches_device_fine_level():
    u, _, x = _problem(jnp.float64)
    lvl = DeviceFineLevel(JLAT, u, KAPPA, MU, 1, backend="xla")
    ref = np.swapaxes(np.asarray(lvl.apply(jnp.swapaxes(x, 0, 1))), 0, 1)
    op = PackedTMOperatorPC(LAT, kappa=KAPPA, mu=MU)
    np.testing.assert_allclose(n(op.apply_full(t(u), t(x))), ref, atol=1e-12, rtol=0)
