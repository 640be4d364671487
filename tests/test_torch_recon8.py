"""Reconstruct-8 links (K5) and compute="bf16" of the port's Dslash
against tpuqcd.

On the CPU the dispatch runs the plain PyTorch version.  Tolerances:
pack_gauge8 entry for entry against tpuqcd's on float64 input (the same
formulas; 1e-12, angles included: no link of the seeded gauge sits near
a branch cut or a pivot tie), its round trip 1e-12 (float64) and 5e-6
(float32 storage); the reconstruct-8 hop against the Pallas kernel in
interpret mode 5e-5 absolute, as tests/test_dslash_pallas.py:244;
compute="bf16" 5% of max|ref| against the Pallas kernel's bf16
arithmetic and against float32 arithmetic, as test_dslash_pallas.py:269
(the two round in different orders)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd.ops.dslash_pallas import dslash_eo_pallas
from tpuqcd.utils import packed as jpacked

from tpuqcd_torch.operators import PackedTMOperatorPC
from tpuqcd_torch.ops.dslash_cuda import dslash_eo, expand_links
from tpuqcd_torch.utils.convert import packed_from_numpy
from tpuqcd_torch.utils.packed import (pack_gauge, pack_gauge8, recon8_rows, unpack_gauge,
                                       unpack_gauge8)

from _torch_inputs import gauge_full, jax_gauge_pk, lattices, n, spinor_pk, t

LAT, JLAT = lattices((4, 4, 4, 8))
KAPPA, MU = 0.13, 0.06


def _jax_fields(antiperiodic_t=True):
    """(jax 18-real f64 gauge, jax psi f32, jax psi0 f32)."""
    u = jax_gauge_pk(gauge_full(LAT, 0), JLAT, antiperiodic_t, jnp.float64)
    return (u, jnp.asarray(spinor_pk(LAT, 1), jnp.float32),
            jnp.asarray(spinor_pk(LAT, 2), jnp.float32))


@pytest.mark.parametrize("antiperiodic_t", [True, False])
def test_pack_gauge8_matches_tpuqcd_entry_for_entry(antiperiodic_t):
    u, _, _ = _jax_fields(antiperiodic_t)
    uc = np.asarray(jpacked.unpack_gauge(u)).astype(np.complex128)   # float32 values
    ref = np.asarray(jpacked.pack_gauge8(jnp.asarray(uc), jnp.float64))
    got = pack_gauge8(t(uc), torch.float64)
    assert got.shape == ref.shape == (4, 2, 4, 1, 2, *LAT.site_shape) and got.is_contiguous()
    np.testing.assert_allclose(n(got), ref, atol=1e-12, rtol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 5e-6)])
def test_pack_gauge8_round_trips(dtype, tol):
    u, _, _ = _jax_fields()
    uc = unpack_gauge(t(u))
    back = unpack_gauge8(pack_gauge8(uc, dtype))
    # rows 0 and 1 as stored; the rebuilt row 2 lacks the boundary phase
    np.testing.assert_allclose(n(torch.view_as_real(back[:, :, :2])),
                               n(torch.view_as_real(uc[:, :, :2])), atol=tol, rtol=0)
    row2 = uc[:, :, 2].clone()
    row2[3, :, :, LAT.Lt - 1] *= -1
    np.testing.assert_allclose(n(torch.view_as_real(back[:, :, 2])),
                               n(torch.view_as_real(row2)), atol=tol, rtol=0)


def test_unpack_gauge8_matches_tpuqcd():
    u, _, _ = _jax_fields()
    u8 = jpacked.pack_gauge8(jpacked.unpack_gauge(u), jnp.float32)
    ref = np.asarray(jpacked.unpack_gauge8(u8))
    got = unpack_gauge8(t(u8))
    np.testing.assert_allclose(n(torch.view_as_real(got)),
                               np.stack([ref.real, ref.imag], -1), atol=5e-6, rtol=0)


def test_pivot_branch_is_taken_from_the_stored_values():
    """A link with |u01| = |u02| to the last bit of the storage dtype: the
    packer and the reconstruction take the same branch, whichever."""
    u, _, _ = _jax_fields()
    uc = unpack_gauge(t(u)).clone()
    # rotate one link so that rows 0's entries 1 and 2 tie in magnitude
    r0 = uc[0, 0, 0, :, 0, 0, 0]
    m = torch.sqrt((r0[1].abs() ** 2 + r0[2].abs() ** 2) / 2)
    v = torch.stack([r0[0], m * r0[1] / r0[1].abs(), m * r0[2] / r0[2].abs()])
    w = uc[0, 0, 1, :, 0, 0, 0]
    w = w - (v.conj() @ w) * v
    w = w / torch.linalg.vector_norm(w)
    uc[0, 0, :, :, 0, 0, 0] = torch.stack([v, w, torch.linalg.cross(v, w).conj()])
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 5e-6), (torch.bfloat16, 0.05)):
        back = unpack_gauge8(pack_gauge8(uc, dtype))[0, 0, :2, :, 0, 0, 0]
        assert (back - uc[0, 0, :2, :, 0, 0, 0]).abs().max().item() <= tol, dtype


@pytest.mark.parametrize("epilogue,parity,dagger,antiperiodic_t", [
    ("none", 0, False, True), ("none", 1, True, True), ("twist_inv", 1, False, True),
    ("twist_inv", 0, True, False), ("xpay", 0, False, False), ("none", 1, False, False)])
def test_recon8_matches_pallas(epilogue, parity, dagger, antiperiodic_t):
    u, psi, psi0 = _jax_fields(antiperiodic_t)
    u8 = jpacked.pack_gauge8(jpacked.unpack_gauge(u), jnp.float32)
    kw = dict(dagger=dagger, epilogue=epilogue, kappa=KAPPA, mu=MU,
              t_boundary=-1 if antiperiodic_t else 1)
    ref = np.asarray(dslash_eo_pallas(u8, psi, parity, JLAT, interpret=True,
                                      psi0_pk=psi0 if epilogue == "xpay" else None, **kw))
    # tpuqcd's 8 reals carried across as numpy, and the port's own packing
    carried = packed_from_numpy(np.asarray(u8), LAT)
    own = pack_gauge8(unpack_gauge(t(u)), torch.float32)
    for u8_t in (carried, own):
        out = dslash_eo(u8_t, t(psi), parity, LAT,
                        psi0=t(psi0) if epilogue == "xpay" else None, **kw)
        np.testing.assert_allclose(n(out), ref, atol=5e-5, rtol=0)


def test_recon8_equals_the_18_real_hop_in_float64():
    u, psi, _ = _jax_fields()
    u18 = t(u)
    u8 = pack_gauge8(unpack_gauge(u18), torch.float64)
    psi = t(psi, torch.float64)
    for parity in (0, 1):
        a = dslash_eo(u8, psi, parity, LAT)
        b = dslash_eo(u18, psi, parity, LAT)
        np.testing.assert_allclose(n(a), n(b), atol=1e-12, rtol=0)
    # a wrong t_boundary leaves the rebuilt row without its phase
    wrong = dslash_eo(u8, psi, 0, LAT, t_boundary=1)
    assert (wrong - dslash_eo(u18, psi, 0, LAT)).abs().max().item() > 1e-3


def test_expand_links_recon8_with_t_offset():
    """The boundary phase of the rebuilt row is a global-t condition: a
    shard that does not hold the last global timeslice rebuilds without it."""
    u, _, _ = _jax_fields()
    u8 = pack_gauge8(unpack_gauge(t(u)), torch.float64)
    whole = expand_links(u8, LAT)
    shifted = expand_links(u8, LAT, t_offset=0, t_global=2 * LAT.Lt)   # boundary elsewhere
    nt = whole.shape[-1] // LAT.Lt
    last = slice((LAT.Lt - 1) * nt, None)
    np.testing.assert_allclose(n(torch.view_as_real(whole[3, :, 2, :, last])),
                               -n(torch.view_as_real(shifted[3, :, 2, :, last])), atol=1e-14)
    rows = recon8_rows(u8.reshape(4, 2, 8, -1))
    np.testing.assert_allclose(n(torch.view_as_real(rows)),
                               n(torch.view_as_real(whole[:, :, :2])), atol=0)


@pytest.mark.parametrize("antiperiodic_t", [True, False])
def test_recon8_halo_shards_stitch_to_the_whole_hop(antiperiodic_t):
    """Reconstruct-8 in halo mode on an emulated (2, 2) decomposition: each
    shard rebuilds its own and the face links, with the boundary phase by
    its global t_offset, and equals its part of the unsharded hop."""
    from tpuqcd_torch.parallel.mesh import LatticeMesh
    from tpuqcd_torch.parallel.sharded import cut_halo
    u, psi, _ = _jax_fields(antiperiodic_t)
    u8 = pack_gauge8(unpack_gauge(t(u)), torch.float64)
    psi = t(psi, torch.float64)
    tb = -1 if antiperiodic_t else 1
    for parity in (0, 1):
        for dagger in (False, True):
            whole = dslash_eo(u8, psi, parity, LAT, dagger=dagger, t_boundary=tb)
            for rank in range(4):
                m = LatticeMesh(LAT, 2, 2, 1, rank)
                ul, pl, halo = cut_halo(m, u8, psi, parity, dagger)
                assert tuple(halo.u_t.shape[:3]) == (4, 1, 2)
                out = dslash_eo(ul, pl, parity, m.local_lat, dagger=dagger, halo=halo,
                                t_boundary=tb)
                np.testing.assert_allclose(n(out), n(m.shard(whole)), atol=1e-12, rtol=0)


def test_operator_takes_reconstruct8_links_by_their_shape():
    """No option selects reconstruct-8: an 8-real gauge handed to the
    even-odd operator gives Mhat and Mhat^dag of the 18-real gauge."""
    u, psi, _ = _jax_fields()
    u18 = t(u)
    u8 = pack_gauge8(unpack_gauge(u18), torch.float64)
    v = t(psi, torch.float64)
    pc = PackedTMOperatorPC(LAT, kappa=KAPPA, mu=MU)
    for f in (pc.apply, pc.apply_dagger):
        np.testing.assert_allclose(n(f(u8, v)), n(f(u18, v)), atol=1e-12, rtol=0)


# --- compute="bf16" ---------------------------------------------------------

@pytest.mark.parametrize("epilogue", ["none", "twist_inv", "xpay"])
def test_compute_bf16_matches_pallas_and_float32_arithmetic(epilogue):
    u, psi, psi0 = _jax_fields()
    u12, psi, psi0 = (x.astype(jnp.bfloat16) for x in (u[:, :, :2], psi, psi0))
    kw = dict(epilogue=epilogue, kappa=KAPPA, mu=MU)
    jp0 = psi0 if epilogue == "xpay" else None
    ref = np.asarray(dslash_eo_pallas(u12, psi, 0, JLAT, interpret=True, psi0_pk=jp0,
                                      compute="bf16", **kw).astype(jnp.float32))
    f32 = np.asarray(dslash_eo_pallas(u12, psi, 0, JLAT, interpret=True, psi0_pk=jp0,
                                      **kw).astype(jnp.float32))
    bf = lambda x: t(x.astype(jnp.float32), torch.bfloat16)   # noqa: E731
    out = dslash_eo(bf(u12), bf(psi), 0, LAT, compute="bf16",
                    psi0=bf(psi0) if epilogue == "xpay" else None, **kw)
    assert out.dtype == torch.bfloat16
    for want in (ref, f32):
        assert np.abs(n(out) - want).max() <= 0.05 * np.abs(want).max()


def test_compute_bf16_needs_bfloat16_storage():
    u, psi, _ = _jax_fields()
    with pytest.raises(ValueError, match="bfloat16"):
        dslash_eo(t(u[:, :, :2], torch.float32), t(psi), 0, LAT, compute="bf16")
    with pytest.raises(ValueError, match="compute"):
        dslash_eo(t(u[:, :, :2], torch.float32), t(psi), 0, LAT, compute="f16")
