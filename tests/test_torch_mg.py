"""The port's MG building blocks against tpuqcd on the CPU: the packed
algebra (utils/pkalg), the Krylov solvers (solvers/krylov_pk), the fine
and coarse levels, the transfers and the Galerkin links
(mg/device.py).  Inputs are numpy arrays made from seeds and handed to
both packages; tpuqcd's MG runs with backend="xla", as in
test_mg_device.py.

Tolerances: 1e-5 (relative to the largest entry) wherever both sides
compute the same float32 sums in another order; 1e-12 for the float64
operator; exact equality for pure data movement."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd.mg import device as jdevice
from tpuqcd.solvers import krylov_pk as jkr
from tpuqcd.utils import pkalg as jpk

from tpuqcd_torch.mg.device import (DeviceCoarseLevel, DeviceCoarseTransfer, DeviceFineLevel,
                                    _coarse_colors, _hop_full, build_coarse_device, g5_fine)
from tpuqcd_torch.ops import dslash_cuda
from tpuqcd_torch.ops.dslash_cuda import LEG_ORDER
from tpuqcd_torch.solvers import krylov_pk as kr
from tpuqcd_torch.utils import pkalg as pk
from tpuqcd_torch.utils.convert import fine_transfer_from_numpy

from _torch_inputs import gauge_full, jax_gauge_pk, lattices, n, t

LAT, JLAT = lattices((4, 4, 4, 8))
KAPPA, MU = 0.15, 0.1
BLOCK = (2, 2, 2, 2)


def _close(got, want, tol=1e-5):
    """max |got - want| <= tol * max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _levels(lat=LAT, jlat=JLAT, seed=0):
    u = jax_gauge_pk(gauge_full(lat, seed), jlat, True, jnp.float32)
    return (jdevice.DeviceFineLevel(jlat, u, KAPPA, MU, backend="xla"),
            DeviceFineLevel(lat, t(u), KAPPA, MU))


def _field(lat, seed, lead=()):
    return np.random.default_rng(seed).standard_normal(
        (*lead, 2, 2, 4, 3, *lat.site_shape)).astype(np.float32)


# --- utils/pkalg -------------------------------------------------------------

@pytest.mark.parametrize("n_", [5, 12])
def test_cholesky_and_tril_inverse_match_tpuqcd(n_):
    rng = np.random.default_rng(n_)
    a = rng.standard_normal((7, n_, n_)) + 1j * rng.standard_normal((7, n_, n_))
    g = np.einsum("sij,skj->sik", a, a.conj()) + 3 * np.eye(n_)
    g_pk = np.stack([g.real, g.imag]).transpose(0, 2, 3, 1).astype(np.float32)
    L_j = jpk.cholesky_pk(jnp.asarray(g_pk), n_)
    L = pk.cholesky_pk(t(g_pk), n_)
    _close(n(L), L_j)
    _close(n(pk.tril_inverse_pk(L, n_)), jpk.tril_inverse_pk(L_j, n_))
    Lc = (n(L)[0] + 1j * n(L)[1]).transpose(2, 0, 1)
    np.testing.assert_allclose(Lc, np.linalg.cholesky(g), atol=2e-4)


def test_packed_algebra_matches_tpuqcd():
    rng = np.random.default_rng(3)
    x, y = (rng.standard_normal((2, 5, 7)).astype(np.float32) for _ in range(2))
    xj, yj, xt, yt = jnp.asarray(x), jnp.asarray(y), t(x), t(y)
    for got, want in zip(pk.cdot(xt, yt), jpk.cdot(xj, yj)):
        assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    assert abs(pk.norm2(xt).item() - float(jpk.norm2(xj))) <= 1e-5 * float(jpk.norm2(xj))
    a = (torch.tensor(0.3), torch.tensor(-1.2))
    _close(n(pk.caxpy(*a, xt, yt)), jpk.caxpy(0.3, -1.2, xj, yj), 1e-6)
    _close(n(pk.caxpy(0.3, -1.2, xt, yt)), jpk.caxpy(0.3, -1.2, xj, yj), 1e-6)
    _close(n(pk.cscale(*a, xt)), jpk.cscale(0.3, -1.2, xj), 1e-6)
    b = (torch.tensor(2.0), torch.tensor(0.5))
    for got, want in zip(pk.sdiv(a, b), jpk.sdiv((0.3, -1.2), (2.0, 0.5))):
        assert abs(got.item() - float(want)) < 1e-6
    for got, want in zip(pk.smul(a, b), jpk.smul((0.3, -1.2), (2.0, 0.5))):
        assert abs(got.item() - float(want)) < 1e-6
    zero = (torch.tensor(0.0), torch.tensor(0.0))
    assert all(torch.isfinite(v) for v in pk.sdiv(a, zero))   # the 1e-30 floor


# --- solvers/krylov_pk ---------------------------------------------------------

def _dense_operator(seed=4, m=48):
    """A well-conditioned complex m x m operator on packed [2, 8, 6]
    fields, as (torch matvec, jax matvec)."""
    rng = np.random.default_rng(seed)
    a = 2 * np.eye(m) + 0.5 * (rng.standard_normal((m, m))
                               + 1j * rng.standard_normal((m, m))) / np.sqrt(m)
    ar, ai = a.real.astype(np.float32), a.imag.astype(np.float32)

    def mv_t(x):
        xr, xi = x[0].reshape(-1), x[1].reshape(-1)
        r, i = t(ar) @ xr - t(ai) @ xi, t(ar) @ xi + t(ai) @ xr
        return torch.stack([r, i]).reshape(x.shape)

    def mv_j(x):
        xr, xi = x[0].reshape(-1), x[1].reshape(-1)
        r, i = ar @ xr - ai @ xi, ar @ xi + ai @ xr
        return jnp.stack([r, i]).reshape(x.shape)

    def nv_t(x):      # A^dag A
        y = mv_t(x)
        yr, yi = y[0].reshape(-1), y[1].reshape(-1)
        r, i = t(ar).T @ yr + t(ai).T @ yi, t(ar).T @ yi - t(ai).T @ yr
        return torch.stack([r, i]).reshape(x.shape)

    def nv_j(x):
        y = mv_j(x)
        yr, yi = y[0].reshape(-1), y[1].reshape(-1)
        r, i = ar.T @ yr + ai.T @ yi, ar.T @ yi - ai.T @ yr
        return jnp.stack([r, i]).reshape(x.shape)

    b = rng.standard_normal((2, 8, 6)).astype(np.float32)
    return mv_t, mv_j, nv_t, nv_j, b


@pytest.mark.parametrize("solver", ["mr", "cg_fixed", "gcr_fixed", "bicgstab_fixed", "gcr"])
def test_krylov_matches_tpuqcd(solver):
    mv_t, mv_j, nv_t, nv_j, b = _dense_operator()
    bt, bj = t(b), jnp.asarray(b)
    if solver == "mr":
        got, want = kr.mr_smoother_pk(mv_t, bt, 4), jkr.mr_smoother_pk(mv_j, bj, 4)
    elif solver == "cg_fixed":
        got, want = kr.cg_fixed_pk(nv_t, bt, 10), jkr.cg_fixed_pk(nv_j, bj, 10)
    elif solver == "gcr_fixed":
        got = kr.gcr_fixed_pk(mv_t, bt, iters=10, restart=4)
        want = jkr.gcr_fixed_pk(mv_j, bj, iters=10, restart=4)
    elif solver == "bicgstab_fixed":
        got, want = kr.bicgstab_fixed_pk(mv_t, bt, 6), jkr.bicgstab_fixed_pk(mv_j, bj, 6)
    else:
        res, ref = (kr.gcr_pk(mv_t, bt, tol=1e-5, restart=4),
                    jkr.gcr_pk(mv_j, bj, tol=1e-5, restart=4))
        assert res.converged and res.iters == ref.iters and res.relres <= 1e-5
        got, want = res.x, ref.x
    assert np.linalg.norm(n(got) - np.asarray(want)) <= 1e-5 * np.linalg.norm(want)


def test_mr_smoother_on_the_fine_level_matches_tpuqcd():
    jl, tl = _levels()
    b = _field(LAT, 8)
    got = kr.mr_smoother_pk(tl.apply, t(b), 4)
    want = jkr.mr_smoother_pk(jl.apply, jnp.asarray(b), 4)
    assert np.linalg.norm(n(got) - np.asarray(want)) <= 1e-5 * np.linalg.norm(want)


# --- fine level ------------------------------------------------------------------

def test_fine_level_matches_tpuqcd():
    jl, tl = _levels()
    v = _field(LAT, 1)
    _close(n(tl.apply(t(v))), jl.apply(jnp.asarray(v)))
    legs = tl.apply_hop_all(t(v))
    assert legs.shape == (8, *v.shape)
    _close(n(legs), jl.apply_hop_all(jnp.asarray(v)))
    for i, (mu, sign) in enumerate(LEG_ORDER):
        torch.testing.assert_close(_hop_full(tl, t(v), mu, sign), legs[i], atol=1e-6, rtol=0)
    # the float64 twin on the 18-real gauge against tpuqcd's f64 XLA apply
    v64 = v.astype(np.float64)
    np.testing.assert_allclose(n(tl.as_hp().apply(t(v64))),
                               np.asarray(jl.as_hp().apply(jnp.asarray(v64))),
                               atol=1e-12, rtol=0)


def test_fine_level_launch_modes_and_g5_dagger():
    """apply is 2 xpay hops, apply_hop_all 2 legs_out hops (counted as
    plain calls on the CPU); M^dag = g5 M_{-f} g5 holds for the port."""
    import dataclasses
    _, tl = _levels()
    v, w = t(_field(LAT, 2)), t(_field(LAT, 3))
    dslash_cuda.reset_counts()
    tl.apply(v)
    tl.apply_hop_all(v)
    assert dslash_cuda.counts == {"plain": 4}
    tm = dataclasses.replace(tl, flavor=-tl.flavor)
    lhs = pk.cdot(tl.apply(v), w)
    rhs = pk.cdot(v, g5_fine(tm.apply(g5_fine(w))))
    for a, b in zip(lhs, rhs):
        assert abs(a.item() - b.item()) <= 1e-5 * abs(b.item()) + 1e-3
    sl = tl.sloppy(torch.bfloat16)
    assert sl.u12.dtype == torch.bfloat16 and sl.apply(v.bfloat16()).dtype == torch.bfloat16


# --- transfers ---------------------------------------------------------------------

def test_fine_transfer_matches_tpuqcd():
    nulls = _field(LAT, 5, lead=(4,))
    jtr = jdevice.DeviceFineTransfer(JLAT, BLOCK, jnp.asarray(nulls))
    tr = fine_transfer_from_numpy(LAT, BLOCK, nulls)
    assert tr.dims_c == jtr.dims_c and tr.n_c == jtr.n_c == 8
    np.testing.assert_array_equal(n(tr.v_pk()), nulls)
    _close(n(tr.linv_pk()), jtr.linv)
    v = _field(LAT, 6)
    _close(n(tr.restrict(t(v))), jtr.restrict(jnp.asarray(v)))
    xc = np.random.default_rng(7).standard_normal((2, tr.n_c, tr.Vc)).astype(np.float32)
    _close(n(tr.prolong(t(xc))), jtr.prolong(jnp.asarray(xc)))
    # Linv handed over as tpuqcd computed it
    tr2 = fine_transfer_from_numpy(LAT, BLOCK, nulls, np.asarray(jtr.linv))
    np.testing.assert_array_equal(n(tr2.linv_pk()), np.asarray(jtr.linv))
    # a batch of fields restricts as each one does
    batch = tr.restrict(t(np.stack([v, 2 * v])))
    torch.testing.assert_close(batch[1], 2 * tr.restrict(t(v)), atol=1e-5, rtol=1e-5)


def test_transfer_identities():
    """R P = I, and <R v, w>_c = <v, P w>_f (R = P^dag), as in
    test_mg_device.py:115-135."""
    tr = fine_transfer_from_numpy(LAT, BLOCK, _field(LAT, 9, lead=(3,)))
    rng = np.random.default_rng(10)
    xc = t(rng.standard_normal((2, tr.n_c, tr.Vc)).astype(np.float32))
    torch.testing.assert_close(tr.restrict(tr.prolong(xc)), xc, atol=2e-5, rtol=0)
    v = t(_field(LAT, 11))
    for a, b in zip(pk.cdot(tr.restrict(v), xc), pk.cdot(v, tr.prolong(xc))):
        assert abs(a.item() - b.item()) <= 1e-4 * (abs(b.item()) + 1)


def test_coarse_transfer_matches_tpuqcd():
    """The second coarsening: coarse fields [2, N, Vf] -> [2, 2 n_vec, Vc]."""
    dims, n_f = (4, 2, 2, 2), 8
    rng = np.random.default_rng(12)
    nulls = rng.standard_normal((3, 2, n_f, int(np.prod(dims)))).astype(np.float32)
    jtr = jdevice.DeviceCoarseTransfer(dims, n_f, BLOCK, jnp.asarray(nulls))
    tr = DeviceCoarseTransfer.from_pk(dims, n_f, BLOCK, t(nulls))
    np.testing.assert_array_equal(n(tr.v_pk()), nulls)
    _close(n(tr.linv_pk()), jtr.linv)
    r = rng.standard_normal((2, n_f, int(np.prod(dims)))).astype(np.float32)
    _close(n(tr.restrict(t(r))), jtr.restrict(jnp.asarray(r)))
    xc = rng.standard_normal((2, tr.n_c, tr.Vc)).astype(np.float32)
    _close(n(tr.prolong(t(xc))), jtr.prolong(jnp.asarray(xc)))
    torch.testing.assert_close(tr.restrict(tr.prolong(t(xc))), t(xc), atol=2e-5, rtol=0)


# --- coarse level and Galerkin links -------------------------------------------------

def test_coarse_colors_match_tpuqcd():
    for dims in ((4, 2, 2, 2), (3, 3, 2, 2), (2, 2, 1, 3)):
        got, want = _coarse_colors(dims), jdevice._coarse_colors(dims)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_galerkin_links_match_tpuqcd_fused_and_per_leg():
    jl, tl = _levels()
    nulls = _field(LAT, 13, lead=(3,))
    jtr = jdevice.DeviceFineTransfer(JLAT, BLOCK, jnp.asarray(nulls))
    want = np.asarray(jdevice.build_coarse_device(jl, jtr).links)
    tr = fine_transfer_from_numpy(LAT, BLOCK, nulls, np.asarray(jtr.linv))
    dslash_cuda.reset_counts()
    fused = build_coarse_device(tl, tr, fused_legs=True)
    assert dslash_cuda.counts["plain"] == tr.n_c * (2 * 2 + 2)   # 2 colors, + the full probe
    per_leg = build_coarse_device(tl, tr, fused_legs=False)
    _close(n(fused.links_pk()), want)
    _close(n(per_leg.links_pk()), want)
    assert build_coarse_device(tl, tr).links_c.shape == fused.links_c.shape   # auto: fused


def test_galerkin_links_at_odd_coarse_extents():
    """(4, 4, 6, 6) with 2^4 blocks: coarse dims (3, 3, 2, 2), the
    3-coloring; links against tpuqcd's, and A_c = R A P."""
    lat, jlat = lattices((4, 4, 6, 6))
    jl, tl = _levels(lat, jlat, seed=21)
    nulls = _field(lat, 22, lead=(3,))
    jtr = jdevice.DeviceFineTransfer(jlat, BLOCK, jnp.asarray(nulls))
    assert any(d % 2 for d in jtr.dims_c)
    want = np.asarray(jdevice.build_coarse_device(jl, jtr).links)
    tr = fine_transfer_from_numpy(lat, BLOCK, nulls, np.asarray(jtr.linv))
    c = build_coarse_device(tl, tr)
    _close(n(c.links_pk()), want)
    xc = t(np.random.default_rng(23).standard_normal((2, tr.n_c, tr.Vc)).astype(np.float32))
    torch.testing.assert_close(c.apply(xc), tr.restrict(tl.apply(tr.prolong(xc))),
                               atol=1e-4, rtol=0)


def test_coarse_level_matches_tpuqcd():
    dims, n_c = (3, 2, 2, 2), 6
    rng = np.random.default_rng(31)
    links = rng.standard_normal((2, 9, n_c, n_c, int(np.prod(dims)))).astype(np.float32)
    jc = jdevice.DeviceCoarseLevel(dims=dims, n=n_c, links=jnp.asarray(links))
    c = DeviceCoarseLevel.from_links_pk(dims, n_c, t(links))
    np.testing.assert_array_equal(n(c.links_pk()), links)
    v = rng.standard_normal((2, n_c, int(np.prod(dims)))).astype(np.float32)
    _close(n(c.apply(t(v))), jc.apply(jnp.asarray(v)))
    for mu, sign in LEG_ORDER:
        _close(n(c.apply_hop(t(v), mu, sign)), jc.apply_hop(jnp.asarray(v), mu, sign))
    _close(n(c.boosted(0.3).apply(t(v))), jc.boosted(0.3).apply(jnp.asarray(v)))
    jb = jdevice.DeviceCoarseLevel(dims=dims, n=n_c,
                                   links=jnp.asarray(links).astype(jnp.bfloat16))
    _close(n(c.rounded(torch.bfloat16).apply(t(v))), jb.apply(jnp.asarray(v)))
