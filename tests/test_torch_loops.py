"""The port's disconnected-loop functions (tpuqcd_torch/phys/loops_dev.py)
against tpuqcd's (tpuqcd/phys/loops_dev.py) and dense oracles, the loop
writer against tpuqcd's, and the truncated TSM solve against tpuqcd's
solve_tm.

Both packages get the same numpy inputs (fields, gauge, noises, bases):
jax.random and torch.Generator streams differ, so tpuqcd's z4_noise_pk is
handed the port's noise where an estimator draws its own.  Every loop is
compared on both momentum projections, the phase sum (2 momenta) and the
FFT (the 33 momenta of q^2 <= 4), within 1e-5 of the largest value of
its dataset (float32 fields on both sides; the port sums a batch's rows
before projecting, tpuqcd after).  The dense oracles at 2x2x2x4 use the
exact inverse of the float64 operator.  Serial cost about 40 s (2 torch
threads), most of it tpuqcd's XLA compiles."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd.gammas import INSERTION_GAMMAS as J_GAMMAS
from tpuqcd.phys import loops_dev as J
from tpuqcd.solve import solve_tm as j_solve_tm

from tpuqcd_torch.cli.run_loops import _tsm_combine
from tpuqcd_torch.gammas import G5_DIAG, INSERTION_GAMMAS
from tpuqcd_torch.operators import PackedTMOperatorPC
from tpuqcd_torch.phys import loops_dev as P
from tpuqcd_torch.solve import solve_tm_batch

from _torch_inputs import gauge_full, jax_gauge_pk, lattices, t

LAT, JLAT = lattices((4, 4, 4, 8))
SLAT, JSLAT = lattices((2, 2, 2, 4))
KAPPA, MU = 0.11, 0.07
MOM_FEW = np.array([[0, 0, 0], [1, 0, -1]])
MOM_FFT = np.array([(x, y, z) for x in range(-2, 3) for y in range(-2, 3) for z in range(-2, 3)
                    if x * x + y * y + z * z <= 4])


def _fields(lat, seed, n=None):
    shape = (2, 2, 4, 3, *lat.site_shape)
    return np.random.default_rng(seed).standard_normal(
        shape if n is None else (n, *shape)).astype(np.float32)


def _close(got: dict, want: dict, tol=1e-5, what=""):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].cpu().numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max(), err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def gauge():
    u = gauge_full(LAT, 1)
    ju = jax_gauge_pk(u, JLAT, True, jnp.float32)
    return ju, t(ju)


# --- noise and dilution -------------------------------------------------------------

def test_z4_noise_is_z4_seeded_and_the_same_on_every_device():
    eta = P.z4_noise_pk(torch.Generator().manual_seed(5), LAT)
    assert eta.shape == (2, 2, 4, 3, *LAT.site_shape) and eta.dtype == torch.float32
    assert torch.all(eta[:, 0].square() + eta[:, 1].square() == 1.0)
    assert torch.all((eta == 0) | (eta.abs() == 1))
    again = P.z4_noises(5, 2, LAT)
    assert torch.equal(next(iter(again)), eta)
    # the four values come about equally often, and the mean is near 0
    values = torch.complex(eta[:, 0], eta[:, 1]).reshape(-1)
    for z in (1, 1j, -1, -1j):
        assert abs((values == z).float().mean().item() - 0.25) < 0.02
    assert abs(values.mean().item()) < 0.03
    assert J.z4_noise_pk(jax.random.PRNGKey(0), JLAT).shape == tuple(eta.shape)


@pytest.mark.parametrize("dilute_t,dilute_sc", [(1, False), (2, False), (1, True), (4, True)])
def test_dilution_matches_tpuqcd(dilute_t, dilute_sc):
    eta = _fields(LAT, 2)
    got = P.diluted_sources_pk(t(eta), dilute_t, dilute_sc)
    want = np.stack([np.asarray(e) for e in J.diluted_sources_pk(jnp.asarray(eta), dilute_t,
                                                                 dilute_sc)])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.sum(0).numpy(), eta)      # a partition of the noise
    np.testing.assert_array_equal(P.dilute_time_pk(t(eta), 1, 3).numpy(),
                                  np.asarray(J.dilute_time_pk(jnp.asarray(eta), 1, 3)))


# --- the loop functions -----------------------------------------------------------------

def test_bilinear_and_spinor_derivative_match_tpuqcd(gauge):
    ju, tu = gauge
    a, b = _fields(LAT, 3), _fields(LAT, 4)
    want = np.asarray(J.loop_bilinear_pk(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(P.loop_bilinear_pk(t(a), t(b)).numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    for nu in range(4):
        want = np.asarray(J.cov_deriv_sym_spinor_pk(ju, jnp.asarray(a), nu, JLAT))
        got = P.cov_deriv_sym_spinor_pk(tu, t(a), nu, LAT)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("momenta", [MOM_FEW, MOM_FFT], ids=["phase_sum", "fft"])
@pytest.mark.parametrize("fn", ["plain", "one_end", "plain_der", "one_end_der"])
def test_loops_match_tpuqcd(gauge, fn, momenta):
    ju, tu = gauge
    a, b = _fields(LAT, 5), _fields(LAT, 6)
    ja, jb, pa, pb = jnp.asarray(a), jnp.asarray(b), t(a), t(b)
    for nu in (range(4) if fn.endswith("der") else [None]):
        if fn == "plain":
            want = J.loop_plain_pk(ja, jb, J_GAMMAS, JLAT, momenta)
            got = P.loop_plain_pk(pa, pb, INSERTION_GAMMAS, LAT, momenta)
        elif fn == "one_end":
            want = J.loop_one_end_pk(ja, J_GAMMAS, JLAT, momenta, KAPPA, MU)
            got = P.loop_one_end_pk(pa, INSERTION_GAMMAS, LAT, momenta, KAPPA, MU)
        elif fn == "plain_der":
            want = J.loop_plain_der_pk(ja, jb, ju, J_GAMMAS, nu, JLAT, momenta)
            got = P.loop_plain_der_pk(pa, pb, tu, INSERTION_GAMMAS, nu, LAT, momenta)
        else:
            want = J.loop_one_end_der_pk(ja, ju, J_GAMMAS, nu, JLAT, momenta, KAPPA, MU)
            got = P.loop_one_end_der_pk(pa, tu, INSERTION_GAMMAS, nu, LAT, momenta, KAPPA, MU)
        assert all(v.shape == (len(momenta), LAT.Lt) and v.dtype == torch.complex128
                   for v in got.values())
        _close(got, want, what=f"{fn} nu={nu}")


def test_projections_agree_and_a_batch_is_the_sum_of_its_rows(gauge):
    _, tu = gauge
    a = t(_fields(LAT, 7, n=3))
    by_fft = P.loop_one_end_pk(a, INSERTION_GAMMAS, LAT, MOM_FEW, KAPPA, MU, fft=True)
    by_sum = P.loop_one_end_pk(a, INSERTION_GAMMAS, LAT, MOM_FEW, KAPPA, MU, fft=False)
    _close(by_fft, by_sum, tol=1e-12, what="fft against phase sum")
    rows = [P.loop_one_end_der_pk(a[i], tu, INSERTION_GAMMAS, 2, LAT, MOM_FEW, KAPPA, MU)
            for i in range(3)]
    whole = P.loop_one_end_der_pk(a, tu, INSERTION_GAMMAS, 2, LAT, MOM_FEW, KAPPA, MU)
    _close(whole, {k: sum(r[k] for r in rows) for k in whole}, tol=1e-6, what="rows")


# --- estimators on shared noise and a dense solve ------------------------------------

@pytest.fixture(scope="module")
def dense():
    """At 2x2x2x4: the gauge both ways and the dense (M_d^dag)^{-1} = g5 M_u^{-1}
    g5 and M_d^{-1} as real matrices on the flattened solver-layout fields,
    and M_d as a complex matrix on the complex vector [2(par), 4, 3, T, Z, S]."""
    u = gauge_full(SLAT, 2)
    ju = jax_gauge_pk(u, JSLAT, True, jnp.float32)
    tu = t(ju)
    shape = (2, 2, 4, 3, *SLAT.site_shape)
    n = int(np.prod(shape))
    eye = torch.eye(n, dtype=torch.float64).reshape(n, *shape)
    mats = {}
    for flavor in (+1, -1):
        pc = PackedTMOperatorPC(SLAT, kappa=KAPPA, mu=MU, flavor=flavor)
        mats[flavor] = pc.apply_full(tu.double(), eye).reshape(n, n).T.numpy()
    g5 = np.broadcast_to(np.asarray(G5_DIAG).reshape(1, 1, 4, 1, 1, 1, 1), shape).reshape(-1)
    ddag_inv = g5[:, None] * np.linalg.inv(mats[+1]) * g5[None, :]
    half = n // 2
    # complex M_d on [2(par), 4, 3, T, Z, S]: the real matrix on (par, ri, ...) planes
    perm = np.arange(n).reshape(2, 2, -1).transpose(1, 0, 2).reshape(-1)   # ri first
    r = mats[-1][np.ix_(perm, perm)]
    md = r[:half, :half] + 1j * r[half:, :half]
    return ju, tu, ddag_inv, md


def _solver(inv, cast):
    """b [n, ...] -> inv b, each side's own array type."""
    def solve(b):
        x = np.asarray(b, np.float64).reshape(b.shape[0], -1) @ inv.T
        return cast(x.reshape(b.shape).astype(np.float32))
    return solve


def _shared_noises(monkeypatch, seed, n):
    """tpuqcd's z4_noise_pk hands out the port's noises of ``seed`` in turn."""
    noises = [x.numpy() for x in P.z4_noises(seed, n, SLAT)]
    keys = [np.asarray(k).tobytes() for k in jax.random.split(jax.random.PRNGKey(seed), n)]
    table = dict(zip(keys, noises))
    monkeypatch.setattr(J, "z4_noise_pk", lambda key, lat: jnp.asarray(
        table[np.asarray(key).tobytes()]))
    return list(jax.random.split(jax.random.PRNGKey(seed), n))


def _orthonormal_basis(n, seed=7):
    """n orthonormal solver-layout fields [n, 2(par), 2(ri), 4, 3, T, Z, S]."""
    shape = (2, 4, 3, *SLAT.site_shape)
    rng = np.random.default_rng(seed)
    m = int(np.prod(shape))
    q, _ = np.linalg.qr(rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n)))
    c = q.T.reshape(n, *shape)
    return np.stack([c.real, c.imag], axis=2).astype(np.float32)


def test_deflation_projector_matches_tpuqcd():
    v = _orthonormal_basis(3)
    eta = _fields(SLAT, 8, n=2)
    defl, jdefl = P.make_deflate_pk(t(v)), J.make_deflate_pk(jnp.asarray(v))
    got = defl(t(eta))
    for i in range(2):
        want = np.asarray(jdefl(jnp.asarray(eta[i])))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(defl(t(eta[i])).numpy(), got[i].numpy())
    # orthogonal to the basis, and the identity on its complement
    vc = torch.complex(t(v)[:, :, 0].double(), t(v)[:, :, 1].double()).reshape(3, -1)
    gc = torch.complex(got[:, :, 0].double(), got[:, :, 1].double()).reshape(2, -1)
    assert (vc.conj() @ gc.T).abs().max() < 1e-6
    np.testing.assert_allclose(defl(got).numpy(), got.numpy(), atol=1e-6)


@pytest.mark.parametrize("fn", ["plain", "one_end"])
def test_loops_stochastic_matches_tpuqcd(dense, monkeypatch, fn):
    _, _, ddag_inv, _ = dense
    keys = _shared_noises(monkeypatch, 4, 3)
    one = lambda b: b[None]                                     # noqa: E731
    kw = dict(one_end=fn == "one_end", kappa=KAPPA, mu=MU)
    psolve, jsolve = _solver(ddag_inv, torch.from_numpy), _solver(ddag_inv, jnp.asarray)
    want = J.loops_stochastic_pk(lambda b: jsolve(one(b))[0], keys, J_GAMMAS, JSLAT, MOM_FEW,
                                 solve_fn_dag_pk=lambda b: jsolve(one(b))[0], **kw)
    got = P.loops_stochastic_pk(lambda b: psolve(one(b))[0], P.z4_noises(4, 3, SLAT),
                                INSERTION_GAMMAS, SLAT, MOM_FEW,
                                solve_fn_dag_pk=lambda b: psolve(one(b))[0], **kw)
    _close(got, want, what=fn)


def test_one_end_estimators_match_tpuqcd(dense, monkeypatch):
    """The per-noise and the averaged one-end estimators, with time and
    spin-colour dilution, deflation, derivatives; the exact low-mode part and
    the eigenpair low-mode loop, each on a shared exact solve."""
    ju, tu, ddag_inv, _ = dense
    keys = _shared_noises(monkeypatch, 9, 2)
    v = _orthonormal_basis(2)
    psolve, jsolve = _solver(ddag_inv, torch.from_numpy), _solver(ddag_inv, jnp.asarray)
    kw = dict(derivs=True, dilute_t=2, dilute_sc=True)
    want = J.stochastic_oneend_pk(keys, jsolve, J_GAMMAS, JSLAT, MOM_FFT, KAPPA, MU, u_pk=ju,
                                  deflate_fn=J.make_deflate_pk(jnp.asarray(v)), **kw)
    got = P.stochastic_oneend_pk(P.z4_noises(9, 2, SLAT), psolve, INSERTION_GAMMAS, SLAT,
                                 MOM_FFT, KAPPA, MU, u_pk=tu, deflate_fn=P.make_deflate_pk(t(v)),
                                 **kw)
    for g, w, what in zip(got, want, ("est", "der")):
        _close(g, w, what=what)
    eta = next(iter(P.z4_noises(3, 1, SLAT)))
    want = J.oneend_estimate_for_noise_pk(jnp.asarray(eta.numpy()), jsolve, J_GAMMAS, JSLAT,
                                          MOM_FEW, KAPPA, MU, u_pk=ju, derivs=True, dilute_t=4)
    got = P.oneend_estimate_for_noise_pk(eta, psolve, INSERTION_GAMMAS, SLAT, MOM_FEW, KAPPA,
                                         MU, u_pk=tu, derivs=True, dilute_t=4)
    for g, w, what in zip(got, want, ("est", "der")):
        _close(g, w, what=what)
    want = J.oneend_lowmode_exact_pk(jnp.asarray(v), jsolve, J_GAMMAS, JSLAT, MOM_FEW, KAPPA,
                                     MU, u_pk=ju, derivs=True)
    got = P.oneend_lowmode_exact_pk(t(v), psolve, INSERTION_GAMMAS, SLAT, MOM_FEW, KAPPA, MU,
                                    u_pk=tu, derivs=True)
    for g, w, what in zip(got, want, ("low", "low_der")):
        _close(g, w, what=what)
    # the eigenpair form: (1/lambda) (M^dag v)(x) v(x)^dag with a shared M^dag
    mdag = np.linalg.inv(ddag_inv)
    evals = np.array([0.5, 2.0])
    want = J.loop_lowmode_pk(evals, jnp.asarray(v), lambda x: _solver(mdag, jnp.asarray)(
        x[None])[0], J_GAMMAS, JSLAT, MOM_FEW)
    got = P.loop_lowmode_pk(evals, t(v), lambda x: _solver(mdag, torch.from_numpy)(x[None])[0],
                            INSERTION_GAMMAS, SLAT, MOM_FEW)
    _close(got, want, what="lowmode")


def test_lowmode_exact_part_is_the_deflated_expectation(dense):
    """For a random orthonormal basis {v_i}, the exact low-mode part equals
    the piece that deflating the noise removes from the one-end estimator's
    expectation, 4 i kappa mu sum_x Tr[O g5 (W_full - W_defl)(x, x)] with W =
    (M_d^dag)^{-1} E[eta eta^dag] M_d^{-1} and E[eta eta^dag] = 1 or Q = 1 -
    V V^dag: so the deflated stochastic part plus the exact part is unbiased
    (tests/test_loops_deflation.py::test_oneend_lowmode_exact_matches_dense)."""
    _, tu, ddag_inv, md = dense
    v = _orthonormal_basis(3)
    low, _ = P.oneend_lowmode_exact_pk(t(v), _solver(ddag_inv, torch.from_numpy),
                                       INSERTION_GAMMAS, SLAT, MOM_FEW, KAPPA, MU)
    vc = (v[:, :, 0] + 1j * v[:, :, 1]).reshape(3, -1).T.astype(np.complex128)   # [N, 3]
    mdinv = np.linalg.inv(md)
    mdinvdag = mdinv.conj().T
    q = np.eye(len(md)) - vc @ vc.conj().T
    removed = mdinvdag @ mdinv - mdinvdag @ q @ mdinv
    # site-diagonal 12 x 12 blocks: index (par, s, c, t, z, s') -> [site, 12, site, 12]
    n_site = 2 * SLAT.Lt * SLAT.Lz * (SLAT.Ly * SLAT.Lx // 2)
    blk = removed.reshape(2, 12, n_site // 2, 2, 12, n_site // 2)
    diag = np.einsum("pisqjs->pqsij", blk)[np.arange(2), np.arange(2)]      # [par, site, 12, 12]
    g5 = np.asarray(G5_DIAG)
    for name, gam in INSERTION_GAMMAS.items():
        o12 = np.kron(gam.numpy() * g5[None, :], np.eye(3))
        tr = np.einsum("ij,psji->ps", o12, diag).reshape(2, SLAT.Lt, -1).sum(axis=(0, 2))
        want = 4j * KAPPA * MU * tr
        np.testing.assert_allclose(low[name][0].numpy(), want, rtol=0,
                                   atol=2e-5 * max(np.abs(want).max(), 1e-3), err_msg=name)


def test_tsm_identity():
    """With the same noises for the cheap and the correction estimates, E_cheap
    + (E_full - E_cheap) is E_full, whatever the cheap solve (run_loops's
    combination, as tests/test_loops_deflation.py::test_tsm_unbiased_identity)."""
    def est(solve):
        return P.stochastic_oneend_pk(P.z4_noises(4, 2, SLAT), solve, INSERTION_GAMMAS, SLAT,
                                      MOM_FEW, KAPPA, MU)[0]
    full = est(lambda b: 0.9 * b.flip(-1))
    cheap = est(lambda b: 0.5 * b)
    _close(_tsm_combine(cheap, full, cheap), full, tol=1e-12, what="tsm")


def test_truncated_tsm_solve_matches_tpuqcd():
    """The cheap solve of the loop run: solve_tm_batch capped at 8 steps with
    tol and inner_tol 1e-3; each column equals tpuqcd's solve_tm on it (the
    columns of tpuqcd's solve_tm_batch are its vmap), x within 1e-5 and the
    matvec count exactly."""
    u = gauge_full(SLAT, 4)
    ju = jax_gauge_pk(u, JSLAT, True, jnp.float32)
    b = _fields(SLAT, 11, n=2)
    kw = dict(kappa=KAPPA, mu=MU, flavor=+1, tol=1e-3, maxiter=8, inner_tol=1e-3)
    res = solve_tm_batch(t(ju), t(b), SLAT, **kw)
    for i in range(2):
        ref = j_solve_tm(ju, jnp.asarray(b[i]), JSLAT, backend="xla", **kw)
        want = np.asarray(ref.x)
        np.testing.assert_allclose(res.x[i].numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
        assert res.iters[i] == int(ref.iters) and res.relres[i] > 1e-4


def test_write_loops_matches_tpuqcd(tmp_path):
    h5py = pytest.importorskip("h5py")
    from tpuqcd.io.hdf5io import write_loops as j_write_loops
    from tpuqcd_torch.io.hdf5io import write_loops
    rng = np.random.default_rng(3)
    loops = rng.standard_normal((3, 2, 8)) + 1j * rng.standard_normal((3, 2, 8))
    meta = {"n_noise": 4, "kappa": KAPPA, "dilute_sc": 1}
    for w, name in ((j_write_loops, "ref.h5"), (write_loops, "port.h5")):
        w(str(tmp_path / name), "loops/oneend", loops, ["1", "g5", "gt"], meta=meta)
        w(str(tmp_path / name), "loops/oneend", loops[::-1], ["1", "g5", "gt"], meta=meta)

    def read(name):
        out = {}
        with h5py.File(tmp_path / name, "r") as f:
            f.visititems(lambda k, v: out.__setitem__(k, (v[()] if isinstance(v, h5py.Dataset)
                                                          else None, dict(v.attrs))))
        return out
    ref, got = read("ref.h5"), read("port.h5")
    assert sorted(got) == sorted(ref) == ["loops", "loops/oneend", "loops/oneend/1",
                                          "loops/oneend/g5", "loops/oneend/gt"]
    for k, (data, attrs) in ref.items():
        assert got[k][1] == attrs
        if data is not None:
            np.testing.assert_array_equal(got[k][0], data)
    np.testing.assert_array_equal(got["loops/oneend/1"][0], loops[2])
