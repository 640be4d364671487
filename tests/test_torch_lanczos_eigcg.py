"""The port's Lanczos (solvers/lanczos.py), incremental eigCG
(solvers/eigcg.py, solve.EigCGSolver) and eigenpair files
(utils/checkpoint.py) against tpuqcd's and dense oracles.

Both packages get the same numpy inputs: the start vector, the right-hand
sides, a dense Hermitian positive definite matrix.  Lanczos runs on M_d
M_d^dag of the fine level at 2x2x2x4 (float32 on both sides), against
tpuqcd's and, run long, against dense eigh; eigCG on a
dense matrix with four isolated low modes, where the two packages take
the same iterations within one and find the same lowest Ritz values
within 1e-4.  EigCGSolver certifies 1e-10 at 4x4x4x8 with falling
iterations, and the two-point run with solver: eigcg matches tpuqcd's.
Serial cost about 60 s (2 torch threads), half of it tpuqcd's eigCG."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd.cli import run_twop as j_twop
from tpuqcd.fields import apply_boundary_phase as j_apply_boundary_phase
from tpuqcd.fields import gauge_full_to_eo as j_gauge_full_to_eo
from tpuqcd.mg.device import DeviceFineLevel as JFineLevel
from tpuqcd.ops.layout import gauge_to_device as j_gauge_to_device
from tpuqcd.solvers import eigcg as jeig
from tpuqcd.solvers.lanczos import lanczos_lowest_pk as j_lanczos
from tpuqcd.utils import checkpoint as jck
from tpuqcd.utils.packed import pack_gauge as j_pack_gauge

from tpuqcd_torch.cli import run_twop
from tpuqcd_torch.cli.common import Gauge
from tpuqcd_torch.gammas import G5_DIAG
from tpuqcd_torch.mg.device import DeviceFineLevel
from tpuqcd_torch import solve as tsolve
from tpuqcd_torch.operators import PackedTMOperatorPC
from tpuqcd_torch.solve import EigCGSolver, full_system_relres
from tpuqcd_torch.solvers import eigcg
from tpuqcd_torch.solvers.lanczos import (_orthonormalize_pk, deflated_initial_guess,
                                          lanczos_lowest_pk)
from tpuqcd_torch.utils import checkpoint
from tpuqcd_torch.utils.config import config_from_dict

from _torch_inputs import gauge_full, jax_gauge_pk, lattices, t
from _torch_loops_run import j_config_from_dict, read_all

LAT, JLAT = lattices((2, 2, 2, 4))
KAPPA, MU = 0.11, 0.07


@pytest.fixture(scope="module")
def mmdag():
    """(port's apply, tpuqcd's apply, dense A) of A = M_d M_d^dag = M_d g5 M_u
    g5 on MG-layout fields [2(ri), 2(par), 4, 3, T, Z, S], float32 links."""
    u = gauge_full(LAT, 6)
    ju = jax_gauge_pk(u, JLAT, True, jnp.float32)
    tu = t(ju)
    g5 = torch.tensor(G5_DIAG, dtype=torch.float32).view(1, 1, 4, 1, 1, 1, 1)
    lv = {f: DeviceFineLevel(LAT, tu, KAPPA, MU, f) for f in (+1, -1)}
    jlv = {f: JFineLevel(JLAT, ju, KAPPA, MU, f, backend="xla") for f in (+1, -1)}
    jg5 = jnp.asarray(g5.numpy())

    def apply(v):
        return lv[-1].apply(g5 * lv[+1].apply(g5 * v))

    def japply(v):
        return jlv[-1].apply(jg5 * jlv[+1].apply(jg5 * v))

    shape = (2, 2, 4, 3, *LAT.site_shape)
    n = int(np.prod(shape))
    lv64 = {f: DeviceFineLevel(LAT, tu.double(), KAPPA, MU, f) for f in (+1, -1)}
    eye = torch.eye(n, dtype=torch.float64).reshape(n, *shape)
    real = lv64[-1].apply(g5.double() * lv64[+1].apply(g5.double() * eye)).reshape(n, n).T
    a = real[:n // 2, :n // 2] + 1j * real[n // 2:, :n // 2]       # complex, ri leading
    return apply, japply, a.numpy(), shape


def _v0(shape, seed=9):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _complex(vs: torch.Tensor) -> np.ndarray:
    v = vs.reshape(vs.shape[0], 2, -1).double().numpy()
    return v[:, 0] + 1j * v[:, 1]


def test_lanczos_matches_tpuqcd_on_the_same_start_vector(mmdag):
    """The loop run's setting (40 steps, 4 modes): Rayleigh quotients within
    1e-4 of tpuqcd's, the same subspace, an orthonormal basis."""
    apply, japply, a, shape = mmdag
    v0 = _v0(shape)
    evals, evecs = lanczos_lowest_pk(apply, v0, 4, n_iter=40)
    jevals, jevecs = j_lanczos(japply, jnp.asarray(v0.numpy()), 4, n_iter=40)
    np.testing.assert_allclose(evals, np.asarray(jevals), rtol=1e-4)
    assert evecs.shape == (4, *shape) and evecs.dtype == torch.float32
    vc, jc = _complex(evecs), _complex(torch.from_numpy(np.array(jevecs)))
    np.testing.assert_allclose(vc.conj() @ vc.T, np.eye(4), atol=1e-5)
    # the same span: every vector of one basis lies in the span of the other
    np.testing.assert_allclose(np.linalg.norm(jc.conj() @ vc.T, axis=0), 1.0, atol=1e-3)
    assert np.all(np.diff(evals) >= 0) and evals[0] > 0
    # Rayleigh quotients of the returned vectors on the dense A
    np.testing.assert_allclose(np.einsum("in,nm,im->i", vc.conj(), a, vc).real, evals,
                               rtol=1e-4)


def test_lanczos_finds_the_dense_low_modes(mmdag):
    """Run long enough (n_iter 160 of the 384 complex dimensions), the
    Lanczos converges A's four lowest eigenpairs of dense eigh: values
    within 1e-5, eigen-residuals below 1e-4 of the value (measured 2.4e-7
    and 5.9e-6)."""
    apply, _, a, shape = mmdag
    w = np.linalg.eigvalsh(a)
    evals, evecs = lanczos_lowest_pk(apply, _v0(shape, 2), 4, n_iter=160)
    np.testing.assert_allclose(evals, w[:4], rtol=1e-5)
    for lam, v, x in zip(evals, _complex(evecs), evecs):
        assert np.linalg.norm(a @ v - lam * v) < 1e-4 * lam
        assert torch.allclose(apply(x), lam * x, atol=1e-4 * lam)


def test_orthonormalize_and_deflated_guess():
    rng = np.random.default_rng(1)
    vs = torch.from_numpy(rng.standard_normal((3, 2, 40)).astype(np.float32))
    on = _orthonormalize_pk(vs)
    c = _complex(on)
    np.testing.assert_allclose(c.conj() @ c.T, np.eye(3), atol=1e-6)
    # x0 = sum_i v_i <v_i, b> / lambda_i
    evals = np.array([0.5, 2.0, 4.0])
    b = torch.from_numpy(rng.standard_normal((2, 40)).astype(np.float32))
    bc = _complex(b[None])[0]
    want = sum(v * (v.conj() @ bc) / lam for lam, v in zip(evals, c))
    got = _complex(deflated_initial_guess(evals, list(on), b)[None])[0]
    np.testing.assert_allclose(got, want, atol=1e-6)


# --- eigCG --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hpd():
    """A dense Hermitian positive definite A (n = 160: four isolated low modes
    1e-3 .. 6e-3, the rest 0.05 .. 1) and four right-hand sides, packed [2(ri),
    n] float32."""
    n = 160
    rng = np.random.default_rng(4)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    lam = np.concatenate([[1e-3, 2e-3, 4e-3, 6e-3], np.geomspace(0.05, 1.0, n - 4)])
    a = (q * lam) @ q.conj().T
    bs = rng.standard_normal((4, 2, n)).astype(np.float32)
    return a, lam, bs


def _apply(a, module):
    """A v on packed float32 fields, computed in complex128 and rounded to
    float32 (both packages' apply then agree to the rounding)."""
    def apply(v):
        w = a @ (np.asarray(v[0], np.float64) + 1j * np.asarray(v[1], np.float64))
        out = np.stack([w.real, w.imag]).astype(np.float32)
        return jnp.asarray(out) if module is jnp else torch.from_numpy(out)
    return apply


def test_eigcg_matches_tpuqcd(hpd):
    """solve_sequence on the same A and sources: per source, the iterations
    within 1 of tpuqcd's and x within 1e-4; the first solve's Ritz values
    within 1e-4 of tpuqcd's and of A's four low modes, which the final space
    holds in both packages; the iterations fall once they are captured.
    (Later harvests start from deflated guesses that differ by rounding, and
    their Ritz values of the bulk differ by up to 1%.)"""
    a, lam, bs = hpd
    kw = dict(nev=4, m=16, tol=1e-6, maxiter=2000, max_space=24)
    res, space = eigcg.solve_sequence(_apply(a, torch), [torch.from_numpy(b) for b in bs], **kw)
    jres, jspace = jeig.solve_sequence(_apply(a, jnp), [jnp.asarray(b) for b in bs], **kw)
    for r, j in zip(res, jres):
        assert abs(r.iters - j.iters) <= 1 and r.converged and r.relres <= 1e-6
        want = np.asarray(j.x)
        np.testing.assert_allclose(r.x.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    ritz, jritz = [lam_ for lam_, _ in res[0].ritz], [lam_ for lam_, _ in jres[0].ritz]
    np.testing.assert_allclose(ritz, jritz, rtol=1e-4)
    np.testing.assert_allclose(ritz, lam[:4], rtol=1e-4)
    assert space.k == jspace.k
    np.testing.assert_allclose(np.sort(space.evals)[:4], np.sort(jspace.evals)[:4], rtol=1e-4)
    its = [r.iters for r in res]
    assert max(its[1:]) < 0.7 * its[0], its
    with pytest.raises(ValueError, match="m > 2 nev"):
        eigcg.eigcg(_apply(a, torch), torch.from_numpy(bs[0]), nev=8, m=16)


def test_eigcg_space_absorbs_like_tpuqcd_and_deflates_exactly_on_its_span(hpd):
    """EigCGSpace with A's four lowest eigenvectors offered twice (the second
    time rotated by a phase, so already in the space) and a null vector:
    both packages keep the same four with the same Rayleigh quotients
    (1e-5), and the deflated guess of a right-hand side in their span is
    A^-1 b within 1e-4 of its largest entry, as tpuqcd's."""
    a, lam, _ = hpd
    w, q = np.linalg.eigh(a)
    apply_t, apply_j = _apply(a, torch), _apply(a, jnp)
    pk = [np.stack([q[:, i].real, q[:, i].imag]).astype(np.float32) for i in range(4)]
    rot = [np.stack([(1j * q[:, i]).real, (1j * q[:, i]).imag]).astype(np.float32)
           for i in range(4)]
    offered = [(0.0, v) for v in pk + rot] + [(0.0, np.zeros_like(pk[0]))]
    space, jspace = eigcg.EigCGSpace.empty(), jeig.EigCGSpace.empty()
    space.absorb(apply_t, [(lam_, torch.from_numpy(v)) for lam_, v in offered], max_k=24)
    jspace.absorb(apply_j, [(lam_, jnp.asarray(v)) for lam_, v in offered], max_k=24)
    assert space.k == jspace.k == 4
    np.testing.assert_allclose(space.evals, jspace.evals, rtol=1e-5)
    np.testing.assert_allclose(space.evals, w[:4], rtol=1e-4)
    coef = np.random.default_rng(8).normal(size=4) + 1j * np.random.default_rng(9).normal(size=4)
    bc = q[:, :4] @ coef
    b = np.stack([bc.real, bc.imag]).astype(np.float32)
    want = np.linalg.solve(a, bc)
    got = space.deflate(torch.from_numpy(b)).numpy()
    jgot = np.asarray(jspace.deflate(jnp.asarray(b)))
    tol = 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(got[0] + 1j * got[1], want, rtol=0, atol=tol)
    np.testing.assert_allclose(got, jgot, rtol=0, atol=tol)


def test_eigcg_solver_certifies_and_amortizes(monkeypatch):
    """EigCGSolver at 4x4x4x8 near critical: every solve certified to 1e-10
    on the even-odd system and, in float64, on the full system; the
    iterations fall along the sequence as the space grows (to at most 48
    pairs here, not 96, for the CPU's time)."""
    monkeypatch.setattr(tsolve, "EIGCG_MAX_SPACE", 48)
    lat = lattices((4, 4, 4, 8))[0]
    tu = t(jax_gauge_pk(gauge_full(lat, 9), lattices((4, 4, 4, 8))[1], True, jnp.float32))
    s = EigCGSolver(tu, lat, kappa=0.17, mu=0.01)
    rng = np.random.default_rng(3)
    its = []
    for _ in range(4):
        b = torch.from_numpy(rng.standard_normal((2, 2, 4, 3, *lat.site_shape)))
        res = s.solve(b, tol=1e-10, inner_tol=1e-5, maxiter=2000)
        rel = full_system_relres(tu, b, res.x, lat, kappa=0.17, mu=0.01)
        assert res.relres <= 1e-10 and rel <= 1e-9 and res.x.dtype == torch.float64
        its.append(res.iters)
    assert its[-1] < its[0] and s.space.k > 8, (its, s.space.k)
    assert isinstance(s.pc, PackedTMOperatorPC) and s.u32.shape[2] == 2   # reconstruct-12


# --- eigenpair files ------------------------------------------------------------------

def test_eigenpair_files_cross_between_the_packages(tmp_path):
    rng = np.random.default_rng(5)
    evecs = rng.standard_normal((3, 2, 2, 4, 3, 2, 1, 2)).astype(np.float32)
    evals = np.array([0.1, 0.2, 0.3])
    checkpoint.save_eigenpairs(str(tmp_path / "port.npz"), evals, torch.from_numpy(evecs),
                               layout="packed")
    jevals, jevecs = jck.load_eigenpairs(str(tmp_path / "port.npz"), expect_layout="packed",
                                         n_expect=2)
    np.testing.assert_array_equal(jevals, evals[:2])
    np.testing.assert_array_equal(np.stack([np.asarray(v) for v in jevecs]), evecs[:2])
    jck.save_eigenpairs(str(tmp_path / "jax.npz"), evals, [jnp.asarray(v) for v in evecs],
                        layout="packed")
    pevals, pevecs = checkpoint.load_eigenpairs(str(tmp_path / "jax.npz"),
                                                expect_layout="packed", n_expect=3)
    np.testing.assert_array_equal(pevals, evals)
    assert all(isinstance(v, torch.Tensor) for v in pevecs)
    np.testing.assert_array_equal(torch.stack(pevecs).numpy(), evecs)
    # the refusals: another layout, and fewer pairs than asked
    jck.save_eigenpairs(str(tmp_path / "full.npz"), evals, list(evecs), layout="full")
    with pytest.raises(ValueError, match="'full'-layout"):
        checkpoint.load_eigenpairs(str(tmp_path / "full.npz"), expect_layout="packed")
    with pytest.raises(ValueError, match="holds 3 eigenpairs but the config asks n_deflate=4"):
        checkpoint.load_eigenpairs(str(tmp_path / "port.npz"), expect_layout="packed",
                                   n_expect=4)
    evals_all, evecs_all = checkpoint.load_eigenpairs(str(tmp_path / "full.npz"))
    assert len(evecs_all) == 3 and np.array_equal(evals_all, evals)


# --- eigCG in the two-point run ---------------------------------------------------

def test_run_twop_with_eigcg_matches_tpuqcd(tmp_path, monkeypatch):
    """tpuqcd's run_twop (its _measure, host contractions, its EigCGSolver)
    against the port's with solver: eigcg at 2x2x2x4; the correlators
    within 1e-4 of their largest value, every column certified, and the
    eigCG space of each flavor grown along the twelve columns.  Both
    packages' EigCGSolver keep 24 pairs here, not 96 (tpuqcd's eager
    absorb costs a minute of CPU at 96)."""
    pytest.importorskip("h5py")
    from tpuqcd.solve import EigCGSolver as JEigCGSolver
    monkeypatch.setitem(JEigCGSolver.__init__.__kwdefaults__, "max_space", 24)
    monkeypatch.setattr(tsolve, "EIGCG_MAX_SPACE", 24)
    raw = {"gauge": {"dims": list(LAT.dims), "random_seed": 1},
           "action": {"kappa": 0.12, "mu": 0.05},
           "solver": {"solver": "eigcg", "tol": 1.0e-9, "backend": "xla"},
           "physics": {"smear_n_ape": 0, "smear_n_gauss": 0, "momenta": [[0, 0, 0]],
                       "projectors": ["P+"], "meson_channels": ["pion"],
                       "output": str(tmp_path / "ref.h5")}}
    u_np = gauge_full(LAT, 5)
    u_full = j_apply_boundary_phase(jnp.asarray(u_np.astype(np.complex64)), JLAT)
    u_dev = j_gauge_to_device(j_gauge_full_to_eo(u_full, JLAT), JLAT)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_twop, "setup_gauge",
                   lambda c: (JLAT, u_full, j_pack_gauge(u_dev), u_dev))
        j_twop._measure(j_config_from_dict(raw))
    ref = read_all(raw["physics"]["output"])
    raw["physics"]["output"] = str(tmp_path / "port.h5")
    cfg = config_from_dict(raw)
    tu = t(jax_gauge_pk(u_np, JLAT, True, jnp.float32))
    res = run_twop.measure(cfg, torch.device("cpu"), Gauge(LAT, tu, 0.0, 0.0))
    run_twop.write(cfg, res)
    got = read_all(cfg.physics.output)
    assert sorted(got) == sorted(ref) and len(ref) == 3
    for name, want in ref.items():
        np.testing.assert_allclose(got[name], want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)
    assert [(r["flavor"], r["first_column"]) for r in res.solves] == \
        [(f, i) for f in (1, -1) for i in range(12)]
    assert all(r["relres"][0] <= 1e-9 for r in res.solves)
    for flavor in (1, -1):
        space = [r["space"] for r in res.solves if r["flavor"] == flavor]
        assert space[0] > 0 and space == sorted(space) and space[-1] == 24, space
