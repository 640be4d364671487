"""The loop program's pieces on a mesh of gloo ranks (torchrun,
tests/_torch_physics_mesh_worker.py): 2 ranks over t (fused faces), 4 over
(t, z) (fused) and 4 over (t, y) (the overlap engine), at 4x4x4x8.

Each piece runs on the ranks' blocks, is gathered on rank 0 for the test
only and is held to the port's one-card function on the same inputs: the
Z4 noise (drawn whole on every rank and cut) and its time dilution in 3
classes exactly (rank 1 of the t split starts at t = 4, where the local
index would give other classes); the deflation projector Q = 1 - V V^dag
on float64 blocks to 1e-13; the ultra-local and one-derivative one-end
loops of float64 rows to 1e-13 by the phase sum and, where each rank holds
whole timeslices, by the FFT (a mesh with z or y split refuses fft=True);
the Lanczos basis of run_loops.deflation_basis from the same start vector,
its eigenvalues within 1e-5 relative and the projector V V^dag within 1e-4
of the largest value on probe vectors (float32 sums in another order);
an eigenpair file written from the blocks equal to the one-card file of
the same basis, and read back on the mesh into the same blocks.  Cost:
about 45 s serial (three torchrun launches, 10-15 s each)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd_torch.cli.run_loops import NOISE_SEED, deflation_basis
from tpuqcd_torch.gammas import INSERTION_GAMMAS
from tpuqcd_torch.phys.loops_dev import (_loop_all, _one_end_mats, diluted_sources_pk,
                                         make_deflate_pk, z4_noises)
from tpuqcd_torch.utils.checkpoint import save_eigenpairs
from tpuqcd_torch.utils.config import config_from_dict

from _torch_inputs import gauge_full, jax_gauge_pk, spinor_pk, t
from _torch_mesh import JLAT, KAPPA, LAT, MESHES, MU, torchrun
from _torch_physics_mesh_worker import momenta

N_DEFLATE = 4
#: the Lanczos basis on a mesh against one card: eigenvalues (relative) and
#: the projector V V^dag on probe vectors (of the largest value)
LANCZOS_EVALS, LANCZOS_PROJECTOR = 1e-5, 1e-4


def _orthonormal(rng, n: int, dtype) -> np.ndarray:
    """n orthonormal packed fields [n, 2(par), 2(ri), 4, 3, T, Z, S]."""
    a = rng.standard_normal((2, n, 2 * 12 * int(np.prod(LAT.site_shape))))
    q, _ = np.linalg.qr((a[0] + 1j * a[1]).T)
    f = q.T.reshape(n, 2, 4, 3, *LAT.site_shape)
    return np.stack([f.real, f.imag], axis=2).astype(dtype)


@pytest.fixture(scope="module")
def pieces_inputs():
    rng = np.random.default_rng(11)
    u = np.asarray(jax_gauge_pk(gauge_full(LAT, 41), JLAT, True, jnp.float32), np.float64)
    basis = _orthonormal(rng, 3, np.float32).transpose(0, 2, 1, 3, 4, 5, 6, 7)
    return dict(kind="loops", dims=np.array(LAT.dims), u=u, kappa=KAPPA, mu=MU,
                n_deflate=N_DEFLATE, evecs=_orthonormal(rng, 3, np.float64),
                cols=np.stack([spinor_pk(LAT, 42 + i, parities=2) for i in range(2)]),
                psis=np.stack([spinor_pk(LAT, 44 + i, parities=2) for i in range(2)]),
                basis=np.ascontiguousarray(basis), basis_evals=np.array([0.1, 0.2, 0.3]))


@pytest.fixture(scope="module", params=list(MESHES))
def mesh_pieces(request, tmp_path_factory, pieces_inputs):
    mesh, tmp = MESHES[request.param], tmp_path_factory.mktemp(f"loops_{request.param}")
    inp = {**pieces_inputs, "eig_path": str(tmp / "eig_mesh.npz")}
    np.savez(tmp / "in.npz", **inp)
    torchrun(int(np.prod(mesh)), "tests/_torch_physics_mesh_worker.py", "--mesh",
             *map(str, mesh), "--out", str(tmp / "out.npz"), "--pieces", str(tmp / "in.npz"))
    return request.param, mesh, dict(np.load(tmp / "out.npz")), inp


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def test_noise_and_time_dilution_match_one_card(mesh_pieces):
    _, _, p, _ = mesh_pieces
    noise = torch.stack(list(z4_noises(NOISE_SEED, 2, LAT)))
    np.testing.assert_array_equal(p["noise"], noise.numpy())
    want = diluted_sources_pk(noise[0], 3).numpy()
    np.testing.assert_array_equal(p["dilute_t3"], want)
    # the case tells the global timeslice from the block's: the second t
    # block's local index would put other timeslices in each class
    t_loc = np.arange(LAT.Lt) % (LAT.Lt // 2)
    local = np.stack([noise[0].numpy() * (t_loc % 3 == c)[:, None, None] for c in range(3)])
    assert not np.array_equal(local, want)


def test_deflation_projector_matches_one_card(mesh_pieces):
    _, _, p, inp = mesh_pieces
    want = make_deflate_pk(t(inp["evecs"]))(t(inp["cols"])).numpy()
    _close(p["deflate"], want, 1e-13)


def test_one_end_loops_match_one_card(mesh_pieces):
    _, mesh, p, inp = mesh_pieces
    psis, u = t(inp["psis"]), t(inp["u"])
    mats = _one_end_mats(INSERTION_GAMMAS, KAPPA, MU)
    for fft in (False, True):
        tag = "fft" if fft else "phase"
        if fft and not mesh[1] == mesh[2] == 1:
            assert str(p[f"oneend_{tag}"]) == "refused"
            continue
        est = _loop_all(psis, psis, mats, LAT, momenta(), fft)
        der = _loop_all(psis, psis, mats, LAT, momenta(), fft, u, (0, 1, 2, 3))
        _close(p[f"oneend_{tag}"], torch.stack(list(est.values())).numpy(), 1e-13)
        _close(p[f"oneend_der_{tag}"], torch.stack(list(der.values())).numpy(), 1e-13)


@pytest.fixture(scope="module")
def one_card_lanczos(pieces_inputs):
    cfg = config_from_dict({"gauge": {"dims": list(LAT.dims)},
                            "action": {"kappa": KAPPA, "mu": MU},
                            "physics": {"n_deflate": N_DEFLATE}})
    return deflation_basis(cfg, LAT, t(pieces_inputs["u"]).float())


def _projected(evecs: np.ndarray, probes: np.ndarray) -> np.ndarray:
    """V (V^dag x) of packed bases [n, 2(ri), ...] on complex probes [k, N]."""
    v = evecs.reshape(len(evecs), 2, -1).astype(np.float64)
    vc = v[:, 0] + 1j * v[:, 1]
    return (probes @ vc.conj().T) @ vc


def test_lanczos_matches_one_card(mesh_pieces, one_card_lanczos):
    _, _, p, _ = mesh_pieces
    evals, evecs = one_card_lanczos
    np.testing.assert_allclose(p["lanczos_evals"], evals, rtol=LANCZOS_EVALS, atol=0)
    assert np.all(evals > 0) and np.all(np.diff(evals) >= 0)
    rng = np.random.default_rng(7)
    probes = rng.standard_normal((4, evecs[0].numel() // 2)) \
        + 1j * rng.standard_normal((4, evecs[0].numel() // 2))
    want = _projected(evecs.numpy(), probes)
    _close(_projected(p["lanczos_evecs"], probes), want, LANCZOS_PROJECTOR)


def test_eigenpair_file_crosses_the_mesh(mesh_pieces, tmp_path):
    _, _, p, inp = mesh_pieces
    save_eigenpairs(str(tmp_path / "one.npz"), inp["basis_evals"], t(inp["basis"]), "packed")
    got, want = np.load(inp["eig_path"]), np.load(tmp_path / "one.npz")
    assert sorted(got.files) == sorted(want.files) == ["evals", "evecs", "layout"]
    for key in want.files:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_array_equal(p["eig_read"], inp["basis"])
