"""The port's multi-device solve on the CPU: the Dslash kernel's halo mode
(K6) in its plain PyTorch version on emulated shards, the sharded
twisted-mass and doublet operators and the sharded doublet solve on gloo
ranks, and run_invert under torchrun.

References are tpuqcd's unsharded operators (backend="xla") on the same
numpy inputs, the equality tests/test_sharded.py asserts inside tpuqcd,
and one case of tpuqcd's Pallas halo mode in interpret mode.  The ranks
run tests/_torch_sharded_worker.py, which imports tpuqcd_torch only.
Tolerances: float32 (reconstruct-12) 3e-5 absolute, float64 1e-12 (the
same float64 arithmetic in another order), solutions of two solves to
1e-12 agree to 1e-10."""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd.operators import PackedNdegTMOperatorPC as JNdeg
from tpuqcd.operators import PackedTMOperatorPC as JTM
from tpuqcd.ops.dslash_pallas import dslash_eo_pallas
from tpuqcd.ops.dslash_xla import dslash_eo_dev_ri

from tpuqcd_torch.ops.dslash_cuda import dslash_eo_plain
from tpuqcd_torch.parallel.mesh import LatticeMesh
from tpuqcd_torch.parallel.sharded import cut_halo
from tpuqcd_torch.solve import solve_ndeg_tm

from _torch_inputs import gauge_full, jax_gauge_pk, lattices, n, spinor_pk, t

ROOT = Path(__file__).resolve().parents[1]
LAT, JLAT = lattices((4, 4, 4, 8))
KAPPA, MU = 0.115, 0.08
MUBAR, EPSBAR = 0.135, 0.170
TOL = {"f32": 3e-5, "f64": 1e-12}


def _gauge(antiperiodic_t=True):
    """A float32-valued gauge, float64 numpy."""
    return np.asarray(jax_gauge_pk(gauge_full(LAT, 80), JLAT, antiperiodic_t, jnp.float32),
                      np.float64)


# --------------------------------------------------------------------------
# K6 plain version on emulated shards (one process)

@pytest.mark.parametrize("half", [True, False], ids=["half", "full"])
@pytest.mark.parametrize("storage", ["f64", "f32_recon12"])
@pytest.mark.parametrize("grid", [(2, 1), (1, 2), (2, 2), (4, 1)], ids=str)
def test_plain_halo_matches_tpuqcd_hop(grid, storage, half):
    """Each shard's halo-mode hop, faces cut from the global fields,
    against tpuqcd's global hop restricted to the shard: both parities,
    dagger off and on, both boundary conditions."""
    rows, dt, tol = (3, torch.float64, 1e-12) if storage == "f64" else (2, torch.float32, 3e-5)
    psi = spinor_pk(LAT, 81)
    for antiperiodic_t in (True, False):
        u = _gauge(antiperiodic_t)
        u_t = t(u[:, :, :rows], dt)
        for parity in (0, 1):
            for dagger in (False, True):
                ref = np.asarray(dslash_eo_dev_ri(jnp.asarray(u), jnp.asarray(psi), parity, JLAT,
                                                  dagger=dagger))
                for r in range(grid[0] * grid[1]):
                    m = LatticeMesh(LAT, *grid, 1, r)
                    ul, pl, halo = cut_halo(m, u_t, t(psi, dt), parity, dagger, half)
                    got = dslash_eo_plain(ul, pl, parity, m.local_lat, dagger=dagger, halo=halo,
                                          t_boundary=-1 if antiperiodic_t else 1)
                    np.testing.assert_allclose(n(got), n(m.shard(t(ref))), atol=tol, rtol=0)


@pytest.mark.parametrize("epilogue", ["twist_inv", "xpay", "clover_inv"])
def test_plain_halo_epilogues_match_unsharded(epilogue):
    """The epilogues compose with halo mode: stitched (2, 2) shards equal
    the unsharded plain version, float64."""
    u = t(_gauge())
    psi, psi0 = t(spinor_pk(LAT, 82)), t(spinor_pk(LAT, 83))
    cl = t(np.random.default_rng(84).standard_normal((2, 2, 6, 6, *LAT.site_shape)))
    kw = dict(epilogue=epilogue, kappa=KAPPA, mu=MU)
    for parity in (0, 1):
        extra = {"psi0": psi0} if epilogue == "xpay" else {}
        if epilogue == "clover_inv":
            extra = {"clover": cl}
        full = dslash_eo_plain(u, psi, parity, LAT, **kw, **extra)
        for r in range(4):
            m = LatticeMesh(LAT, 2, 2, 1, r)
            ul, pl, halo = cut_halo(m, u, psi, parity)
            loc = {k: m.shard(v).contiguous() for k, v in extra.items()}
            got = dslash_eo_plain(ul, pl, parity, m.local_lat, halo=halo, **kw, **loc)
            torch.testing.assert_close(got, m.shard(full), atol=1e-12, rtol=0)


def test_plain_halo_matches_tpuqcd_pallas_halo_mode():
    """One shard of a (2, 2) grid, reconstruct-12 float32 on antiperiodic
    links, against tpuqcd's Pallas kernel in halo mode (interpret mode):
    the port's face operands moved into its appended layout (t-1, t+1
    slices after the local T; z slabs of block_z = Zl rows after the local
    Z, of which the kernel reads the last row of the lower and the first
    of the upper)."""
    u, psi = _gauge(), spinor_pk(LAT, 85)
    m = LatticeMesh(LAT, 2, 2, 1, 2)                      # t_offset 4: the rank with t = Lt-1
    Tl, Zl = m.local_dims
    for parity, dagger in ((0, False), (1, True)):
        ul, pl, halo = cut_halo(m, t(u[:, :, :2], torch.float32), t(psi, torch.float32),
                                parity, dagger, half=False)
        got = dslash_eo_plain(ul, pl, parity, m.local_lat, dagger=dagger, halo=halo)
        psi_ext = np.zeros((2, 4, 3, Tl + 2, 3 * Zl, ul.shape[-1]), np.float32)
        psi_ext[:, :, :, :Tl, :Zl] = n(pl)
        psi_ext[:, :, :, Tl, :Zl], psi_ext[:, :, :, Tl + 1, :Zl] = n(halo.t_m), n(halo.t_p)
        psi_ext[:, :, :, :Tl, 2 * Zl - 1], psi_ext[:, :, :, :Tl, 2 * Zl] = n(halo.z_m), n(halo.z_p)
        u_ext = np.zeros((4, 2, 2, 3, 2, Tl + 1, 2 * Zl, ul.shape[-1]), np.float32)
        u_ext[..., :Tl, :Zl, :] = n(ul)
        u_ext[3, parity, :, :, :, Tl, :Zl] = n(halo.u_t)
        u_ext[2, parity, :, :, :, :Tl, 2 * Zl - 1] = n(halo.u_z)
        ref = dslash_eo_pallas(jnp.asarray(u_ext), jnp.asarray(psi_ext), parity, JLAT,
                               dagger=dagger, block_z=Zl, interpret=True, local_dims=(Tl, Zl),
                               halo_t=True, halo_z=True, t_offset=m.t_offset)
        np.testing.assert_allclose(n(got), np.asarray(ref), atol=3e-5, rtol=0)


# --------------------------------------------------------------------------
# gloo ranks

def _torchrun(nproc: int, *args) -> subprocess.CompletedProcess:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(nproc), *args]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(ROOT),
                            "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r


def _inputs():
    return dict(u=_gauge(), psi=spinor_pk(LAT, 90), b=spinor_pk(LAT, 91, parities=2),
                chi=np.stack([spinor_pk(LAT, 92), spinor_pk(LAT, 93)]),
                bd=np.stack([spinor_pk(LAT, 94, 2), spinor_pk(LAT, 95, 2)]).astype(np.float32),
                dims=np.array(LAT.dims), kappa=KAPPA, mu=MU, mubar=MUBAR, epsbar=EPSBAR)


@pytest.fixture(scope="module", params=[(2, 1), (2, 2)], ids=["nt2", "nt2nz2"])
def ranks(request, tmp_path_factory):
    """The worker's results on a grid of gloo ranks, and its inputs."""
    nt, nz = request.param
    tmp = tmp_path_factory.mktemp(f"ranks{nt}{nz}")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    _torchrun(nt * nz, "tests/_torch_sharded_worker.py", "--inputs", str(tmp / "in.npz"),
              "--out", str(tmp / "out.npz"), "--nt", str(nt), "--nz", str(nz))
    return dict(np.load(tmp / "out.npz")), inp


def _reference(op_name, method, inp):
    u = jnp.asarray(inp["u"])
    if op_name == "tm":
        op, x, b = JTM(JLAT, kappa=KAPPA, mu=MU, backend="xla"), inp["psi"], inp["b"]
    else:
        op = JNdeg(JLAT, kappa=KAPPA, mubar=MUBAR, epsbar=EPSBAR, backend="xla")
        x, b = inp["chi"], inp["bd"].astype(np.float64)
    x, b = jnp.asarray(x), jnp.asarray(b)
    if method == "prepare":
        return np.asarray(op.prepare(u, b))
    if method == "reconstruct":
        return np.asarray(op.reconstruct(u, x, b))
    return np.asarray(getattr(op, method)(u, x))


@pytest.mark.parametrize("method", ["apply", "apply_dagger", "prepare", "reconstruct"])
@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("op_name", ["tm", "ndeg"])
def test_sharded_operator_matches_tpuqcd(ranks, op_name, prec, method):
    out, inp = ranks
    got = out[f"{op_name}_{prec}_{method}"]
    np.testing.assert_allclose(got, _reference(op_name, method, inp), atol=TOL[prec], rtol=0)


def test_sharded_ndeg_solve(ranks):
    """solve_ndeg_tm_sharded's x against the unsharded solve, and its
    even-odd residual through tpuqcd's float64 operator; the exchanged
    faces equal the ones cut from the global fields."""
    out, inp = ranks
    assert out["faces_err"] == 0.0
    assert out["solve_relres"] <= 1e-12
    u = torch.from_numpy(inp["u"]).float()
    ref = solve_ndeg_tm(u, t(inp["bd"]), LAT, kappa=KAPPA, mubar=MUBAR, epsbar=EPSBAR, tol=1e-12)
    np.testing.assert_allclose(out["solve_x"], n(ref.x), atol=1e-10, rtol=0)
    op = JNdeg(JLAT, kappa=KAPPA, mubar=MUBAR, epsbar=EPSBAR, backend="xla")
    uj, x = jnp.asarray(inp["u"]), jnp.asarray(out["solve_x"])
    bhat = op.prepare(uj, jnp.asarray(inp["bd"], jnp.float64))
    r = np.asarray(bhat - op.apply(uj, x[:, 0]))
    assert np.linalg.norm(r) / np.linalg.norm(np.asarray(bhat)) <= 1e-11


def test_run_invert_on_two_gloo_ranks():
    """The user's path: torchrun, two CPU ranks over gloo, mesh nt = 2;
    rank 0 alone prints the RESULT line, certified to the tolerance."""
    r = _torchrun(2, "-m", "tpuqcd_torch.cli.run_invert", "--config",
                  "examples/invert_ndeg_mesh.yaml", "--device", "cpu")
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    assert len(lines) == 1 and lines[0].endswith("ndeg=1"), r.stdout[-2000:]
    fields = dict(kv.split("=", 1) for kv in re.findall(r"\w+=\S+", lines[0]))
    assert float(fields["relres"]) <= 1e-10
