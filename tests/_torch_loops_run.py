"""Shared helpers of tests/test_torch_run_loops*.py: the configuration of a
loop run at 2x2x2x4, the exact solver handed to tpuqcd (the dense inverse
of tpuqcd's own full-lattice operator), tpuqcd's run_loops._measure with
these stand-ins (run_tpuqcd; also tests/test_torch_run_loops_mesh.py's),
and one run of it and of the port's run_loops.measure on the same gauge,
noises and Lanczos start vector (see test_torch_run_loops.py)."""
import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd.cli import run_loops as j_run
from tpuqcd.fields import EVEN, ODD
from tpuqcd.fields import apply_boundary_phase as j_apply_boundary_phase
from tpuqcd.fields import eo_to_full as j_eo_to_full
from tpuqcd.fields import full_to_eo as j_full_to_eo
from tpuqcd.fields import gauge_full_to_eo as j_gauge_full_to_eo
from tpuqcd.operators import TMOperator
from tpuqcd.operators import gamma5_apply_dev as j_gamma5_apply_dev
from tpuqcd.ops.clover import clover_apply as j_clover_apply
from tpuqcd.ops.clover import clover_blocks as j_clover_blocks
from tpuqcd.ops.dslash_xla import dslash_eo_dev as j_dslash_eo_dev
from tpuqcd.ops.layout import gauge_to_device as j_gauge_to_device
from tpuqcd.ops.layout import spinor_from_device as j_spinor_from_device
from tpuqcd.ops.layout import spinor_to_device as j_spinor_to_device
from tpuqcd.phys import loops_dev as jloops
from tpuqcd.solvers import lanczos as jlanczos
from tpuqcd.utils.config import load_config as j_load_config
from tpuqcd.utils.dense import all_to_all_propagator
from tpuqcd.utils.packed import pack_gauge as j_pack_gauge

from tpuqcd_torch.cli import run_loops
from tpuqcd_torch.cli.common import Gauge
from tpuqcd_torch.ops.gauge_tools import plaquette
from tpuqcd_torch.phys.loops_dev import z4_noise_pk
from tpuqcd_torch.solve import full_system_relres
from tpuqcd_torch.utils.config import config_from_dict
from tpuqcd_torch.utils.packed import unpack_gauge

from _torch_inputs import gauge_full, jax_gauge_pk, lattices, t

LAT, JLAT = lattices((2, 2, 2, 4))

#: the cases: physics and action keys over examples/loops.yaml's
CASES = {
    "plain": ({"n_noise": 2, "dilute_t": 2, "dilute_sc": True}, {}),
    "tsm_deflation": ({"n_noise": 1, "tsm_cheap": 2, "tsm_maxiter_cheap": 8,
                       "n_deflate": 4, "dilute_sc": True}, {}),
    # no TSM here: tpuqcd compiles its batched clover solve for over a minute
    "clover": ({"n_noise": 1, "n_deflate": 2, "dilute_t": 2}, {"csw": 1.2}),
}


def raw_config(case: str, out: str) -> dict:
    physics, action = CASES[case]
    return {"gauge": {"dims": list(LAT.dims), "random_seed": 4},
            "action": {"kappa": 0.11, "mu": 0.07, **action},
            "solver": {"tol": 1.0e-8, "backend": "xla"},
            "physics": {"momenta": [[0, 0, 0], [1, 0, 0]], "output": out, **physics}}


def j_config_from_dict(raw: dict):
    """tpuqcd's config of ``raw`` (its loader reads YAML files only)."""
    import tempfile

    import yaml
    with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
        yaml.safe_dump(raw, f)
    try:
        return j_load_config(f.name)
    finally:
        Path(f.name).unlink()


def _tm_clover_full(u_dev, kappa, mu, csw, flavor):
    """tpuqcd's twisted-clover operator M = Atw - kappa D on full-layout
    spinors [T, Z, Y, X, 4, 3], Atw = A + 2 i kappa mu flavor g5 with its
    clover blocks A: the even and odd rows of the full system, as
    tests/test_clover.py::test_tmclover_solve writes them."""
    a_blocks, tw = j_clover_blocks(u_dev, JLAT, kappa, csw), 2.0 * kappa * mu * flavor

    def atw(par, v):
        return j_clover_apply(a_blocks[par], v) + (1j * tw) * j_gamma5_apply_dev(v)

    def apply(v):
        x = j_spinor_to_device(j_full_to_eo(v, JLAT), JLAT)          # [2, 4, 3, T, Z, S]
        even = atw(EVEN, x[0]) - kappa * j_dslash_eo_dev(u_dev, x[1], ODD, JLAT)
        odd = atw(ODD, x[1]) - kappa * j_dslash_eo_dev(u_dev, x[0], EVEN, JLAT)
        return j_eo_to_full(j_spinor_from_device(jnp.stack([even, odd]), JLAT), JLAT)
    return apply


def _operators(cfg, u_full, u_dev):
    """flavor -> the dense inverse of tpuqcd's full-lattice operator (its
    TMOperator, or its twisted clover with action.csw) on full-layout
    fields, complex [12 V, 12 V] (utils/dense.all_to_all_propagator, as
    tests/test_torch_threeptwop.py solves)."""
    a, inv = cfg.action, {}
    for flavor in (+1, -1):
        if a.csw:
            op = _tm_clover_full(u_dev, a.kappa, a.mu, a.csw, flavor)
        else:
            op = functools.partial(TMOperator(JLAT, kappa=a.kappa, mu=a.mu, flavor=flavor).apply,
                                   u_full)
        ap = jax.jit(lambda v, op=op: op(v.reshape(*JLAT.full_shape, 4, 3))
                     .reshape(*JLAT.full_shape, 12))
        inv[flavor] = all_to_all_propagator(ap, JLAT).reshape(12 * JLAT.volume, -1)
    return inv


class _ExactSolve:
    """tpuqcd's make_solver by the exact inverse, on packed batches
    [n, 2(par), 2(ri), 4, 3, T, Z, S], through tpuqcd's layout maps."""
    lmesh = None

    def __init__(self, inv):
        self.inv = inv

    @staticmethod
    def put(x):
        return jnp.asarray(x)

    def packed_src_batch(self, b_pks, flavor=+1):
        n = b_pks.shape[0]
        b = np.asarray(b_pks, np.float64)
        full = j_eo_to_full(j_spinor_from_device(jnp.asarray(b[:, :, 0] + 1j * b[:, :, 1]),
                                                 JLAT), JLAT, site_ndim_left=1)
        x = np.asarray(full).reshape(n, -1) @ self.inv[flavor].T
        x = j_spinor_to_device(j_full_to_eo(jnp.asarray(x.reshape(n, *JLAT.full_shape, 4, 3)),
                                            JLAT, site_ndim_left=1), JLAT)
        return jnp.stack([jnp.real(x), jnp.imag(x)], axis=2).astype(jnp.float32)


def read_all(path) -> dict:
    """Every dataset of an HDF5 file by its path."""
    import h5py
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda k, v: out.__setitem__(k, v[()]) if isinstance(v, h5py.Dataset)
                     else None)
    return out


def run_tpuqcd(raw: dict, u_np: np.ndarray) -> dict:
    """tpuqcd's run_loops._measure of the one-device configuration ``raw``
    on the links u_np (full layout, without the boundary phase, which is
    applied here), with three stand-ins: the port's Z4 noises by tpuqcd's
    keys, the port's Lanczos start vector and the exact solver of
    _operators; the datasets of its physics.output."""
    cfg, jcfg = config_from_dict(raw), j_config_from_dict(raw)
    ph = cfg.physics
    u_full = j_apply_boundary_phase(jnp.asarray(u_np.astype(np.complex64)), JLAT)
    u_dev = j_gauge_to_device(j_gauge_full_to_eo(u_full, JLAT), JLAT)
    inv = _operators(cfg, u_full, u_dev)
    # the shared inputs: the port's noises by tpuqcd's keys, the port's start vector
    noises = {}
    for seed, n in ((17, ph.n_noise), (23, ph.tsm_cheap)):
        gen = torch.Generator().manual_seed(seed)
        for key in jax.random.split(jax.random.PRNGKey(seed), n) if n else []:
            noises[np.asarray(key).tobytes()] = z4_noise_pk(gen, LAT).numpy()
    v0 = torch.randn((2, 2, 4, 3, *LAT.site_shape), generator=torch.Generator().manual_seed(9))
    j_lanczos = jlanczos.lanczos_lowest_pk
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUQCD_DEVICE_CONTRACT", "1")
        mp.setattr(j_run, "setup_gauge", lambda c: (JLAT, u_full, j_pack_gauge(u_dev), u_dev))
        mp.setattr(j_run, "make_solver", lambda c, lat, u_pk, u: _ExactSolve(inv))
        mp.setattr(jloops, "z4_noise_pk",
                   lambda key, lat: jnp.asarray(noises[np.asarray(key).tobytes()]))
        mp.setattr(jlanczos, "lanczos_lowest_pk",
                   lambda apply, _v0, n_ev, **kw: j_lanczos(apply, jnp.asarray(v0.numpy()),
                                                            n_ev, **kw))
        j_run._measure(jcfg)
    return read_all(jcfg.physics.output)


def run_both(case, tmp):
    cfg = config_from_dict(raw_config(case, str(tmp / "port.h5")))
    ph = cfg.physics
    if ph.n_deflate:
        cfg = dataclasses.replace(cfg, physics=dataclasses.replace(
            ph, eig_outfile=str(tmp / "port_eig.npz")))
    u_np = gauge_full(LAT, 3)
    ref = run_tpuqcd(raw_config(case, str(tmp / "ref.h5")), u_np)
    tu = t(jax_gauge_pk(u_np, JLAT, True, jnp.float32))
    plaq = plaquette(unpack_gauge(t(jax_gauge_pk(u_np, JLAT, False, jnp.float32))), LAT)
    audited = []

    def audit(b, x, flavor):
        audited.extend(full_system_relres(tu, b[i], x[i], LAT, kappa=cfg.action.kappa,
                                          mu=cfg.action.mu, flavor=flavor, csw=cfg.action.csw)
                       for i in range(b.shape[0]))
    res = run_loops.measure(cfg, torch.device("cpu"), Gauge(LAT, tu, plaq, 0.0),
                            keep_fields=True, audit=audit)
    run_loops.write(cfg, res)
    return ref, read_all(cfg.physics.output), res, cfg, audited


def check_datasets(case, ref, got, cfg):
    """Every dataset of tpuqcd's file in the port's, within 1e-4 of its
    largest value."""
    groups = ["oneend", "oneend_der"] + (["oneend_lowmode", "oneend_lowmode_der"]
                                         if cfg.physics.n_deflate else [])
    assert sorted({k.split("/")[1] for k in ref}) == sorted(groups)
    assert sorted(got) == sorted(ref)
    assert len(ref) == len(groups) // 2 * (16 + 64)
    for name, want in ref.items():
        assert got[name].shape == want.shape == (2, LAT.Lt) and np.isfinite(got[name]).all()
        np.testing.assert_allclose(got[name], want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=f"{case}: {name}")


def check_columns_and_stages(res, cfg, audited):
    """Every column certified by the solver and by an independent float64
    residual (Solver.audit; the cheap TSM solves go around the solver),
    the stages timed, tpuqcd's attributes."""
    ph = cfg.physics
    classes = ph.dilute_t * (12 if ph.dilute_sc else 1)
    assert sum(r["columns"] for r in res.solves) == ph.n_noise * classes + ph.n_deflate
    assert len(audited) == ph.n_noise * classes + ph.n_deflate
    assert max(audited) <= cfg.solver.tol
    assert all(max(r["relres"]) <= cfg.solver.tol for r in res.solves)
    want = {"gauge", "solves", "loops", "derivatives", "write"}
    if ph.tsm_cheap:
        want |= {"tsm_cheap", "solves_correction"}
        assert sorted(res.tsm) == ["cheap", "full"]
    if ph.n_deflate:
        want |= {"lanczos", "lowmode"}
    assert set(res.seconds) == want
    assert res.meta == {"n_noise": ph.n_noise, "kappa": 0.11, "mu": 0.07,
                        "tsm_cheap": ph.tsm_cheap, "n_deflate": ph.n_deflate,
                        "dilute_t": ph.dilute_t, "dilute_sc": int(ph.dilute_sc)}


def check_basis(res, cfg):
    """The deflation basis orthonormal, its Rayleigh quotients positive and
    ascending, eig_outfile equal to it."""
    from tpuqcd_torch.utils.checkpoint import load_eigenpairs
    if not cfg.physics.n_deflate:
        assert res.evals is None and res.evecs is None
        return
    v = res.evecs.reshape(len(res.evals), 2, -1).double()
    c = torch.complex(v[:, 0], v[:, 1])
    np.testing.assert_allclose((c.conj() @ c.T).numpy(), np.eye(len(res.evals)), atol=1e-5)
    assert np.all(res.evals > 0) and np.all(np.diff(res.evals) >= 0)
    evals, evecs = load_eigenpairs(cfg.physics.eig_outfile, expect_layout="packed")
    assert np.array_equal(evals, res.evals)
    assert torch.equal(torch.stack(evecs), res.evecs)
