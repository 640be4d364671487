"""The port's non-degenerate doublet against tpuqcd's, on the CPU (plain
Dslash): PackedNdegTMOperatorPC, solve_ndeg_tm, the ndeg run_invert path
and its configuration.

Inputs are numpy arrays from seeds, handed to both.  Tolerances: float32
operators 3e-5 absolute (unit-size random fields, a few float32 ulps of
the 8-leg sum); float64 operators 1e-12; the solutions of two solves to
1e-12 agree to 1e-10."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd.operators import PackedNdegTMOperatorPC as JNdeg
from tpuqcd.solve import solve_ndeg_tm as j_solve_ndeg_tm

from tpuqcd_torch.cli import run_invert
from tpuqcd_torch.operators import PackedNdegTMOperatorPC
from tpuqcd_torch.solve import ndeg_full_relres, solve_ndeg_tm
from tpuqcd_torch.utils.config import ConfigError, config_from_dict
from tpuqcd_torch.utils.convert import packed_from_numpy

from _torch_inputs import gauge_full, jax_gauge_pk, lattices, n, spinor_pk, t

LAT, JLAT = lattices((4, 4, 4, 8))
#: the heavy doublet of ETMC's beta = 1.95 Nf=2+1+1 ensembles (arXiv:1010.3659)
KAPPA, MUBAR, EPSBAR = 0.115, 0.135, 0.170
#: storage: (link rows the port takes, numpy dtype, tolerance)
STORAGE = {"f32_recon12": (2, np.float32, 3e-5), "f64": (3, np.float64, 1e-12)}


def _gauge(antiperiodic_t=True):
    """A float32-valued gauge (as the CLI makes it), float64 for tpuqcd."""
    return jax_gauge_pk(gauge_full(LAT, 40), JLAT, antiperiodic_t, jnp.float32).astype(
        jnp.float64)


def _doublet(seed, parities=1):
    return np.stack([spinor_pk(LAT, seed, parities), spinor_pk(LAT, seed + 1, parities)])


@pytest.mark.parametrize("method", ["apply", "apply_dagger", "prepare", "reconstruct"])
@pytest.mark.parametrize("storage", sorted(STORAGE))
def test_ndeg_operator_matches_tpuqcd(storage, method):
    rows, dt, tol = STORAGE[storage]
    u = _gauge()
    ref_op = JNdeg(JLAT, kappa=KAPPA, mubar=MUBAR, epsbar=EPSBAR, backend="xla")
    op = PackedNdegTMOperatorPC(LAT, kappa=KAPPA, mubar=MUBAR, epsbar=EPSBAR)
    u_t = t(np.asarray(u)[:, :, :rows].astype(dt))
    chi, b = _doublet(50).astype(dt), _doublet(52, parities=2).astype(dt)
    if method == "reconstruct":
        ref = ref_op.reconstruct(u, jnp.asarray(chi, jnp.float64), jnp.asarray(b, jnp.float64))
        got = op.reconstruct(u_t, t(chi), t(b))
    elif method == "prepare":
        ref = ref_op.prepare(u, jnp.asarray(b, jnp.float64))
        got = op.prepare(u_t, t(b))
    else:
        ref = getattr(ref_op, method)(u, jnp.asarray(chi, jnp.float64))
        got = getattr(op, method)(u_t, t(chi))
    assert got.dtype == u_t.dtype and got.shape == ref.shape
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=tol, rtol=0)


def test_ndeg_full_operator_is_the_schur_system():
    """apply_full (the certification's M_nd) against the even-odd pieces:
    M_nd x = b with x from prepare/Mhat/reconstruct of the same b."""
    u = t(_gauge())
    op = PackedNdegTMOperatorPC(LAT, kappa=KAPPA, mubar=MUBAR, epsbar=EPSBAR)
    b, x_e = t(_doublet(60, parities=2)), t(_doublet(62))
    x = op.reconstruct(u, x_e, b)
    # M x = (Mhat x_e - bhat + b_e, b_o): the odd rows hold by construction
    mx = op.apply_full(u, x)
    torch.testing.assert_close(mx[:, 1], b[:, 1], atol=1e-12, rtol=0)
    torch.testing.assert_close(mx[:, 0], op.apply(u, x_e) - op.prepare(u, b) + b[:, 0],
                               atol=1e-12, rtol=0)


def test_solve_ndeg_tm_matches_tpuqcd():
    u = jax_gauge_pk(gauge_full(LAT, 40), JLAT, True, jnp.float32)
    b = _doublet(41, parities=2).astype(np.float32)
    kw = dict(kappa=KAPPA, mubar=MUBAR, epsbar=EPSBAR, tol=1e-12)
    ref = j_solve_ndeg_tm(u, jnp.asarray(b), JLAT, backend="xla", **kw)
    res = solve_ndeg_tm(packed_from_numpy(u, LAT), packed_from_numpy(b, LAT), LAT, **kw)
    assert res.relres <= 1e-12 and res.x.dtype == torch.float64
    assert res.x.shape == (2, 2, 2, 4, 3, *LAT.site_shape)
    np.testing.assert_allclose(n(res.x), np.asarray(ref.x), atol=1e-10, rtol=0)
    assert ndeg_full_relres(t(u), t(b), res.x, LAT, kappa=KAPPA, mubar=MUBAR,
                            epsbar=EPSBAR) <= 1e-11


def test_sloppy_hop_needs_the_links_phase():
    """On periodic links (t_boundary = +1) the reconstruct-12 float32
    operator equals the float64 one only when told the phase: with the
    antiperiodic default, which tpuqcd's run_invert.py:210-216 leaves in
    place, the rebuilt boundary row has the wrong sign."""
    u = t(_gauge(antiperiodic_t=False))
    chi = t(_doublet(70))
    exact = PackedNdegTMOperatorPC(LAT, kappa=KAPPA, mubar=MUBAR,
                                   epsbar=EPSBAR).apply(u, chi)
    u12 = u[:, :, :2].float().contiguous()
    for tb, close in ((1, True), (-1, False)):
        op = PackedNdegTMOperatorPC(LAT, kappa=KAPPA, mubar=MUBAR, epsbar=EPSBAR,
                                    t_boundary=tb)
        err = (op.apply(u12, chi.float()).double() - exact).abs().max().item()
        assert (err < 3e-5) == close, (tb, err)


def _ndeg_cfg(**extra):
    raw = {"gauge": {"dims": [4, 4, 4, 8], "random_seed": 3},
           "action": {"kappa": KAPPA, "mubar": MUBAR, "epsbar": EPSBAR},
           "solver": {"tol": 1e-10}}
    for section, kv in extra.items():
        raw.setdefault(section, {}).update(kv)
    return config_from_dict(raw)


@pytest.mark.parametrize("antiperiodic_t,want", [(True, -1), (False, 1)])
def test_run_invert_ndeg_passes_t_boundary(monkeypatch, capsys, antiperiodic_t, want):
    """The ndeg branch hands solve_ndeg_tm the phase its links carry, and
    certifies the doublet with an independent float64 residual."""
    seen = {}
    real = run_invert.solve_ndeg_tm

    def spy(*a, **kw):
        seen["t_boundary"] = kw["t_boundary"]
        return real(*a, **kw)
    monkeypatch.setattr(run_invert, "solve_ndeg_tm", spy)
    res = run_invert.invert(_ndeg_cfg(gauge={"antiperiodic_t": antiperiodic_t}),
                            torch.device("cpu"))
    assert seen["t_boundary"] == want
    assert res.relres <= 1e-10 and res.solver_relres <= 1e-10
    assert res.x.shape == (2, 2, 2, 4, 3, *LAT.site_shape) and res.b_pk.shape == res.x.shape
    out = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("RESULT ")]
    assert len(out) == 1 and out[0].endswith("ndeg=1")


@pytest.mark.parametrize("action,match", [
    ({"mubar": 0.0, "epsbar": 5.0}, "1 \\+ \\(2 k mubar\\)"),
    ({"csw": 1.0}, "plain mixed-precision CG"),
])
def test_ndeg_config_validation(action, match):
    with pytest.raises(ConfigError, match=match):
        _ndeg_cfg(action=action)
    with pytest.raises(ConfigError, match="plain mixed-precision CG"):
        _ndeg_cfg(mg={"enabled": True})


@pytest.mark.parametrize("mesh,solver,match", [
    ({"nt": 3}, {}, "mesh.nt = 3"), ({"nt": 8}, {}, "even local extent"),
    ({"nz": 4}, {}, "mesh.nz = 4"), ({"ny": 2}, {"comm_policy": "fused"}, "overlap engine"),
    ({}, {"comm_policy": "ring"}, "comm_policy"),
])
def test_mesh_config_validation(mesh, solver, match):
    with pytest.raises(ConfigError, match=match):
        _ndeg_cfg(mesh=mesh, solver=solver)
