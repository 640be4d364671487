"""The port's twisted-clover solve against tpuqcd on the CPU, at 4^3x8
with the action of test_clover.py (kappa 0.115, mu 0.06, csw 1.2).

Every case feeds the same numpy inputs to both packages.  The operator
cases hand the port tpuqcd's own clover arrays (utils/convert.
clover_from_numpy), so they compare the operators alone; the clover
term is compared on its own.

Tolerances: 5e-6 abs on the complex64 A blocks (float32 sums of the four
leaves in another order); 3e-5 abs for the float32 Schur operator, as in
test_clover.py; 1e-12 abs for float64 operators; 1e-9 relative between
certified solutions of the same system (both within 1e-10); 1e-4 for a
V-cycle with the float32 smoother, as in test_torch_mg_solve.py, whose
certified MG solution tpuqcd's float64 clover operator checks."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd import gammas as jgammas
from tpuqcd.mg import device as jdevice
from tpuqcd.mg.dsolve import DeviceMG as JDeviceMG, DeviceMGParams as JParams
from tpuqcd.operators import PackedTMCloverOperatorPC as JOp
from tpuqcd.ops import clover as jclover
from tpuqcd.solve import (full_system_relres as j_full_system_relres,
                          make_clover_fields as j_make_clover_fields, solve_tm as j_solve_tm)
from tpuqcd.utils import checkpoint as jcheckpoint
from tpuqcd.utils.packed import unpack_gauge as j_unpack_gauge

from tpuqcd_torch.cli import run_invert
from tpuqcd_torch.cli.common import check_in_slice
from tpuqcd_torch.gammas import SIGMA_MUNU
from tpuqcd_torch.mg.device import DeviceFineCloverLevel
from tpuqcd_torch.mg.dsolve import DeviceMGParams
from tpuqcd_torch.operators import PackedTMCloverOperatorPC, PackedTMOperatorPC
from tpuqcd_torch.ops import clover, dslash_cuda
from tpuqcd_torch.solve import (clover_pk_from_gauge, full_system_relres, make_clover_fields,
                                solve_tm)
from tpuqcd_torch.utils.checkpoint import load_device_mg
from tpuqcd_torch.utils.config import load_config
from tpuqcd_torch.utils.convert import clover_from_numpy
from tpuqcd_torch.utils.packed import pack_clover, unpack_gauge

from _torch_inputs import gauge_full, jax_gauge_pk, lattices, n, spinor_pk, t

LAT, JLAT = lattices((4, 4, 4, 8))
KAPPA, MU, CSW = 0.115, 0.06, 1.2
ROOT = Path(__file__).resolve().parents[1]
MG_PARAMS = dict(n_vec=(4,), block=((2, 2, 2, 2),), setup_iters=4, smoother_iters=3,
                 coarse_iters=12, restart=6)


def _gauge(seed=50):
    """tpuqcd's packed float32 gauge with the boundary phase, as the CLI
    makes it."""
    return jax_gauge_pk(gauge_full(LAT, seed), JLAT, True, jnp.float32)


@pytest.fixture(scope="module")
def jfields():
    """tpuqcd's clover construction on the shared gauge: (u, cl_pk,
    clinv_plus, clinv_minus), float32 numpy, its inverses in complex64."""
    u = _gauge()
    return (np.asarray(u), *(np.asarray(a) for a in
                             j_make_clover_fields(u, JLAT, kappa=KAPPA, mu=MU, csw=CSW)))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_sigma_and_chirality_match_tpuqcd():
    np.testing.assert_allclose(SIGMA_MUNU.numpy(), np.asarray(jgammas.SIGMA_MUNU),
                               atol=1e-15, rtol=0)
    assert clover.CHIR_SPINS == jclover.CHIR_SPINS and clover.CHIR_SIGN == jclover.CHIR_SIGN


def test_clover_blocks_match_tpuqcd():
    u = _gauge()
    want = np.asarray(jclover.clover_blocks(j_unpack_gauge(u), JLAT, KAPPA, CSW))
    got = clover.clover_blocks(unpack_gauge(t(u)), LAT, KAPPA, CSW)
    assert got.dtype == torch.complex64 and got.shape == (2, 2, 6, 6, *LAT.site_shape)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-6, rtol=0)
    # Hermitian in each chiral block, and not the identity on a random gauge
    a = got.numpy()
    np.testing.assert_allclose(a, np.conj(a.transpose(0, 1, 3, 2, 4, 5, 6)), atol=1e-6)
    assert np.abs(a - np.eye(6)[:, :, None, None, None]).max() > 0.1
    # the packed form, as make_clover_fields returns it
    cl_pk = clover_pk_from_gauge(t(u), LAT, kappa=KAPPA, csw=CSW)
    assert cl_pk.dtype == torch.float32 and cl_pk.is_contiguous()
    np.testing.assert_array_equal(cl_pk[1, 1].numpy(), a[1].imag)


def test_free_field_clover_is_the_identity():
    """Unit gauge: F = 0, A = 1, and the twisted-clover Schur operator is
    the twisted-mass one."""
    unit = torch.zeros(4, 2, 3, 3, 2, *LAT.site_shape)
    unit[:, :, [0, 1, 2], [0, 1, 2], 0] = 1.0
    cl_pk, clp, clm = make_clover_fields(unit, LAT, kappa=KAPPA, mu=MU, csw=CSW)
    eye = torch.eye(6).reshape(6, 6, 1, 1, 1)
    assert torch.equal(cl_pk[:, 0], eye.expand(2, 2, 6, 6, *LAT.site_shape))
    assert torch.equal(cl_pk[:, 1], torch.zeros_like(cl_pk[:, 1]))
    psi = t(spinor_pk(LAT, 51))
    ops = (PackedTMCloverOperatorPC(LAT, kappa=KAPPA, mu=MU),
           PackedTMOperatorPC(LAT, kappa=KAPPA, mu=MU))
    u64 = unit.double()
    got = ops[0].apply((u64, cl_pk.double(), clp, clm), psi)
    torch.testing.assert_close(got, ops[1].apply(u64, psi), atol=1e-14, rtol=0)


@pytest.mark.parametrize("flavor", [1, -1])
def test_twist_inverse_is_complex128(flavor):
    """The inverse of the float32 A blocks in complex128, as numpy
    computes it, where tpuqcd inverts in complex64."""
    a = clover.clover_blocks(unpack_gauge(t(_gauge())), LAT, KAPPA, CSW)
    inv = clover.clover_twist_inverse(a, KAPPA, MU, flavor, 1)
    assert inv.dtype == torch.complex128
    tw = 2 * KAPPA * MU * flavor
    for c, sign in enumerate(clover.CHIR_SIGN):
        m = a[1, c].numpy().astype(np.complex128).reshape(6, 6, -1).transpose(2, 0, 1)
        want = np.linalg.inv(m + 1j * tw * sign * np.eye(6))
        got = inv[c].numpy().reshape(6, 6, -1).transpose(2, 0, 1)
        np.testing.assert_allclose(got, want, atol=1e-13, rtol=0)
        np.testing.assert_allclose(got @ (m + 1j * tw * sign * np.eye(6)),
                                   np.broadcast_to(np.eye(6), m.shape), atol=1e-13)
    # packed as make_clover_fields returns it: float64
    _, clp, clm = make_clover_fields(t(_gauge()), LAT, kappa=KAPPA, mu=MU, csw=CSW)
    assert clp.dtype == clm.dtype == torch.float64
    torch.testing.assert_close(clp if flavor == 1 else clm, pack_clover(inv, torch.float64),
                               atol=0, rtol=0)


def test_clover_apply_pk_matches_tpuqcd():
    rng = np.random.default_rng(52)
    cl = rng.standard_normal((2, 2, 6, 6, *LAT.site_shape))
    psi = spinor_pk(LAT, 53)
    want = np.asarray(jclover.clover_apply_pk(jnp.asarray(cl), jnp.asarray(psi)))
    np.testing.assert_allclose(n(clover.clover_apply_pk(t(cl), t(psi))), want, atol=1e-13,
                               rtol=0)
    # float32 blocks on a float64 spinor compute in float64, as in tpuqcd
    got = clover.clover_apply_pk(t(cl, torch.float32), t(psi))
    want = np.asarray(jclover.clover_apply_pk(jnp.asarray(cl, jnp.float32), jnp.asarray(psi)))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(n(got), want, atol=1e-12, rtol=0)


def test_clover_from_numpy(jfields):
    _, cl_pk, clp, clm = jfields
    tcl, tp, tm = clover_from_numpy(LAT, cl_pk, clp, clm)
    assert tcl.shape == (2, 2, 2, 6, 6, *LAT.site_shape) and tp.dtype == torch.float32
    np.testing.assert_array_equal(tm.numpy(), clm)
    with pytest.raises(ValueError, match="clover array"):
        clover_from_numpy(LAT, cl_pk[0])
    with pytest.raises(ValueError, match="clover array"):
        clover_from_numpy(LAT, cl_pk, clp.astype(np.float16))


def test_schur_operator_f32_matches_tpuqcd_pallas(jfields):
    """apply (its two launches, clover_inv and clover_xpay) against
    tpuqcd's Pallas clover epilogues in interpret mode, the port running
    the kernel's plain version on reconstruct-12 links; apply_dagger,
    prepare and reconstruct against tpuqcd's XLA operator."""
    u, cl_pk, clp, clm = jfields
    psi = np.asarray(spinor_pk(LAT, 54), np.float32)
    b = np.asarray(spinor_pk(LAT, 55, parities=2), np.float32)
    jf = tuple(jnp.asarray(a) for a in jfields)
    fields = (t(u[:, :, :2]), *clover_from_numpy(LAT, cl_pk, clp, clm))
    op = PackedTMCloverOperatorPC(LAT, kappa=KAPPA, mu=MU)
    ref = JOp(JLAT, kappa=KAPPA, mu=MU, csw=CSW, interpret=True)
    ref_x = JOp(JLAT, kappa=KAPPA, mu=MU, csw=CSW, backend="xla")
    pairs = [(op.apply(fields, t(psi)), ref.apply(jf, jnp.asarray(psi))),
             (op.apply_dagger(fields, t(psi)), ref_x.apply_dagger(jf, jnp.asarray(psi))),
             (op.prepare(fields, t(b)), ref_x.prepare(jf, jnp.asarray(b))),
             (op.reconstruct(fields, t(psi), t(b)),
              ref_x.reconstruct(jf, jnp.asarray(psi), jnp.asarray(b)))]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(n(got), np.asarray(want), atol=3e-5, rtol=0)


@pytest.mark.parametrize("flavor", [1, -1])
def test_schur_operator_f64_matches_tpuqcd_xla(jfields, flavor):
    jf = tuple(jnp.asarray(a, jnp.float64) for a in jfields)
    fields = tuple(t(a, torch.float64) for a in jfields)
    psi, b = spinor_pk(LAT, 56), spinor_pk(LAT, 57, parities=2)
    op = PackedTMCloverOperatorPC(LAT, kappa=KAPPA, mu=MU, flavor=flavor)
    ref = JOp(JLAT, kappa=KAPPA, mu=MU, csw=CSW, flavor=flavor, backend="xla")
    jpsi, jb = jnp.asarray(psi), jnp.asarray(b)
    pairs = [(op.apply(fields, t(psi)), ref.apply(jf, jpsi)),
             (op.apply_dagger(fields, t(psi)), ref.apply_dagger(jf, jpsi)),
             (op.normal(fields, t(psi)), ref.normal(jf, jpsi)),
             (op.prepare(fields, t(b)), ref.prepare(jf, jb)),
             (op.reconstruct(fields, t(psi), t(b)), ref.reconstruct(jf, jpsi, jb))]
    for got, want in pairs:
        np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-12, rtol=0)


def test_schur_dagger_is_the_adjoint(jfields):
    """<chi, Mhat psi> = <Mhat^dag chi, psi> with the port's own clover."""
    fields = make_clover_fields(t(jfields[0]), LAT, kappa=KAPPA, mu=MU, csw=CSW)
    fields = (t(jfields[0], torch.float64), *(f.double() for f in fields))
    op = PackedTMCloverOperatorPC(LAT, kappa=KAPPA, mu=MU)
    psi, chi = t(spinor_pk(LAT, 58)), t(spinor_pk(LAT, 59))

    def cdot(x, y):
        return torch.sum(torch.complex(x[0], x[1]).conj() * torch.complex(y[0], y[1]))
    lhs = cdot(chi, op.apply(fields, psi))
    rhs = cdot(op.apply_dagger(fields, chi), psi)
    assert abs(lhs - rhs) < 1e-12 * abs(lhs)


@pytest.mark.parametrize("flavor", [1, -1])
def test_fine_clover_level_matches_tpuqcd(jfields, flavor):
    """M v of DeviceFineCloverLevel: the float64 twin against tpuqcd's XLA
    level (1e-12), the float32 level and the bfloat16 smoother twin
    against it at their storage precision."""
    u, cl_pk = jfields[:2]
    jl = jdevice.DeviceFineCloverLevel(JLAT, jnp.asarray(u), jnp.asarray(cl_pk), KAPPA, MU,
                                       csw=CSW, flavor=flavor, backend="xla")
    lv = DeviceFineCloverLevel(LAT, t(u), clover_from_numpy(LAT, cl_pk)[0], KAPPA, MU,
                               flavor=flavor)
    v = np.random.default_rng(60).standard_normal((2, 2, 4, 3, *LAT.site_shape))
    want = np.asarray(jl.apply(jnp.asarray(v)))
    hp = lv.as_hp()
    assert hp.u12 is None and hp.clover_pk.dtype == torch.float64
    np.testing.assert_allclose(n(hp.apply(t(v))), want, atol=1e-12, rtol=0)
    assert _rel(n(lv.apply(t(v, torch.float32))), want) <= 1e-6
    sl = lv.sloppy()
    assert sl.u12.dtype == sl.clover_pk.dtype == torch.bfloat16
    assert _rel(n(sl.apply(t(v, torch.bfloat16))), want) <= 1e-2
    # the hops are the twisted-mass level's
    jtm = jdevice.DeviceFineLevel(JLAT, jnp.asarray(u), KAPPA, MU, flavor, backend="xla")
    np.testing.assert_allclose(n(hp.apply_hop(t(v), 3, -1)),
                               np.asarray(jtm.apply_hop(jnp.asarray(v), 3, -1)), atol=1e-12)


@pytest.fixture(scope="module")
def port_solve(jfields):
    """The port's direct clover solve on the shared gauge and source."""
    u = t(jfields[0])
    b = t(spinor_pk(LAT, 61, parities=2), torch.float32)
    clov = make_clover_fields(u, LAT, kappa=KAPPA, mu=MU, csw=CSW)
    res = solve_tm(u, b, LAT, kappa=KAPPA, mu=MU, csw=CSW, clover=clov, tol=1e-10,
                   solver="bicgstab")
    return u, b, clov, res


def test_clover_solve_matches_tpuqcd(port_solve):
    """tpuqcd's solve_tm given the port's float64 inverses through its
    clover= argument solves the same system to the same solution."""
    u, b, clov, res = port_solve
    assert res.relres <= 1e-10 and res.x.dtype == torch.float64
    jres = j_solve_tm(jnp.asarray(n(u)), jnp.asarray(n(b)), JLAT, kappa=KAPPA, mu=MU, csw=CSW,
                      clover=tuple(jnp.asarray(n(c)) for c in clov), tol=1e-10,
                      solver="bicgstab", backend="xla")
    assert float(jres.relres) <= 1e-10
    assert _rel(n(res.x), jres.x) <= 1e-9


def test_full_system_relres_meets_tol_where_tpuqcd_f32_inverses_do_not(port_solve, jfields):
    """The port certifies the even-odd system of the same M it checks:
    its full-system relres meets the tolerance.  tpuqcd's own
    make_clover_fields (complex64 inverses) through the same certified
    solve leaves the solution about 1e-8 from M x = b."""
    u, b, clov, res = port_solve
    mine = full_system_relres(u, b, res.x, LAT, kappa=KAPPA, mu=MU, csw=CSW,
                              clover_pk=clov[0])
    assert mine <= 1e-10
    # the same number from tpuqcd's own csw-aware check, and with A rebuilt
    ref = j_full_system_relres(jnp.asarray(n(u)), jnp.asarray(n(b)), jnp.asarray(n(res.x)),
                               JLAT, kappa=KAPPA, mu=MU, csw=CSW,
                               clover_pk=jnp.asarray(n(clov[0])))
    assert abs(mine - ref) < 1e-13
    assert abs(full_system_relres(u, b, res.x, LAT, kappa=KAPPA, mu=MU, csw=CSW) - mine) < 1e-12
    # tpuqcd's construction: solve_tm casts its operand tuple to float64
    # for the certification exactly as tpuqcd's tree_map does
    theirs = clover_from_numpy(LAT, *jfields[1:])
    assert theirs[1].dtype == torch.float32
    jres = solve_tm(u, b, LAT, kappa=KAPPA, mu=MU, csw=CSW, clover=theirs, tol=1e-10,
                    solver="bicgstab")
    assert jres.relres <= 1e-10
    rel = full_system_relres(u, b, jres.x, LAT, kappa=KAPPA, mu=MU, csw=CSW,
                             clover_pk=clov[0])
    assert rel > 1e-9 > 10 * mine


def test_clover_solve_bf16_bicgstab():
    """BASELINE config 2's solver: BiCGStab on bfloat16 storage."""
    u = t(_gauge(62))
    b = t(spinor_pk(LAT, 63, parities=2), torch.float32)
    res = solve_tm(u, b, LAT, kappa=KAPPA, mu=MU, csw=CSW, tol=1e-10, inner_tol=1e-2,
                   solver="bicgstab", sloppy_dtype=torch.bfloat16)
    assert res.relres <= 1e-10 and res.refinements > 1
    assert full_system_relres(u, b, res.x, LAT, kappa=KAPPA, mu=MU, csw=CSW) <= 1e-10


@pytest.fixture(scope="module")
def jax_clover_hierarchy(jfields, tmp_path_factory):
    """tpuqcd's MG hierarchy on its twisted-clover fine level, dumped."""
    u, cl_pk = jfields[:2]
    jl = jdevice.DeviceFineCloverLevel(JLAT, jnp.asarray(u), jnp.asarray(cl_pk), KAPPA, MU,
                                       csw=CSW, backend="xla")
    jmg = JDeviceMG(jl, JParams(**MG_PARAMS))
    path = str(tmp_path_factory.mktemp("mg") / "jax_clover_mg.npz")
    jcheckpoint.save_device_mg(path, jmg)
    return jmg, path


def test_clover_mg_vcycle_and_solve_match_tpuqcd(jfields, jax_clover_hierarchy):
    jmg, path = jax_clover_hierarchy
    u, cl_pk = jfields[:2]
    fine = DeviceFineCloverLevel(LAT, t(u), clover_from_numpy(LAT, cl_pk)[0], KAPPA, MU)
    mg = load_device_mg(path, fine, DeviceMGParams(**MG_PARAMS))
    b = np.random.default_rng(64).standard_normal((2, 2, 4, 3, *LAT.site_shape)) \
        .astype(np.float32)
    assert _rel(n(mg.precondition(t(b))), jmg.precondition(jnp.asarray(b))) <= 1e-4
    res = mg.solve_certified(t(b), tol=1e-10, inner_tol=1e-4, max_refine=20)
    assert res.relres <= 1e-10 and res.x.dtype == torch.float64 and res.refinements >= 2
    # tpuqcd's float64 clover operator certifies the port's solution
    r = jnp.asarray(b, jnp.float64) - jmg.levels[0].as_hp().apply(jnp.asarray(n(res.x)))
    assert float(jnp.linalg.norm(r) / jnp.linalg.norm(jnp.asarray(b, jnp.float64))) <= 1e-10


@pytest.mark.parametrize("example", ["invert_clover.yaml", "invert_clover_mg.yaml"])
def test_run_invert_clover_cli_cpu(example, capsys):
    """Both paths of the CLI with action.csw, on the plain version; the
    printed relres is the csw-aware full-system one."""
    check_in_slice(load_config(str(ROOT / "examples" / example)))
    dslash_cuda.reset_counts()
    run_invert.main(["--config", str(ROOT / "examples" / example), "--device", "cpu"])
    assert dslash_cuda.counts["plain"] > 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("RESULT ")]
    assert len(line) == 1
    fields = dict(kv.split("=", 1) for kv in re.findall(r"\w+=\S+", line[0]))
    assert float(fields["relres"]) <= 1e-10 and float(fields["solve_seconds"]) > 0
