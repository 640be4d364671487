"""MG's bfloat16 solver buffers against tpuqcd on the CPU, at 4^3x8 (block
2^4, n_vec 4): mg.gcr_dtype stores the fine level's outer GCR basis in
bfloat16 (solvers/krylov_pk._gcr_cycle), mg.vec_dtype the null-vector
bank of every transfer (mg/device.py, bfloat16 (re, im) pairs widened a
chunk of aggregates at a time); every product and sum stays float32.
A hierarchy set up by tpuqcd with both buffers in bfloat16 and dumped
with its save_device_mg is loaded into the port, so both packages run the
same bfloat16 bank, Linv and Galerkin links.

Tolerances, on |port - tpuqcd| / |tpuqcd|: 1e-3 for x and r of a GCR
cycle with the bfloat16 basis (both packages round the same float32
directions, 1e-7 apart, to bfloat16; an element on the other side of a
rounding midpoint moves by 2^-8 of itself, and the next directions are
orthogonalised against the rounded ones); 1e-5 for restrict, prolong and
Linv on the same bfloat16 bank (float32 sums in another order); 1e-4 for
a V-cycle (as tests/test_torch_mg_solve.py); 1e-6 for certified
solutions; the float32 basis bit for bit the port's cycle before the
basis took a dtype.  Cost: about 70 s serial, most of it tpuqcd's setup
(built once) and its XLA compiles of the cycle and the solve."""
import copy
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tpuqcd.mg import device as jdevice
from tpuqcd.mg.dsolve import DeviceMG as JDeviceMG, DeviceMGParams as JParams
from tpuqcd.solvers.krylov_pk import _gcr_cycle as j_gcr_cycle
from tpuqcd.utils import checkpoint as jcheckpoint
from tpuqcd.utils.config import load_config as j_load_config

from tpuqcd_torch.cli import run_invert
from tpuqcd_torch.cli.common import check_in_slice, mg_params
from tpuqcd_torch.mg.device import (BANK_CHUNK_FIELDS, DeviceCoarseTransfer, DeviceFineLevel,
                                    DeviceFineTransfer, build_coarse_device)
from tpuqcd_torch.mg.dsolve import DeviceMG, DeviceMGParams
from tpuqcd_torch.solvers.krylov_pk import _gcr_cycle, mr_smoother_pk
from tpuqcd_torch.utils import pkalg as pk
from tpuqcd_torch.utils.checkpoint import load_device_mg, save_device_mg
from tpuqcd_torch.utils.config import load_config

from _torch_inputs import gauge_full, jax_gauge_pk, lattices, n, t

LAT, JLAT = lattices((4, 4, 4, 8))
KAPPA, MU = 0.15, 0.1
ROOT = Path(__file__).resolve().parents[1]
PARAMS = dict(n_vec=(4,), block=((2, 2, 2, 2),), setup_iters=20, smoother_iters=3,
              coarse_iters=12, restart=6)
BF16 = dict(gcr_dtype="bfloat16", vec_dtype="bfloat16")


def _gauge():
    return jax_gauge_pk(gauge_full(LAT, 50), JLAT, True, jnp.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _source(seed, *lead):
    return np.random.default_rng(seed).standard_normal(
        (*lead, 2, 2, 4, 3, *LAT.site_shape)).astype(np.float32)


def _port_fine():
    return DeviceFineLevel(LAT, t(_gauge()), KAPPA, MU)


def _jax_fine():
    return jdevice.DeviceFineLevel(JLAT, _gauge(), KAPPA, MU, backend="xla")


def _hp_relres(b, x) -> float:
    """|b - M x| / |b| by tpuqcd's float64 operator (independent of the port)."""
    b64 = jnp.asarray(b, jnp.float64)
    r = b64 - _jax_fine().as_hp().apply(jnp.asarray(n(x)))
    return float(jnp.linalg.norm(r) / jnp.linalg.norm(b64))


@pytest.fixture(scope="module")
def jax_bf16_hierarchy(tmp_path_factory):
    """tpuqcd's hierarchy with both bfloat16 buffers, and its npz dump."""
    jmg = JDeviceMG(_jax_fine(), JParams(**PARAMS, **BF16))
    assert jmg.transfers[0].v_pk.dtype == jnp.bfloat16
    path = str(tmp_path_factory.mktemp("mgbf") / "jax_mg_bf16.npz")
    jcheckpoint.save_device_mg(path, jmg)
    return jmg, path


# --- the GCR basis ------------------------------------------------------------

def _parent_gcr_cycle(matvec, precond, x, r, m, cols=False):
    """The port's _gcr_cycle before its basis took a dtype, verbatim."""
    Z = torch.empty((m, *x.shape), dtype=x.dtype, device=x.device)
    V = torch.empty_like(Z)
    for i in range(m):
        z = precond(r)
        v = matvec(z)
        for j in range(i):
            br, bi = pk.cdot(V[j], v, cols=cols)
            z = pk.csub(br, bi, Z[j], z, cols)
            v = pk.csub(br, bi, V[j], v, cols)
        inv = torch.rsqrt(torch.clamp(pk.norm2(v, cols=cols), min=1e-30))
        Z[i] = inv * z
        V[i] = inv * v
        ar, ai = pk.cdot(V[i], r, cols=cols)
        x = pk.caxpy(ar, ai, Z[i], x, cols)
        r = pk.csub(ar, ai, V[i], r, cols)
    return x, r


@pytest.mark.parametrize("cols", [False, True], ids=["one", "cols"])
def test_gcr_cycle_float32_basis_is_bit_for_bit_the_parents(cols):
    """With the default float32 basis the cycle is the parent's, bit for bit
    (a flexible preconditioner: two MR steps)."""
    lv = _port_fine()
    b = t(_source(51, 2) if cols else _source(51))

    def pre(r):
        return mr_smoother_pk(lv.apply, r, iters=2, cols=cols)

    got = _gcr_cycle(lv.apply, pre, torch.zeros_like(b), b, 5, cols)
    want = _parent_gcr_cycle(lv.apply, pre, torch.zeros_like(b), b, 5, cols)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("cols", [False, True], ids=["one", "cols"])
def test_gcr_cycle_bf16_basis_matches_tpuqcd(cols):
    """One cycle of 6 with the bfloat16 basis against tpuqcd's
    _gcr_cycle(basis_dtype=bfloat16) on the same fine operator and source
    (two columns: jax.vmap of it, as tpuqcd's solve_batch), x and r to 1e-3;
    the bfloat16 basis moves both off the float32 basis' cycle."""
    lv, jl = _port_fine(), _jax_fine()
    b = _source(52, 2) if cols else _source(52)

    def j_cycle(r):
        return j_gcr_cycle(jl.apply, lambda v: v, jnp.zeros_like(r), r, 6,
                           basis_dtype=jnp.bfloat16)

    jx, jr = (jax.vmap(j_cycle) if cols else j_cycle)(jnp.asarray(b))
    tb = t(b)
    x, r = _gcr_cycle(lv.apply, lambda v: v, torch.zeros_like(tb), tb, 6, cols,
                      basis_dtype=torch.bfloat16)
    assert x.dtype == r.dtype == torch.float32
    assert _rel(n(x), jx) <= 1e-3 and _rel(n(r), jr) <= 1e-3
    x32, _ = _gcr_cycle(lv.apply, lambda v: v, torch.zeros_like(tb), tb, 6, cols)
    assert not torch.equal(x, x32)


# --- the null-vector bank -----------------------------------------------------

def test_port_bf16_bank_is_its_float32_bank_rounded():
    """From one generator the bfloat16 bank is the float32 bank rounded, at
    half its bytes; its Linv and Galerkin links are the float32 path's on
    the widened bank (float32 sums in another order; no mu boost, so the
    coarse level holds the Galerkin links themselves)."""
    fine = _port_fine()
    kw = dict(PARAMS, mu_factor=1.0)
    mg32 = DeviceMG(fine, DeviceMGParams(**kw), generator=torch.Generator().manual_seed(21))
    mg16 = DeviceMG(fine, DeviceMGParams(**kw, vec_dtype="bfloat16"),
                    generator=torch.Generator().manual_seed(21))
    tr32, tr16 = mg32.transfers[0], mg16.transfers[0]
    assert tr16.v.dtype == torch.bfloat16 and tr16.vec_dtype == torch.bfloat16
    assert 2 * tr16.v.numel() * tr16.v.element_size() == tr32.v.numel() * tr32.v.element_size()
    v16 = tr16.v_pk()
    assert v16.dtype == torch.float32
    assert torch.equal(v16, tr32.v_pk().to(torch.bfloat16).float())
    widened = DeviceFineTransfer.from_pk(LAT, PARAMS["block"][0], v16)
    assert widened.v.dtype == torch.complex64
    torch.testing.assert_close(tr16.linv, widened.linv, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(mg16.levels[1].links_c, build_coarse_device(fine, widened).links_c,
                               rtol=0, atol=1e-6 * mg16.levels[1].links_c.abs().max().item())
    # DeviceMG.rebuilt: the float32 hierarchy's bfloat16-bank twin without a
    # null-vector solve is the bfloat16 setup, bit for bit (the card's cell 4v)
    twin = mg32.rebuilt(DeviceMGParams(**kw, vec_dtype="bfloat16"))
    assert set(twin.setup_seconds) == {"galerkin0"}
    assert torch.equal(twin.transfers[0].v, tr16.v)
    assert torch.equal(twin.transfers[0].linv, tr16.linv)
    assert torch.equal(twin.levels[1].links_c, mg16.levels[1].links_c)
    assert mg32.transfers[0].v.dtype == torch.complex64       # the float32 hierarchy kept
    with pytest.raises(ValueError, match="n_vec"):
        mg32.rebuilt(DeviceMGParams(**dict(kw, n_vec=(3,))))


def _random_transfer(kind, dtype):
    """A transfer of random null vectors, tpuqcd's layout, in ``dtype``."""
    g = torch.Generator().manual_seed(22)
    if kind == "fine":
        v = torch.randn((4, 2, 2, 4, 3, *LAT.site_shape), generator=g)
        return DeviceFineTransfer.from_pk(LAT, (2, 2, 2, 2), v.to(dtype))
    v = torch.randn((3, 2, 8, 4 * 2 * 2 * 2), generator=g)          # N = 8 on a 4x2x2x2 level
    return DeviceCoarseTransfer.from_pk((4, 2, 2, 2), 8, (2, 2, 2, 2), v.to(dtype))


@pytest.mark.parametrize("kind", ["fine", "coarse"])
def test_bf16_bank_products_equal_the_widened_banks(kind):
    """A bfloat16 bank is stored as (re, im) pairs and widened a chunk of
    aggregates at a time: its restrict, prolong and Linv equal those of the
    complex64 bank of the same values (to float32 sums in another order),
    and the chunks cover the aggregates, each at most BANK_CHUNK_FIELDS
    fields of the level."""
    tr16 = _random_transfer(kind, torch.bfloat16)
    tr32 = _random_transfer(kind, torch.bfloat16)
    tr32 = type(tr32).from_pk(*((LAT, tr32.block) if kind == "fine"
                                else (tr32.dims, tr32.n_f, tr32.block)), tr32.v_pk())
    assert tr16.v.dtype == torch.bfloat16 and tr16.v.shape == (*tr32.v.shape, 2)
    assert torch.equal(torch.view_as_complex(tr16.v.float()), tr32.v)
    chunks = tr16._chunks()
    step = max(1, tr16.n_agg * BANK_CHUNK_FIELDS // tr16.n_vec)
    assert len(chunks) > 1 and all(s.stop - s.start <= step for s in chunks)
    assert sum(len(range(tr16.n_agg)[s]) for s in chunks) == tr16.n_agg
    torch.testing.assert_close(tr16.linv, tr32.linv, rtol=1e-6, atol=1e-6)
    g = torch.Generator().manual_seed(23)
    shape = (2, 2, 4, 3, *LAT.site_shape) if kind == "fine" else (2, 8, 32)
    for r in (torch.randn(shape, generator=g), torch.randn((3, *shape), generator=g)):
        torch.testing.assert_close(tr16.restrict(r), tr32.restrict(r), rtol=1e-5, atol=1e-5)
    xc = torch.randn((2, 3, tr16.n_c, tr16.Vc), generator=g)
    torch.testing.assert_close(tr16.prolong(xc), tr32.prolong(xc), rtol=1e-5, atol=1e-5)
    # stored() moves a bank between the two storages exactly, Linv kept
    assert torch.equal(tr32.stored(torch.bfloat16).v, tr16.v)
    assert tr32.stored(torch.bfloat16).linv is tr32.linv
    assert torch.equal(tr16.stored(torch.float32).v, tr32.v)
    assert tr16.stored(torch.bfloat16) is tr16


def test_transfers_on_a_tpuqcd_bf16_dump_match_tpuqcd(jax_bf16_hierarchy):
    """tpuqcd's bfloat16 bank loads bit for bit; restrict, prolong and the
    Linv of the block orthogonalization (tpuqcd upcasts one column at a
    time) agree with tpuqcd's to 1e-5."""
    jmg, path = jax_bf16_hierarchy
    assert np.load(path)["t0_v"].dtype.kind == "V"
    mg = load_device_mg(path, _port_fine(), DeviceMGParams(**PARAMS, **BF16))
    tr, jtr = mg.transfers[0], jmg.transfers[0]
    assert tr.v.dtype == torch.bfloat16
    np.testing.assert_array_equal(n(tr.v_pk()), np.asarray(jtr.v_pk.astype(jnp.float32)))
    mine = copy.copy(tr)
    mine.linv = tr.gram_linv()
    assert _rel(n(mine.linv_pk()), jtr.gram_linv()) <= 1e-5
    r = _source(53)
    assert _rel(n(tr.restrict(t(r))), jtr.restrict(jnp.asarray(r))) <= 1e-5
    xc = np.random.default_rng(54).standard_normal((2, tr.n_c, tr.Vc)).astype(np.float32)
    assert _rel(n(tr.prolong(t(xc))), jtr.prolong(jnp.asarray(xc))) <= 1e-5


def test_vcycle_with_the_bf16_bank_matches_tpuqcd(jax_bf16_hierarchy):
    jmg, path = jax_bf16_hierarchy
    mg = load_device_mg(path, _port_fine(), DeviceMGParams(**PARAMS, **BF16))
    np.testing.assert_array_equal(n(mg.levels[1].links_pk()), np.asarray(jmg.levels[1].links))
    b = _source(55)
    assert _rel(n(mg.precondition(t(b))), jmg.precondition(jnp.asarray(b))) <= 1e-4


def test_certified_solve_with_bf16_buffers_matches_tpuqcd(jax_bf16_hierarchy):
    """Both buffers in bfloat16 on tpuqcd's loaded hierarchy: certified to
    1e-10 by the solver and by tpuqcd's float64 operator, and within 1e-6
    of tpuqcd's certified solution."""
    jmg, path = jax_bf16_hierarchy
    mg = load_device_mg(path, _port_fine(), DeviceMGParams(**PARAMS, **BF16))
    b = _source(56)
    res = mg.solve_certified(t(b), tol=1e-10, inner_tol=1e-4, max_refine=20)
    assert res.relres <= 1e-10 and _hp_relres(b, res.x) <= 1e-10
    x_j, rel_j, _ = jmg.solve_certified(jnp.asarray(b), tol=1e-10, inner_tol=1e-4,
                                        max_refine=20)
    assert rel_j <= 1e-10
    assert _rel(n(res.x), x_j) <= 1e-6


def test_port_setup_with_bf16_buffers_certifies_one_and_three_columns():
    """The port's own setup with both bfloat16 buffers: one solve and a
    lockstep batch of three columns, each certified to 1e-10 by the solver
    and by tpuqcd's float64 operator."""
    mg = DeviceMG(_port_fine(), DeviceMGParams(**PARAMS, **BF16),
                  generator=torch.Generator().manual_seed(24))
    assert mg.transfers[0].v.dtype == torch.bfloat16
    b = _source(57, 3)
    res = mg.solve_certified(t(b[0]), tol=1e-10, inner_tol=1e-4, max_refine=20)
    assert res.relres <= 1e-10 and _hp_relres(b[0], res.x) <= 1e-10
    batch = mg.solve_certified_batch(t(b), tol=1e-10, inner_tol=1e-4, max_refine=20)
    assert max(batch.relres) <= 1e-10
    for i in range(3):
        assert _hp_relres(b[i], batch.x[i]) <= 1e-10


def _hierarchy_of(levels: int, buffers: dict) -> DeviceMG:
    """A cheap two-level hierarchy at 4^3x8, or three levels at 8^4 (blocks
    2^4 twice), with the buffers ``buffers`` (BF16 or none)."""
    if levels == 2:
        fine, kw = _port_fine(), dict(PARAMS, setup_iters=2)
    else:
        lat8, jlat8 = lattices((8, 8, 8, 8))
        fine = DeviceFineLevel(lat8, t(jax_gauge_pk(gauge_full(lat8, 51), jlat8, True,
                                                    jnp.float32)), KAPPA, MU)
        kw = dict(PARAMS, n_vec=(4, 4), block=((2, 2, 2, 2),) * 2, setup_iters=2)
    return DeviceMG(fine, DeviceMGParams(**kw, **buffers),
                    generator=torch.Generator().manual_seed(25))


@pytest.mark.parametrize("levels", [2, 3])
@pytest.mark.parametrize("buffers", ["float32", "bfloat16"])
def test_batch_bytes_count_the_basis_at_its_storage_size(buffers, levels):
    """batch_bytes is the sum of the buffers batch_buffers names, each its
    allocation's size: the fine GCR basis 2 bytes an element with gcr_dtype
    bfloat16, 4 with float32; 16 float32 fine fields of work a column; 2
    restart + 23 float32 fields of every coarse level a column (their bases
    stay float32, as in tpuqcd); each transfer's bank once in restrict (a
    float32 bank's conjugate, n_vec fields of the finer level; a bfloat16
    bank's widened chunk and its conjugate, 2); and the float64 operator
    once, until a solve builds it."""
    mg = _hierarchy_of(levels, BF16 if buffers == "bfloat16" else {})
    restart, fine = mg.params.restart, mg.levels[0]
    f = 4 * 2 * 2 * 12 * fine.lat.half_volume
    coarse = sum(4 * 2 * lv.n * lv.Vc for lv in mg.levels[1:])
    assert len(mg.levels) == levels
    items = mg.batch_buffers(3)
    assert mg.batch_bytes(3) == sum(items.values())
    basis = 3 * 2 * restart * f * (2 if buffers == "bfloat16" else 4) // 4
    assert items[f"GCR basis ({buffers})"] == basis
    work = {k: v for k, v in items.items()
            if k not in (f"GCR basis ({buffers})", "coarse levels", "restrict's bank",
                         "float64 operator")}
    assert sum(work.values()) == 3 * 16 * f
    assert items["coarse levels"] == 3 * (2 * restart + 23) * coarse
    fields = [f] + [4 * 2 * lv.n * lv.Vc for lv in mg.levels[1:-1]]
    assert items["restrict's bank"] == sum((2 if buffers == "bfloat16" else nv) * field
                                           for nv, field in zip(mg.params.n_vec, fields))
    assert items["float64 operator"] == 2 * fine.u_pk.nbytes == fine.as_hp().u_pk.nbytes
    mg._hp = fine.as_hp()                     # what solve_certified_batch builds once
    assert "float64 operator" not in mg.batch_buffers(3)
    assert mg.batch_bytes(3) - mg.batch_bytes(0) == 3 * ((2 * restart * (
        2 if buffers == "bfloat16" else 4) // 4 + 16) * f + (2 * restart + 23) * coarse)
    if buffers == "float32":                  # vec_dtype float32: the banks as given
        half = DeviceMG.from_parts(fine, dataclasses.replace(mg.params, gcr_dtype="bfloat16"),
                                   mg.transfers, mg.levels[1:])
        assert half.transfers == mg.transfers


def test_bf16_bank_dumps_round_trip(jax_bf16_hierarchy, tmp_path):
    """tpuqcd's file and the port's own: a bfloat16 bank is written as its
    exact float32 widening and read back bit for bit, into a bfloat16 bank
    with vec_dtype bfloat16 and a complex64 one with float32; tpuqcd reads
    the port's file into the same preconditioner."""
    jmg, path = jax_bf16_hierarchy
    p16 = DeviceMGParams(**PARAMS, **BF16)
    mg = load_device_mg(path, _port_fine(), p16)
    out = str(tmp_path / "port_bf16.npz")
    save_device_mg(out, mg)
    z = np.load(out)
    assert z["t0_v"].dtype == np.float32
    np.testing.assert_array_equal(z["t0_v"], n(mg.transfers[0].v_pk()))
    back = load_device_mg(out, _port_fine(), p16)
    assert torch.equal(back.transfers[0].v, mg.transfers[0].v)
    assert torch.equal(back.transfers[0].linv, mg.transfers[0].linv)
    wide = load_device_mg(out, _port_fine(), DeviceMGParams(**PARAMS))
    assert wide.transfers[0].v.dtype == torch.complex64
    assert torch.equal(wide.transfers[0].v_pk(), mg.transfers[0].v_pk())
    jback = jcheckpoint.load_device_mg(out, _jax_fine(), JParams(**PARAMS, **BF16))
    b = jnp.asarray(_source(58))
    assert _rel(jback.precondition(b), jmg.precondition(b)) <= 1e-5


def test_run_invert_with_bf16_buffers_cpu(tmp_path, capsys):
    """run_invert end to end with mg.gcr_dtype and vec_dtype bfloat16."""
    raw = {"gauge": {"dims": [4, 4, 4, 8], "random_seed": 1},
           "action": {"kappa": 0.12, "mu": 0.03}, "solver": {"tol": 1e-10},
           "mg": {"enabled": True, "n_vec": [4], "block": [[2, 2, 2, 2]], "setup_iters": 40,
                  **BF16}}
    path = tmp_path / "invert_bf16.yaml"
    path.write_text(yaml.safe_dump(raw))
    run_invert.main(["--config", str(path), "--device", "cpu"])
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("RESULT ")]
    assert len(line) == 1
    fields = dict(kv.split("=", 1) for kv in re.findall(r"\w+=\S+", line[0]))
    assert float(fields["relres"]) <= 1e-10
    res = run_invert.invert(load_config(str(path)), torch.device("cpu"))
    assert res.mg.transfers[0].v.dtype == torch.bfloat16
    assert res.relres <= 1e-10 and res.solver_relres <= 1e-10


def test_48cube_example_parses_to_the_same_params_in_both_packages():
    """examples/invert_mg_bf16_48cube.yaml: near_critical with both bfloat16
    buffers at 48^3x96, in the slice, read by both packages into the same
    DeviceMGParams."""
    path = str(ROOT / "examples/invert_mg_bf16_48cube.yaml")
    cfg, jcfg = load_config(path), j_load_config(path)
    check_in_slice(cfg)
    assert dataclasses.asdict(cfg.mg) == dataclasses.asdict(jcfg.mg)
    jm = jcfg.mg
    # tpuqcd/cli/common.py:386-397, its config -> DeviceMGParams
    jp = JParams(n_vec=tuple(jm.n_vec), block=tuple(jm.block), setup_iters=jm.setup_iters,
                 smoother_iters=jm.smoother_iters, coarse_iters=jm.coarse_maxiter,
                 restart=jm.restart, mu_factor=jm.mu_factor, setup_solver=jm.setup_solver,
                 smoother_dtype=jm.smoother_dtype, coarse_dtype=jm.coarse_dtype,
                 gcr_dtype=jm.gcr_dtype, vec_dtype=jm.vec_dtype)
    p = mg_params(cfg)
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    # inner_tol is the solver block's (solver.inner_tol), not the MG block's
    near = DeviceMGParams.near_critical()
    assert dataclasses.asdict(p) == {**dataclasses.asdict(near), **BF16,
                                     "inner_tol": p.inner_tol}
    assert cfg.solver.inner_tol == near.inner_tol
    assert cfg.gauge.dims == (48, 48, 48, 96) and cfg.gauge.heatbath_sweeps == 160
    assert (cfg.action.kappa, cfg.action.mu) == (0.157, 0.0009)


def test_twop_32cube_example_parses_to_the_same_params_in_both_packages():
    """examples/twop_mg_bf16_32cube.yaml (the two-point run at 32^3x64 through
    the MG branch in lockstep batches with both bfloat16 buffers): in the
    slice, read by both packages into the same MG params, solver and
    physics, with 4b's gauge recipe and action."""
    path = str(ROOT / "examples/twop_mg_bf16_32cube.yaml")
    cfg, jcfg = load_config(path), j_load_config(path)
    check_in_slice(cfg)
    assert dataclasses.asdict(cfg.mg) == dataclasses.asdict(jcfg.mg)
    assert dataclasses.asdict(cfg.solver) == dataclasses.asdict(jcfg.solver)
    for key in ("source_positions", "momenta", "projectors", "meson_channels",
                "smear_n_gauss", "smear_alpha_gauss", "smear_n_ape"):
        assert getattr(cfg.physics, key) == getattr(jcfg.physics, key), key
    assert dataclasses.asdict(mg_params(cfg)) == {
        **dataclasses.asdict(DeviceMGParams.near_critical()), **BF16,
        "inner_tol": mg_params(cfg).inner_tol}
    assert 1 < cfg.solver.rhs_batch < 12
    assert cfg.gauge.dims == (32, 32, 32, 64) and cfg.gauge.heatbath_sweeps == 160
    assert (cfg.action.kappa, cfg.action.mu, cfg.gauge.random_seed) == (0.157, 0.0009, 0)

