"""The CUDA Dslash kernel against its plain PyTorch version on the card
(phase 3 of chip_smoke.py), in the summed modes (K1, K2), the leg modes
of MG probing (K4: dirs, legs_out), the clover epilogues (K3:
clover_inv, clover_xpay), the MG fine operators' xpay and clover_xpay
on parity views, halo mode (K6) on emulated shards of a (2, 2) grid with
the doublet solve through it, the bfloat16 pair kernel bit for bit against
the one-site kernel and the one-site kernel where pair_sites refuses (Xh
odd), the batch axis, reconstruct-8 links (K5), compute="bf16", and the
two- and three-point runs through them.  Marked ``gpu``;
skips without CUDA.

It imports neither jax nor tpuqcd, so it runs on a machine that has only
the port's dependencies:

    python -m pytest tests/test_torch_kernels_gpu.py --noconftest -q

Tolerances, on max|kernel - plain| / max|plain|: float64 1e-13, float32
1e-5, bfloat16 storage 1e-2 (about 2 bf16 ulp: both round a float32
result whose summation order differs); a batched launch equals its single
launches bit for bit; reconstruct-8 1e-12 / 1e-5 / 1e-2, and for bfloat16
2e-2 against the 18-real kernel, whose copy of the rebuilt link rounds once
more; compute="bf16" 5% of max|ref| against its plain version and against
float32 arithmetic."""
import pytest
import torch

from tpuqcd_torch import su3
from tpuqcd_torch.cli.run_invert import invert
from tpuqcd_torch.lattice import Lattice
from tpuqcd_torch.ops import dslash_cuda
from tpuqcd_torch.mg.device import DeviceFineCloverLevel, DeviceFineLevel, _hop_full
from tpuqcd_torch.ops.clover import clover_twist_inverse
from tpuqcd_torch.ops.dslash_cuda import LEG_ORDER, dslash_eo, dslash_eo_plain
from tpuqcd_torch.parallel.mesh import LatticeMesh
from tpuqcd_torch.parallel.sharded import ShardedNdegTMOperatorPC, cut_halo
from tpuqcd_torch.solve import clover_pk_from_gauge, solve_ndeg_tm_sharded
from tpuqcd_torch.utils.packed import pack_clover
from tpuqcd_torch.utils.config import config_from_dict
from tpuqcd_torch.utils.convert import gauge_from_full

pytestmark = pytest.mark.gpu

KAPPA, MU = 0.115, 0.08
STORAGE = {"f64": (torch.float64, 3, 1e-13), "f32": (torch.float32, 2, 1e-5),
           "bf16": (torch.bfloat16, 2, 1e-2)}
MODES = {"none": ("none", None), "twist_inv": ("twist_inv", None), "xpay": ("xpay", None),
         "xpay_full": ("xpay", KAPPA)}
CSW = 1.2
CLOVER_MODES = {"clover_inv": ("clover_inv", None), "clover_xpay": ("clover_xpay", None),
                "clover_xpay_full": ("clover_xpay", KAPPA)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _problem(dims, dev):
    lat = Lattice(dims)
    gen = torch.Generator().manual_seed(0)
    u = gauge_from_full(su3.random_gauge(lat, gen, dev, torch.complex128), lat, True,
                        torch.float64, dev)
    shape = (2, 4, 3, *lat.site_shape)
    psi = torch.randn(shape, generator=gen, dtype=torch.float64).to(dev)
    psi0 = torch.randn(shape, generator=gen, dtype=torch.float64).to(dev)
    return lat, u, psi, psi0


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("dims", [(8, 8, 8, 16), (32, 32, 32, 64)], ids=["8c16", "32c64"])
def test_kernel_matches_plain(cuda, dims, storage, mode):
    dt, rows, tol = STORAGE[storage]
    epi, scale = MODES[mode]
    lat, u64, psi, psi0 = _problem(dims, cuda)
    u = (u64 if rows == 3 else u64[:, :, :2]).to(dt).contiguous()
    psi, psi0 = psi.to(dt), psi0.to(dt)
    for parity in (0, 1):
        for dagger in (False, True):
            kw = dict(dagger=dagger, epilogue=epi, kappa=KAPPA, mu=MU, xpay_scale=scale,
                      psi0=psi0 if epi == "xpay" else None)
            before = dslash_cuda.counts[str(dt).removeprefix("torch.")]
            k = dslash_eo(u, psi, parity, lat, **kw).double()
            assert dslash_cuda.counts[str(dt).removeprefix("torch.")] == before + 1
            p = dslash_eo_plain(u, psi, parity, lat, **kw).double()
            torch.cuda.synchronize()
            assert torch.isfinite(k).all()
            rel = ((k - p).abs().max() / p.abs().max()).item()
            assert rel <= tol, (parity, dagger, rel)


def test_wrapper_refuses_a_view(cuda):
    lat, u, psi, _ = _problem((4, 4, 4, 4), cuda)
    with pytest.raises(ValueError, match="not contiguous"):
        dslash_eo(u.float()[:, :, :2], psi.float(), 0, lat)


def test_run_invert_goes_through_the_kernel(cuda):
    cfg = config_from_dict({"gauge": {"dims": [8, 8, 8, 16], "random_seed": 1},
                            "action": {"kappa": KAPPA, "mu": MU}})
    dslash_cuda.reset_counts()
    res = invert(cfg, cuda)
    assert res.relres <= 1e-10
    assert dslash_cuda.counts["float32"] > 0 and dslash_cuda.counts["float64"] > 0
    assert dslash_cuda.counts["plain"] == 0


@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("dims", [(8, 8, 8, 16), (32, 32, 32, 64)], ids=["8c16", "32c64"])
def test_leg_modes_match_plain(cuda, dims, storage):
    """dirs single legs, legs_out with 8 legs and with an out-of-order
    subset (slots in LEG_ORDER), both parities, dagger off and on."""
    dt, rows, tol = STORAGE[storage]
    lat, u64, psi, _ = _problem(dims, cuda)
    u = (u64 if rows == 3 else u64[:, :, :2]).to(dt).contiguous()
    psi = psi.to(dt)
    subset = ((3, -1), (0, +1), (2, +1))
    key = str(dt).removeprefix("torch.")
    for parity in (0, 1):
        for dagger in (False, True):
            singles = []
            for leg in LEG_ORDER:
                k = dslash_eo(u, psi, parity, lat, dagger=dagger, dirs=(leg,)).double()
                p = dslash_eo_plain(u, psi, parity, lat, dagger=dagger, dirs=(leg,)).double()
                assert ((k - p).abs().max() / p.abs().max()).item() <= tol, (leg, parity, dagger)
                singles.append(k)
            before = dslash_cuda.counts[key + ":legs_out"]
            legs = dslash_eo(u, psi, parity, lat, dagger=dagger, legs_out=True).double()
            assert dslash_cuda.counts[key + ":legs_out"] == before + 1
            p = dslash_eo_plain(u, psi, parity, lat, dagger=dagger, legs_out=True).double()
            torch.cuda.synchronize()
            assert legs.shape[0] == 8 and torch.isfinite(legs).all()
            assert ((legs - p).abs().max() / p.abs().max()).item() <= tol
            for slot, single in zip(legs, singles):
                assert ((slot - single).abs().max() / single.abs().max()).item() <= tol
            part = dslash_eo(u, psi, parity, lat, dagger=dagger, legs_out=True,
                             dirs=subset).double()
            order = [LEG_ORDER.index(leg) for leg in subset]
            for slot, i in zip(part, sorted(order)):
                assert ((slot - singles[i]).abs().max() / singles[i].abs().max()).item() <= tol


@pytest.mark.parametrize("flavor", [+1, -1])
@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("dims", [(8, 8, 8, 16), (32, 32, 32, 64)], ids=["8c16", "32c64"])
def test_fine_apply_matches_plain(cuda, dims, storage, flavor):
    """DeviceFineLevel.apply (xpay with the kappa scale, psi0 and out the
    parity views of an MG field) against the plain version on contiguous
    copies of the same parities, at the MG cell's kappa and mu."""
    dt, _, tol = STORAGE[storage]
    kappa, mu = 0.157, 0.0009
    lat, u64, psi, psi0 = _problem(dims, cuda)
    level = DeviceFineLevel(lat, u64.float(), kappa, mu, flavor)
    level = {"f64": level.as_hp(), "f32": level, "bf16": level.sloppy()}[storage]
    u = level.u_pk if level.u12 is None else level.u12
    assert u.dtype == dt
    v = torch.stack([psi, psi0], dim=1).to(dt)       # [2(ri), 2(par), 4, 3, T, Z, S]
    key = str(dt).removeprefix("torch.")
    before = dslash_cuda.counts[key]
    k = level.apply(v).double()
    assert dslash_cuda.counts[key] == before + 2
    p = torch.stack([dslash_eo_plain(u, v[:, 1 - par].contiguous(), 1 - par, lat,
                                     epilogue="xpay", kappa=kappa, mu=mu, flavor=flavor,
                                     psi0=v[:, par].contiguous(), xpay_scale=kappa).double()
                     for par in (0, 1)], dim=1)
    torch.cuda.synchronize()
    assert torch.isfinite(k).all()
    assert ((k - p).abs().max() / p.abs().max()).item() <= tol


def test_apply_hop_all_matches_hop_full_per_leg(cuda):
    """The fused probing pass (one legs_out launch per parity) against
    the per-leg dirs launches of _hop_full, on a fine MG field."""
    lat, u64, _, _ = _problem((8, 8, 8, 16), cuda)
    level = DeviceFineLevel(lat, u64.float(), KAPPA, MU)
    v = level.random_field(torch.Generator(device=cuda).manual_seed(5))
    dslash_cuda.reset_counts()
    legs = level.apply_hop_all(v)
    assert dslash_cuda.counts == {"float32:legs_out": 2}
    for i, (mu, sign) in enumerate(LEG_ORDER):
        want = _hop_full(level, v, mu, sign)
        assert ((legs[i] - want).abs().max() / want.abs().max()).item() <= 1e-6
    assert dslash_cuda.counts["float32:dirs"] == 16 and dslash_cuda.counts["plain"] == 0


def _clover(u64, lat, epilogue, out_parity):
    """A from the gauge at csw 1.2 (clover_xpay) or its twisted inverse
    (clover_inv), packed float64, at the output parity."""
    a_pk = clover_pk_from_gauge(u64, lat, kappa=KAPPA, csw=CSW)
    if epilogue == "clover_xpay":
        return a_pk[out_parity].double()
    inv = clover_twist_inverse(torch.complex(a_pk[:, 0], a_pk[:, 1]), KAPPA, MU, 1, out_parity)
    return pack_clover(inv, torch.float64)


@pytest.mark.parametrize("mode", sorted(CLOVER_MODES))
@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("dims", [(8, 8, 8, 16), (32, 32, 32, 64)], ids=["8c16", "32c64"])
def test_clover_epilogues_match_plain(cuda, dims, storage, mode):
    dt, rows, tol = STORAGE[storage]
    epi, scale = CLOVER_MODES[mode]
    lat, u64, psi, psi0 = _problem(dims, cuda)
    u = (u64 if rows == 3 else u64[:, :, :2]).to(dt).contiguous()
    psi, psi0 = psi.to(dt), psi0.to(dt)
    key = str(dt).removeprefix("torch.") + ":" + epi
    for parity in (0, 1):
        cl = _clover(u64, lat, epi, 1 - parity).to(dt).contiguous()
        for dagger in (False, True):
            kw = dict(dagger=dagger, epilogue=epi, kappa=KAPPA, mu=MU, xpay_scale=scale,
                      clover=cl, psi0=psi0 if epi == "clover_xpay" else None)
            before = dslash_cuda.counts[key]
            k = dslash_eo(u, psi, parity, lat, **kw).double()
            assert dslash_cuda.counts[key] == before + 1
            p = dslash_eo_plain(u, psi, parity, lat, **kw).double()
            torch.cuda.synchronize()
            assert torch.isfinite(k).all()
            rel = ((k - p).abs().max() / p.abs().max()).item()
            assert rel <= tol, (parity, dagger, rel)


def test_wrapper_refuses_a_strided_clover_operand(cuda):
    lat, u, psi, _ = _problem((4, 4, 4, 4), cuda)
    cl = torch.zeros((2, 2, 2, 6, 6, *lat.site_shape), device=cuda)
    with pytest.raises(ValueError, match="clover is not contiguous"):
        dslash_eo(u.float()[:, :, :2].contiguous(), psi.float(), 0, lat,
                  epilogue="clover_inv", clover=cl[:, 0])


@pytest.mark.parametrize("flavor", [+1, -1])
@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("dims", [(8, 8, 8, 16), (32, 32, 32, 64)], ids=["8c16", "32c64"])
def test_fine_clover_apply_matches_plain(cuda, dims, storage, flavor):
    """DeviceFineCloverLevel.apply (clover_xpay with the kappa scale, psi0
    and out the parity views of an MG field) against the plain version on
    contiguous copies of the same parities, at the clover MG cell's
    action (csw 1.769, kappa 0.1352, mu 0.0009)."""
    dt, _, tol = STORAGE[storage]
    kappa, mu, csw = 0.1352, 0.0009, 1.769
    lat, u64, psi, psi0 = _problem(dims, cuda)
    a_pk = clover_pk_from_gauge(u64, lat, kappa=kappa, csw=csw)
    level = DeviceFineCloverLevel(lat, u64.float(), a_pk, kappa, mu, flavor=flavor)
    level = {"f64": level.as_hp(), "f32": level, "bf16": level.sloppy()}[storage]
    u = level.u_pk if level.u12 is None else level.u12
    assert u.dtype == level.clover_pk.dtype == dt
    v = torch.stack([psi, psi0], dim=1).to(dt)
    key = str(dt).removeprefix("torch.") + ":clover_xpay"
    before = dslash_cuda.counts[key]
    k = level.apply(v).double()
    assert dslash_cuda.counts[key] == before + 2
    p = torch.stack([dslash_eo_plain(u, v[:, 1 - par].contiguous(), 1 - par, lat,
                                     epilogue="clover_xpay", kappa=kappa, mu=mu, flavor=flavor,
                                     psi0=v[:, par].contiguous(), xpay_scale=kappa,
                                     clover=level.clover_pk[par]).double()
                     for par in (0, 1)], dim=1)
    torch.cuda.synchronize()
    assert torch.isfinite(k).all()
    assert ((k - p).abs().max() / p.abs().max()).item() <= tol


@pytest.mark.parametrize("mg", [False, True], ids=["direct", "mg"])
def test_run_invert_clover_goes_through_the_kernel(cuda, mg):
    raw = {"gauge": {"dims": [8, 8, 8, 16], "random_seed": 1},
           "action": {"kappa": KAPPA, "mu": 0.06, "csw": CSW},
           "solver": {"solver": "bicgstab", "sloppy_dtype": "bfloat16", "inner_tol": 1e-4}}
    if mg:
        raw["mg"] = {"enabled": True, "n_vec": [8], "block": [[4, 4, 4, 4]],
                     "setup_iters": 40, "smoother_dtype": "bfloat16"}
    dslash_cuda.reset_counts()
    res = invert(config_from_dict(raw), cuda)
    assert res.relres <= 1e-10 and dslash_cuda.counts["plain"] == 0
    want = (("float32:clover_xpay", "bfloat16:clover_xpay", "float32:legs_out") if mg
            else ("bfloat16:clover_inv", "bfloat16:clover_xpay", "float64:clover_inv"))
    for key in want + ("float64:clover_xpay",):
        assert dslash_cuda.counts[key] > 0, key


#: halo mode also in float32 with 18-real links
HALO_STORAGE = {**STORAGE, "f32_18": (torch.float32, 3, 1e-5)}


@pytest.mark.parametrize("half", [True, False], ids=["half", "full"])
@pytest.mark.parametrize("mode", ["none", "twist_inv", "xpay", "clover_inv"])
@pytest.mark.parametrize("storage", sorted(HALO_STORAGE))
@pytest.mark.parametrize("dims", [(8, 8, 8, 16), (32, 32, 32, 64)], ids=["8c16", "32c64"])
def test_halo_mode_matches_plain_and_unsharded(cuda, dims, storage, mode, half):
    """Each shard of a (2, 2) grid (faces cut from the global fields, its
    own t_offset) against the plain version on the same operands, and the
    stitched shards against the unsharded kernel; both parities, dagger
    off and on."""
    dt, rows, tol = HALO_STORAGE[storage]
    lat, u64, psi, psi0 = _problem(dims, cuda)
    u = (u64 if rows == 3 else u64[:, :, :2]).to(dt).contiguous()
    psi, psi0 = psi.to(dt), psi0.to(dt)
    key = str(dt).removeprefix("torch.") + (":clover_inv" if mode == "clover_inv" else "") + ":halo"
    for parity in (0, 1):
        extra = {"psi0": psi0} if mode == "xpay" else {}
        if mode == "clover_inv":
            extra = {"clover": _clover(u64, lat, mode, 1 - parity).to(dt).contiguous()}
        for dagger in (False, True):
            kw = dict(dagger=dagger, epilogue=mode, kappa=KAPPA, mu=MU)
            whole = dslash_eo(u, psi, parity, lat, **kw, **extra).double()
            for r in range(4):
                m = LatticeMesh(lat, 2, 2, 1, r)
                ul, pl, halo = cut_halo(m, u, psi, parity, dagger, half)
                loc = {k: m.shard(v).contiguous() for k, v in extra.items()}
                before = dslash_cuda.counts[key]
                k = dslash_eo(ul, pl, parity, m.local_lat, halo=halo, **kw, **loc).double()
                assert dslash_cuda.counts[key] == before + 1
                p = dslash_eo_plain(ul, pl, parity, m.local_lat, halo=halo, **kw, **loc).double()
                torch.cuda.synchronize()
                assert torch.isfinite(k).all()
                assert ((k - p).abs().max() / p.abs().max()).item() <= tol, (parity, dagger, r)
                ref = m.shard(whole)
                assert ((k - ref).abs().max() / ref.abs().max()).item() <= tol, (parity, dagger, r)


def test_run_invert_ndeg_and_one_rank_mesh_go_through_the_kernel(cuda):
    """The doublet solve: run_invert on one card launches K1 none (float32
    reconstruct-12 and float64), and solve_ndeg_tm_sharded on a one-rank
    mesh (faces its own boundary slices) launches K6, to the same x."""
    cfg = config_from_dict({"gauge": {"dims": [8, 8, 8, 16], "random_seed": 1},
                            "action": {"kappa": 0.115, "mubar": 0.135, "epsbar": 0.17}})
    dslash_cuda.reset_counts()
    res = invert(cfg, cuda)
    assert res.relres <= 1e-10 and res.x.shape == (2, *res.b_pk.shape[1:])
    assert dslash_cuda.counts["float32"] > 0 and dslash_cuda.counts["float64"] > 0
    assert dslash_cuda.counts["plain"] == 0
    lat = Lattice((8, 8, 8, 16))
    lmesh = LatticeMesh.make(lat, 1)
    op = ShardedNdegTMOperatorPC(lat, kappa=0.115, mubar=0.135, epsbar=0.17, lmesh=lmesh)
    ug = op.extend_gauge(res.u_pk)
    dslash_cuda.reset_counts()
    sh = solve_ndeg_tm_sharded(op, ug.to(torch.float32, rows=2), ug.to(torch.float64),
                               res.b_pk)
    assert sh.relres <= 1e-10
    assert dslash_cuda.counts["float32:halo"] > 0 and dslash_cuda.counts["float64:halo"] > 0
    assert dslash_cuda.counts["plain"] == 0 and dslash_cuda.counts["float32"] == 0
    assert ((sh.x - res.x).abs().max() / res.x.abs().max()).item() <= 1e-8


# --- the bfloat16 pair kernel ------------------------------------------------

PAIR_MODES = {**MODES, "clover_inv": ("clover_inv", None), "clover_xpay": ("clover_xpay", None)}


@pytest.mark.parametrize("mode", sorted(PAIR_MODES))
@pytest.mark.parametrize("dims", [(8, 8, 8, 16), (32, 32, 32, 64)], ids=["8c16", "32c64"])
def test_pair_kernel_equals_the_one_site_kernel(cuda, dims, mode):
    """A bfloat16 launch that pair_sites admits takes the pair kernel (two
    sites a thread) and counts under the mode's key; it equals the one-site
    kernel on the same operands bit for bit: whole, both parities, dagger
    off and on, in halo mode on every shard of a (2, 2) grid and on the
    one-rank mesh with half-spinor and full faces, and into the parity
    views of an MG field."""
    epi, scale = PAIR_MODES[mode]
    lat, u64, psi64, psi064 = _problem(dims, cuda)
    u = u64[:, :, :2].bfloat16().contiguous()
    psi, psi0 = psi64.bfloat16(), psi064.bfloat16()
    field = torch.stack([psi, psi0], dim=1)
    key = "bfloat16" + (":" + epi if epi.startswith("clover") else "")
    meshes = [LatticeMesh(lat, 1, 1, 1, 0)] + [LatticeMesh(lat, 2, 2, 1, r) for r in range(4)]
    for parity in (0, 1):
        extra = {"psi0": psi0} if epi == "xpay" else {}
        if epi.startswith("clover"):
            extra = {"clover": _clover(u64, lat, epi, 1 - parity).bfloat16().contiguous()}
            if epi == "clover_xpay":
                extra["psi0"] = psi0
        for dagger in (False, True):
            kw = dict(dagger=dagger, epilogue=epi, kappa=KAPPA, mu=MU, xpay_scale=scale)
            dslash_cuda.reset_counts()
            k = dslash_eo(u, psi, parity, lat, **kw, **extra)
            o = dslash_cuda.dslash_eo_one_site(u, psi, parity, lat, **kw, **extra)
            assert dict(dslash_cuda.counts) == {key: 1, key + ":one_site": 1}
            torch.cuda.synchronize()
            assert torch.isfinite(k.float()).all() and torch.equal(k, o), (parity, dagger)
            a, b = torch.empty_like(field), torch.empty_like(field)
            views = dict(extra, psi0=field[:, parity]) if "psi0" in extra else extra
            dslash_eo(u, field[:, 1 - parity], 1 - parity, lat, out=a[:, parity], **kw, **views)
            dslash_cuda.dslash_eo_one_site(u, field[:, 1 - parity], 1 - parity, lat,
                                           out=b[:, parity], **kw, **views)
            torch.cuda.synchronize()
            assert torch.equal(a[:, parity], b[:, parity]), ("views", parity, dagger)
            for m in meshes:
                for half in (True, False):
                    ul, pl, halo = cut_halo(m, u, psi, parity, dagger, half)
                    loc = {k_: m.shard(v).contiguous() for k_, v in extra.items()}
                    dslash_cuda.reset_counts()
                    k = dslash_eo(ul, pl, parity, m.local_lat, halo=halo, **kw, **loc)
                    o = dslash_cuda.dslash_eo_one_site(ul, pl, parity, m.local_lat, halo=halo,
                                                       **kw, **loc)
                    assert dict(dslash_cuda.counts) == {key + ":halo": 1,
                                                        key + ":halo:one_site": 1}
                    torch.cuda.synchronize()
                    assert torch.equal(k, o), (parity, dagger, m.nt, m.rank, half)


def test_xh_odd_takes_the_one_site_kernel(cuda):
    """Lx = 10 (Xh = 5): pair_sites refuses, the one-site kernel runs,
    counts under bfloat16:one_site and matches the plain version (1e-2)."""
    lat, u64, psi, psi0 = _problem((10, 4, 4, 8), cuda)
    u = u64[:, :, :2].bfloat16().contiguous()
    psi, psi0 = psi.bfloat16(), psi0.bfloat16()
    for parity in (0, 1):
        kw = dict(epilogue="xpay", kappa=KAPPA, mu=MU, psi0=psi0)
        dslash_cuda.reset_counts()
        k = dslash_eo(u, psi, parity, lat, **kw).double()
        assert dict(dslash_cuda.counts) == {"bfloat16:one_site": 1}
        p = dslash_eo_plain(u, psi, parity, lat, **kw).double()
        torch.cuda.synchronize()
        assert ((k - p).abs().max() / p.abs().max()).item() <= 1e-2


# --- the batch axis, reconstruct-8, compute="bf16" ----------------------------

@pytest.mark.parametrize("mode", sorted(MODES) + ["clover_inv", "clover_xpay"])
@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("n_rhs", [1, 3, 5, 12])
def test_batched_launch_equals_single_launches_and_plain(cuda, n_rhs, storage, mode):
    """psi, psi0 and out are parity views of a batched MG field
    [N, 2(ri), 2(par), ...]; N = 5 leaves the batched kernel's last
    column warp one column short (batch_geometry)."""
    dt, rows, tol = STORAGE[storage]
    epi, scale = {**MODES, **CLOVER_MODES}[mode]
    lat, u64, _, _ = _problem((8, 8, 8, 16), cuda)
    u = (u64 if rows == 3 else u64[:, :, :2]).to(dt).contiguous()
    gen = torch.Generator().manual_seed(1)
    field = torch.randn((n_rhs, 2, 2, 4, 3, *lat.site_shape), generator=gen,
                        dtype=torch.float64).to(cuda).to(dt)
    field0 = field.flip(0).roll(1, 2)
    a_pk = clover_pk_from_gauge(u64, lat, kappa=KAPPA, csw=CSW)
    for parity in (0, 1):
        cl = None
        if epi == "clover_xpay":
            cl = a_pk[1 - parity].to(dt).contiguous()
        elif epi == "clover_inv":
            a = torch.complex(a_pk[:, 0], a_pk[:, 1])
            cl = pack_clover(clover_twist_inverse(a, KAPPA, MU, 1, 1 - parity), dt)
        psi, psi0 = field[:, :, parity], field0[:, :, 1 - parity]
        for dagger in (False, True):
            kw = dict(dagger=dagger, epilogue=epi, kappa=KAPPA, mu=MU, xpay_scale=scale,
                      clover=cl)
            p0 = psi0 if epi.endswith("xpay") else None
            out = torch.zeros_like(field)
            dslash_cuda.reset_counts()
            k = dslash_eo(u, psi, parity, lat, psi0=p0, out=out[:, :, 1 - parity], **kw)
            assert sum(dslash_cuda.counts.values()) == 1
            assert next(iter(dslash_cuda.counts)).endswith(":batch")
            singles = torch.stack([dslash_eo(u, psi[i], parity, lat,
                                             psi0=None if p0 is None else p0[i], **kw)
                                   for i in range(n_rhs)])
            assert torch.equal(k, singles)
            assert out[:, :, parity].abs().max().item() == 0.0
            p = dslash_eo_plain(u, psi, parity, lat, psi0=p0, **kw).double()
            assert (k.double() - p).abs().max().item() <= tol * p.abs().max().item()


@pytest.mark.parametrize("parity", [0, 1])
def test_batched_xpay_at_full_size_equals_single_launches(cuda, parity):
    """Cell 4h's sloppy launch at 32^3x64: f32 reconstruct-12 xpay on 11
    columns (the batch gate's probe column solved first), bit for bit
    against single launches."""
    lat, u64, _, _ = _problem((32, 32, 32, 64), cuda)
    u = u64[:, :, :2].float().contiguous()
    gen = torch.Generator().manual_seed(3)
    psi, psi0 = (torch.randn((11, 2, 4, 3, *lat.site_shape), generator=gen).to(cuda)
                 for _ in range(2))
    kw = dict(epilogue="xpay", kappa=KAPPA, mu=MU)
    k = dslash_eo(u, psi, parity, lat, psi0=psi0, **kw)
    for i in range(11):
        assert torch.equal(k[i], dslash_eo(u, psi[i], parity, lat, psi0=psi0[i], **kw)), i


@pytest.mark.parametrize("t_boundary", [-1, 1])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("storage", sorted(STORAGE))
@pytest.mark.parametrize("dims", [(8, 8, 8, 16), (32, 32, 32, 64)], ids=["8c16", "32c64"])
def test_reconstruct8_matches_plain_and_the_18_real_kernel(cuda, dims, storage, mode,
                                                           t_boundary):
    from tpuqcd_torch.utils.packed import pack_gauge, pack_gauge8, unpack_gauge8
    dt = STORAGE[storage][0]
    tol, tol18 = {"f64": (1e-12, 1e-12), "f32": (1e-5, 1e-5), "bf16": (1e-2, 2e-2)}[storage]
    epi, scale = MODES[mode]
    lat = Lattice(dims)
    gen = torch.Generator().manual_seed(2)
    u_full = su3.random_gauge(lat, gen, cuda, torch.complex128)
    u64 = gauge_from_full(u_full, lat, t_boundary == -1, torch.float64, cuda)
    u8 = pack_gauge8(torch.complex(u64[:, :, :, :, 0], u64[:, :, :, :, 1]), dt)
    assert tuple(u8.shape) == (4, 2, 4, 1, 2, *lat.site_shape)
    u18 = unpack_gauge8(u8)
    if t_boundary == -1:
        u18[3, :, 2, :, lat.Lt - 1] *= -1
    u18 = pack_gauge(u18, dt).contiguous()
    shape = (2, 2, 4, 3, *lat.site_shape)
    psi = torch.randn(shape, generator=gen, dtype=torch.float64).to(cuda).to(dt)
    psi0 = torch.randn(shape, generator=gen, dtype=torch.float64).to(cuda).to(dt)
    for parity in (0, 1):
        for dagger in (False, True):
            kw = dict(dagger=dagger, epilogue=epi, kappa=KAPPA, mu=MU, xpay_scale=scale,
                      t_boundary=t_boundary, psi0=psi0 if epi == "xpay" else None)
            dslash_cuda.reset_counts()
            k = dslash_eo(u8, psi, parity, lat, **kw).double()
            assert list(dslash_cuda.counts) == [f"{str(dt).removeprefix('torch.')}:recon8:batch"]
            p = dslash_eo_plain(u8, psi, parity, lat, **kw).double()
            k18 = dslash_eo(u18, psi, parity, lat, **kw).double()
            assert torch.isfinite(k).all()
            assert (k - p).abs().max().item() <= tol * p.abs().max().item()
            assert (k - k18).abs().max().item() <= tol18 * k18.abs().max().item()
    # halo mode on an emulated (2, 2) decomposition, the phase by each t_offset
    for parity in (0, 1) if mode == "none" else ():
        whole = dslash_eo(u8, psi[0], parity, lat, t_boundary=t_boundary)
        for rank in range(4):
            m = LatticeMesh(lat, 2, 2, 1, rank)
            ul, pl, halo = cut_halo(m, u8, psi[0], parity)
            k = dslash_eo(ul, pl, parity, m.local_lat, halo=halo, t_boundary=t_boundary)
            p = dslash_eo_plain(ul, pl, parity, m.local_lat, halo=halo,
                                t_boundary=t_boundary).double()
            assert torch.equal(k, m.shard(whole))
            assert (k.double() - p).abs().max().item() <= tol * p.abs().max().item()


@pytest.mark.parametrize("mode", ["none", "twist_inv", "xpay", "clover_inv", "clover_xpay"])
@pytest.mark.parametrize("dims", [(8, 8, 8, 16), (32, 32, 32, 64)], ids=["8c16", "32c64"])
def test_compute_bf16_matches_plain_and_float32_arithmetic(cuda, dims, mode):
    epi, _ = {**MODES, **CLOVER_MODES}[mode]
    lat, u64, psi, psi0 = _problem(dims, cuda)
    u = u64[:, :, :2].bfloat16().contiguous()
    psi, psi0 = psi.bfloat16(), psi0.bfloat16()
    a_pk = clover_pk_from_gauge(u64, lat, kappa=KAPPA, csw=CSW)
    for parity in (0, 1):
        cl = None
        if epi == "clover_xpay":
            cl = a_pk[1 - parity].bfloat16().contiguous()
        elif epi == "clover_inv":
            a = torch.complex(a_pk[:, 0], a_pk[:, 1])
            cl = pack_clover(clover_twist_inverse(a, KAPPA, MU, 1, 1 - parity), torch.bfloat16)
        for dagger in (False, True):
            kw = dict(dagger=dagger, epilogue=epi, kappa=KAPPA, mu=MU, clover=cl,
                      psi0=psi0 if epi.endswith("xpay") else None)
            dslash_cuda.reset_counts()
            k = dslash_eo(u, psi, parity, lat, compute="bf16", **kw).double()
            assert any(key.startswith("bfloat16:compute_bf16") for key in dslash_cuda.counts)
            p = dslash_eo_plain(u, psi, parity, lat, compute="bf16", **kw).double()
            f = dslash_eo(u, psi, parity, lat, **kw).double()
            assert torch.isfinite(k).all()
            for ref in (p, f):
                assert (k - ref).abs().max().item() <= 0.05 * ref.abs().max().item()
    with pytest.raises(ValueError, match="bfloat16"):
        dslash_eo(u.float(), psi.float(), 0, lat, compute="bf16")


def test_run_twop_goes_through_the_batched_kernel(cuda):
    """run_twop.measure at 8^3x16 on the card: batched float32 and float64
    launches, no plain call, every column certified."""
    from tpuqcd_torch.cli import run_twop
    cfg = config_from_dict({
        "gauge": {"dims": [8, 8, 8, 16], "random_seed": 2},
        "action": {"kappa": KAPPA, "mu": MU}, "solver": {"tol": 1e-10},
        "physics": {"momenta": [[0, 0, 0], [1, 0, 0]], "smear_n_ape": 2, "smear_n_gauss": 4,
                    "smear_alpha_gauss": 1.0}})
    dslash_cuda.reset_counts()
    res = run_twop.measure(cfg, cuda)
    counts = dict(dslash_cuda.counts)
    assert counts.get("plain", 0) == 0
    assert counts["float32:batch"] > 0 and counts["float64:batch"] > 0
    assert sum(r["columns"] for r in res.solves) == 24
    assert all(max(r["relres"]) <= 1e-10 for r in res.solves)
    pion = res.correlators["twop/pion/sx0sy0sz0st0"][0]
    assert pion.real.min() > 0 and abs(pion.imag).max() <= 1e-6 * pion.real.max()


def test_run_threeptwop_on_the_card_matches_the_cpu(cuda):
    """run_threeptwop.measure at 4^3x8 on the card against the same run on
    the CPU (the kernel's plain version): batched float32 and float64
    launches, no plain call, all 24 + 96 columns certified, every
    correlator within 1e-5 of its largest value (float32 propagators,
    solves certified to 1e-10 on both)."""
    import numpy as np
    from tpuqcd_torch.cli import run_threeptwop
    from tpuqcd_torch.cli.common import Gauge, setup_gauge
    cfg = config_from_dict({
        "gauge": {"dims": [4, 4, 4, 8], "random_seed": 2},
        "action": {"kappa": KAPPA, "mu": MU}, "solver": {"tol": 1e-10},
        "physics": {"momenta": [[0, 0, 0], [1, 0, 0]], "t_sinks": [3], "sink_momentum": [0, 0, 1],
                    "source_positions": [[1, 0, 1, 2]], "projectors": ["P+", "P5z"],
                    "baryons": ["proton", "neutron"], "smear_n_ape": 2, "smear_n_gauss": 4,
                    "smear_alpha_gauss": 1.0}})
    g = setup_gauge(cfg, torch.device("cpu"))
    host = run_threeptwop.measure(cfg, torch.device("cpu"), g)
    dslash_cuda.reset_counts()
    res = run_threeptwop.measure(cfg, cuda, Gauge(g.lat, g.u_pk.to(cuda), g.plaquette, 0.0))
    counts = dict(dslash_cuda.counts)
    assert counts.get("plain", 0) == 0
    for key in ("float32:batch", "float64:batch", "float32", "float64"):
        assert counts.get(key, 0) > 0, key
    assert sum(r["columns"] for r in res.solves) == 24 + 96
    assert all(max(r["relres"]) <= 1e-10 for r in res.solves)
    pairs = [(k, v, host.twop[k]) for k, v in res.twop.items()]
    pairs += [(f"{k}/{name}", v, host.threep[k][name])
              for k, ins in res.threep.items() for name, v in ins.items()]
    assert len(pairs) == 4 + 8 * 32
    for name, got, want in pairs:
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), name


@pytest.mark.parametrize("buffers", ["float32", "bfloat16"])
def test_batch_bytes_covers_what_the_lockstep_solve_allocates(cuda, buffers):
    """DeviceMG.batch_bytes(N), taken before the call, at or above how far
    solve_certified_batch's allocation grows (max_memory_allocated past
    its start) at N = 1, 2 and 4 columns, at 8^3x16 with the float32 and the
    bfloat16 solver buffers and the float64 operator built inside the call;
    every column certified."""
    import dataclasses
    cfg = config_from_dict({"gauge": {"dims": [8, 8, 8, 16], "random_seed": 1},
                            "action": {"kappa": KAPPA, "mu": MU},
                            "mg": {"enabled": True, "n_vec": [8], "block": [[4, 4, 4, 4]],
                                   "setup_iters": 20, "smoother_dtype": "bfloat16"}})
    mg = invert(cfg, cuda).mg
    if buffers == "bfloat16":
        mg = mg.rebuilt(dataclasses.replace(mg.params, gcr_dtype="bfloat16",
                                            vec_dtype="bfloat16"))
    gen = torch.Generator(device=cuda).manual_seed(3)
    for n in (1, 2, 4):
        b = torch.randn((n, 2, 2, 4, 3, *mg.levels[0].lat.site_shape), generator=gen,
                        device=cuda)
        mg._hp = None
        need = mg.batch_bytes(n)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = mg.solve_certified_batch(b, tol=1e-10, inner_tol=1e-6)
        torch.cuda.synchronize()
        growth = torch.cuda.max_memory_allocated() - base
        assert max(res.relres) <= 1e-10
        assert growth <= need, (n, growth, need, mg.batch_buffers(n))
