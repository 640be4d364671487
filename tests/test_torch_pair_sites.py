"""The dispatch between the Dslash kernel's pair and one-site forms
(ops/dslash_cuda.pair_sites), which the CUDA launch checks again: a single
bfloat16 launch takes the pair kernel (two output sites a thread, every
operand pair one 4-byte access) when Xh = Lx/2 is even, its links are
reconstruct-12, every operand pointer is 4-byte aligned and every re/im
plane stride is even; anything else runs the one-site kernel and counts
under a last ":one_site".  f32, f64, batches of more than one field and
legs_out keep their kernels and keys; a batch of one takes the pair
kernel (and keeps its ":batch" key).  Cases: Xh even and odd; psi, psi0,
out, clover, a face and the gauge one element off alignment; an odd
plane stride; the parity views of an MG field; 18-real and
reconstruct-8 links; compute="bf16"; batches of three and of one; each
operand checked as the wrapper checks it.  Shapes and pointers only:
no card, no tpuqcd."""
import pytest
import torch

from tpuqcd_torch.lattice import Lattice
from tpuqcd_torch.ops import dslash_cuda
from tpuqcd_torch.ops.dslash_cuda import Halo, pair_sites

BF16 = torch.bfloat16


def _off(x: torch.Tensor) -> torch.Tensor:
    """x's values in a contiguous view one element past an aligned start."""
    buf = torch.zeros(x.numel() + 1, dtype=x.dtype)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def _odd_planes(x: torch.Tensor) -> torch.Tensor:
    """x [2(ri), 4, 3, T, Z, S] with its im plane an odd number of elements
    after its re plane."""
    plane = x[0].numel()
    buf = torch.zeros(2 * plane + 1, dtype=x.dtype)
    view = buf.as_strided(x.shape, (plane + 1, *x[0].stride()))
    view.copy_(x)
    return view


def _halo(lat: Lattice, dtype, rows: int, ns: int = 2, off: str | None = None) -> Halo:
    T, Z, S = lat.site_shape
    shapes = {"t_m": (2, ns, 3, Z, S), "t_p": (2, ns, 3, Z, S), "z_m": (2, ns, 3, T, S),
              "z_p": (2, ns, 3, T, S), "u_t": (rows, 3, 2, Z, S), "u_z": (rows, 3, 2, T, S)}
    faces = {k: torch.zeros(v, dtype=dtype) for k, v in shapes.items()}
    if off is not None:
        faces[off] = _off(faces[off])
    return Halo(**faces, t_offset=0, t_global=lat.Lt)


def _case(name: str):
    """(lattice, dslash_eo's operands and options, whether the pair kernel runs)."""
    lx = 6 if name == "xh_odd" else 8
    lat = Lattice((lx, 4, 4, 4))
    dtype = {"f32": torch.float32, "f64": torch.float64}.get(name, BF16)
    rows = {"links_18": 3, "links_8": 4}.get(name, 2)
    cols = 1 if rows == 4 else 3
    T, Z, S = lat.site_shape
    u = torch.zeros((4, 2, rows, cols, 2, T, Z, S), dtype=dtype)
    spinor = (2, 4, 3, T, Z, S)
    psi, psi0 = torch.zeros(spinor, dtype=dtype), torch.zeros(spinor, dtype=dtype)
    kw = dict(epilogue="xpay", psi0=psi0)
    if name in ("clover", "clover_off"):
        cl = torch.zeros((2, 2, 6, 6, T, Z, S), dtype=dtype)
        kw = dict(epilogue="clover_xpay", psi0=psi0,
                  clover=_off(cl) if name == "clover_off" else cl)
    if name in ("halo_half", "halo_full", "face_off", "face_link_off"):
        off = {"face_off": "z_p", "face_link_off": "u_t"}.get(name)
        kw["halo"] = _halo(lat, dtype, rows, 4 if name == "halo_full" else 2, off)
    if name == "psi_off":
        psi = _off(psi)
    if name == "psi0_off":
        kw["psi0"] = _off(psi0)
    if name == "psi0_off_unread":          # psi0 given to an epilogue that does not read it
        kw = dict(epilogue="twist_inv", psi0=_off(psi0))
    if name == "out_off":
        kw["out"] = _off(torch.zeros(spinor, dtype=dtype))
    if name == "u_off":
        u = _off(u)
    if name == "odd_plane_stride":
        psi = _odd_planes(psi)
    if name in ("mg_views", "mg_views_clover"):
        field = torch.zeros((2, 2, 4, 3, T, Z, S), dtype=dtype)
        out = torch.zeros_like(field)
        psi, kw = field[:, 1], dict(epilogue="xpay", psi0=field[:, 0], out=out[:, 0])
        if name == "mg_views_clover":
            cl = torch.zeros((2, 2, 2, 6, 6, T, Z, S), dtype=dtype)    # both parities' blocks
            kw.update(epilogue="clover_xpay", clover=cl[0])
    if name in ("batch", "batch_of_one", "batch_of_one_odd_planes"):
        psi = torch.zeros((3 if name == "batch" else 1, *spinor), dtype=dtype)
        kw = dict(epilogue="xpay", psi0=torch.zeros_like(psi))
        if name == "batch_of_one_odd_planes":
            kw["psi0"] = _odd_planes(psi0)[None]
    if name == "legs_out":
        kw = dict(legs_out=True)
    if name == "dirs":
        kw = dict(dirs=((3, +1),))
    if name == "compute_bf16":
        kw["compute"] = "bf16"
    pair = name in ("xh_even", "clover", "halo_half", "halo_full", "psi0_off_unread", "mg_views",
                    "mg_views_clover", "dirs", "compute_bf16", "batch_of_one")
    return lat, u, psi, kw, pair


CASES = ["xh_even", "xh_odd", "psi_off", "psi0_off", "psi0_off_unread", "out_off", "clover",
         "clover_off", "halo_half", "halo_full", "face_off", "face_link_off", "u_off",
         "odd_plane_stride", "mg_views", "mg_views_clover", "links_18", "links_8", "f32", "f64",
         "compute_bf16", "batch", "batch_of_one", "batch_of_one_odd_planes", "legs_out", "dirs"]


@pytest.mark.parametrize("name", CASES)
def test_pair_sites_decides_by_shape(name):
    lat, u, psi, kw, want = _case(name)
    epilogue = kw.get("epilogue", "none")
    mask, _, nb = dslash_cuda._check(u, psi, 0, lat, epilogue, kw.get("psi0"), kw.get("dirs"),
                                     kw.get("legs_out", False), kw.get("out"), kw.get("clover"),
                                     kw.get("halo"), kw.get("compute", "f32"))
    reads_psi0 = epilogue in ("xpay", "clover_xpay")
    pair = pair_sites(lat, psi, kw["psi0"] if reads_psi0 else None, kw.get("out"), u,
                      kw.get("clover"), kw.get("halo"), kw.get("legs_out", False))
    assert pair is want
    key = dslash_cuda._count_key(psi, u, kw.get("compute", "f32"), kw.get("dirs"),
                                 kw.get("legs_out", False), kw.get("clover"), epilogue,
                                 kw.get("halo"), nb, pair)
    one_site = psi.dtype == BF16 and not nb and not kw.get("legs_out", False) and not pair
    assert key.endswith(":one_site") is one_site
    # the keys the pair kernel keeps: the one-site key less its suffix
    assert key.removesuffix(":one_site") == dslash_cuda._count_key(
        psi, u, kw.get("compute", "f32"), kw.get("dirs"), kw.get("legs_out", False),
        kw.get("clover"), epilogue, kw.get("halo"), nb, True)
    if name == "compute_bf16":
        assert key == "bfloat16:compute_bf16"
    if name == "mg_views_clover":
        assert key == "bfloat16:clover_xpay"
