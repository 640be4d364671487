"""Compulsory bytes of the Wilson hop, and the card's peaks.

A call of the even-odd hop (the port's ``ops/dslash_cuda.dslash_eo``, whose
operand shapes the harness records) reads each input once and writes each
output once, per output site (half the volume):

    spinor in      N * 24 reals                 (N columns of a batch)
    spinor out     N * 24 reals, or n_legs * 24 with legs_out
    psi0           N * 24 reals                 (xpay and clover_xpay epilogues)
    links          n_legs * R reals             (R = 18, 12 or 8 a link; every
                                                 leg reads one link a site, so
                                                 all 8 legs read each link of
                                                 the lattice once)
    clover block   144 reals                    (clover epilogues)
    halo faces     the bytes of the face tensors

times the storage width.  This reproduces the per-site bytes of the port's
performance notes: 576 B (f32 reconstruct-12, no epilogue), 672 B (xpay),
768 B (18-real), 1536 / 1728 B (f64), 1152 / 1248 B (f32 clover), and for a
batch of N, 288 + 384/N B a column (f32 xpay).  The numerator of a roofline
share counts these bytes whatever kernel does the work.
"""
from __future__ import annotations

#: card name (torch.cuda.get_device_name) -> (HBM bytes/s, float32 FLOP/s,
#: float64 FLOP/s): NVIDIA's H100 SXM data sheet, at 700 W
PEAKS = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12, 34e12)}

_WIDTH = {"torch.float32": 4, "torch.float64": 8, "torch.bfloat16": 2, "torch.float16": 2}
_LINK_REALS = {3: 18, 2: 12, 4: 8}


def call_key(u, psi, kw: dict) -> tuple:
    """What the byte count of one hop call depends on, from its operands."""
    legs = len(kw["dirs"]) if kw.get("dirs") else 8
    halo = kw.get("halo")
    halo_bytes = 0
    if halo is not None:
        for f in ("t_m", "t_p", "z_m", "z_p", "u_t", "u_z"):
            t = getattr(halo, f)
            halo_bytes += t.numel() * t.element_size()
    epi = kw.get("epilogue", "none")
    return (tuple(psi.shape), str(psi.dtype), int(u.shape[2]), legs, bool(kw.get("legs_out")),
            epi in ("xpay", "clover_xpay"), epi in ("clover_inv", "clover_xpay"), halo_bytes)


def call_bytes(key: tuple) -> int:
    shape, dtype, rows, legs, legs_out, psi0, clover, halo_bytes = key
    batch = shape[0] if len(shape) == 7 else 1
    sites = shape[-3] * shape[-2] * shape[-1]
    spin = 24 * batch
    reals = spin + (legs * 24 if legs_out else spin) + (spin if psi0 else 0)
    reals += legs * _LINK_REALS[rows] + (144 if clover else 0)
    return reals * sites * _WIDTH[dtype] + halo_bytes


def site_bytes(key: tuple) -> float:
    """Bytes a column and output site (for checks against the notes)."""
    shape = key[0]
    batch = shape[0] if len(shape) == 7 else 1
    return call_bytes(key) / (shape[-3] * shape[-2] * shape[-1]) / batch
