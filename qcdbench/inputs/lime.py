"""Frozen copy of the ILDG (LIME) gauge writer, and a plain reader.

Copied at commit c8a988f from ``tpuqcd_torch/io/lime.py`` (write_lime,
scidac_checksum, the two XML records, write_ildg_gauge; the reader's
record loop of read_lime).  An ILDG file is a LIME container of 144-byte
big-endian record headers and 8-byte padded payloads: "ildg-format"
(precision and lx, ly, lz, lt), "ildg-binary-data" (big-endian IEEE
floats, sites x fastest to t slowest, per site the links of x, y, z, t,
each a row-major 3x3 complex matrix) and "scidac-checksum" (the QIO
site-rank CRC32 sums).  The port reads these files through its own input
path; the plain reference reads them with ``read_gauge_f64``.
"""
from __future__ import annotations

import os
import re
import struct
import zlib

import numpy as np
import torch

LIME_MAGIC = 0x456789AB
_HDR = struct.Struct(">LHHQ")


def _pad8(n: int) -> int:
    return (8 - n % 8) % 8


def write_lime(path: str, records) -> None:
    """records: (type, data, msg_begin, msg_end) tuples."""
    with open(path, "wb") as f:
        for lime_type, data, begin, end in records:
            bits = (0x8000 if begin else 0) | (0x4000 if end else 0)
            hdr = _HDR.pack(LIME_MAGIC, 1, bits, len(data))
            tname = lime_type.encode()[:127]
            f.write(hdr + tname + b"\0" * (128 - len(tname)))
            f.write(data)
            f.write(b"\0" * _pad8(len(data)))


def read_lime(path: str) -> dict:
    """{record type: payload bytearray} of a LIME file."""
    recs = {}
    with open(path, "rb") as f:
        while True:
            hdr = f.read(144)
            if len(hdr) < 144:
                break
            magic, _, _, length = _HDR.unpack(hdr[:16])
            if magic != LIME_MAGIC:
                raise ValueError(f"bad LIME magic {magic:#x} in {path}")
            lime_type = hdr[16:144].split(b"\0")[0].decode()
            data = bytearray(length)
            if f.readinto(data) != length:
                raise ValueError(f"{path}: record {lime_type!r} is truncated")
            f.read(_pad8(length))
            recs[lime_type] = data
    return recs


def scidac_checksum(payload, site_bytes: int) -> tuple[int, int]:
    n = len(payload) // site_bytes
    mv, crc32 = memoryview(payload), zlib.crc32
    crcs = np.fromiter((crc32(mv[o:o + site_bytes])
                        for o in range(0, n * site_bytes, site_bytes)), dtype=np.uint64, count=n)
    rank = np.arange(n, dtype=np.uint64)
    full = np.uint64(0xFFFFFFFF)

    def fold(mod):
        s = rank % np.uint64(mod)
        rot = ((crcs << s) | (crcs >> (np.uint64(32) - s))) & full
        return int(np.bitwise_xor.reduce(rot.astype(np.uint32)))
    return fold(29), fold(31)


def _format_xml(dims, precision: int) -> bytes:
    lx, ly, lz, lt = dims
    return (f'<?xml version="1.0" encoding="UTF-8"?>'
            f'<ildgFormat xmlns="http://www.lqcd.org/ildg">'
            f'<version>1.0</version><field>su3gauge</field>'
            f'<precision>{precision}</precision>'
            f'<lx>{lx}</lx><ly>{ly}</ly><lz>{lz}</lz><lt>{lt}</lt>'
            f'</ildgFormat>').encode()


def _checksum_xml(suma: int, sumb: int) -> bytes:
    return (f'<?xml version="1.0" encoding="UTF-8"?>'
            f'<scidacChecksum><version>1.0</version>'
            f'<suma>{suma:08x}</suma><sumb>{sumb:08x}</sumb>'
            f'</scidacChecksum>').encode()


def write_ildg_gauge(path: str, u_full, dims, precision: int = 64) -> None:
    """u_full: [4(mu), T, Z, Y, X, 3, 3] complex (tensor or array) -> ILDG
    file, written under a fixed temporary name beside ``path`` and renamed."""
    if isinstance(u_full, torch.Tensor):
        u_full = u_full.detach().cpu().numpy()
    dt = np.dtype(">f8") if precision == 64 else np.dtype(">f4")
    u = np.transpose(np.asarray(u_full), (1, 2, 3, 4, 0, 5, 6))
    flat = np.empty((*u.shape, 2), dtype=np.float64)
    flat[..., 0] = u.real
    flat[..., 1] = u.imag
    payload = flat.astype(dt).tobytes()
    del flat
    suma, sumb = scidac_checksum(payload, 72 * (precision // 8))
    tmp = f"{path}.partial"
    write_lime(tmp, [("ildg-format", _format_xml(dims, precision), True, False),
                     ("ildg-binary-data", payload, False, False),
                     ("scidac-checksum", _checksum_xml(suma, sumb), False, True)])
    os.replace(tmp, path)


def read_gauge_f64(path: str, device=None) -> tuple[torch.Tensor, tuple]:
    """(links complex128 [4, T, Z, Y, X, 3, 3] on ``device``, dims) of an
    ILDG file, its SciDAC checksum verified; no boundary phase."""
    recs = read_lime(path)
    txt = bytes(recs["ildg-format"]).decode(errors="ignore")

    def grab(tag):
        return int(re.search(f"<{tag}>(.*?)</{tag}>", txt).group(1))
    precision = grab("precision")
    dims = (grab("lx"), grab("ly"), grab("lz"), grab("lt"))
    data = recs["ildg-binary-data"]
    csum = bytes(recs.get("scidac-checksum", b"")).decode(errors="ignore")
    want = tuple(int(re.search(f"<{t}>([0-9a-fA-F]+)</{t}>", csum).group(1), 16)
                 for t in ("suma", "sumb"))
    if scidac_checksum(data, 72 * (precision // 8)) != want:
        raise ValueError(f"{path}: SciDAC checksum mismatch")
    arr = np.frombuffer(data, dtype=np.dtype(">f8") if precision == 64 else np.dtype(">f4"))
    lx, ly, lz, lt = dims
    t = torch.from_numpy(arr.astype(np.float64)).to(device).reshape(lt, lz, ly, lx, 4, 3, 3, 2)
    u = torch.complex(t[..., 0], t[..., 1]).movedim(4, 0).contiguous()
    return u, dims
