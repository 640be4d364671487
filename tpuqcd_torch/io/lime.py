"""LIME / ILDG gauge configuration I/O (host code: numpy, struct, zlib).

Counterpart of ``tpuqcd/io/lime.py``, whose files it reads and writes
byte for byte.  An ILDG file is a LIME container of 144-byte big-endian
record headers (magic 0x456789ab, version, message begin/end bits, data
length, a 128-byte type name) and payloads padded to 8 bytes, with three
records: "ildg-format" (XML: precision and lx, ly, lz, lt),
"ildg-binary-data" (big-endian IEEE floats, sites x fastest to t slowest,
per site the links of x, y, z, t, each a row-major 3x3 complex matrix)
and "scidac-checksum" (the QIO site-rank CRC32 sums, XML).

``read_ildg_payload`` reads a file and verifies its checksum without
decoding the payload (the background read-ahead of io/prefetch.py does
just that); ``io/native.ildg_payload_to_device`` decodes a payload on the
run's device.  ``read_ildg_gauge`` is the decode on the host, as tpuqcd
has it, the full-layout complex64 gauge [4, T, Z, Y, X, 3, 3].
"""
from __future__ import annotations

import re
import struct
import time
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

from ..lattice import Lattice

LIME_MAGIC = 0x456789AB
_HDR = struct.Struct(">LHHQ")  # magic, version, bits, data-length


@dataclass
class LimeRecord:
    lime_type: str
    data: bytes
    msg_begin: bool = True
    msg_end: bool = True


def _pad8(n: int) -> int:
    return (8 - n % 8) % 8


def read_lime(path: str) -> list[LimeRecord]:
    """Every record of a LIME file; payloads are bytearrays (writable, so
    that torch.frombuffer takes them without a copy)."""
    recs = []
    with open(path, "rb") as f:
        while True:
            hdr = f.read(144)
            if len(hdr) < 144:
                break
            magic, version, bits, length = _HDR.unpack(hdr[:16])
            if magic != LIME_MAGIC:
                raise ValueError(f"bad LIME magic {magic:#x} in {path}")
            lime_type = hdr[16:144].split(b"\0")[0].decode()
            data = bytearray(length)
            if f.readinto(data) != length:
                raise ValueError(f"{path}: record {lime_type!r} is truncated")
            f.read(_pad8(length))
            recs.append(LimeRecord(lime_type=lime_type, data=data,
                                   msg_begin=bool(bits & 0x8000), msg_end=bool(bits & 0x4000)))
    return recs


def write_lime(path: str, records: list[LimeRecord]) -> None:
    with open(path, "wb") as f:
        for r in records:
            bits = (0x8000 if r.msg_begin else 0) | (0x4000 if r.msg_end else 0)
            hdr = _HDR.pack(LIME_MAGIC, 1, bits, len(r.data))
            tname = r.lime_type.encode()[:127]
            f.write(hdr + tname + b"\0" * (128 - len(tname)))
            f.write(r.data)
            f.write(b"\0" * _pad8(len(r.data)))


def scidac_checksum(payload, site_bytes: int) -> tuple[int, int]:
    """SciDAC/QIO site-rank checksum of an ILDG binary payload: per site
    of lexicographic rank r (x fastest, t slowest: the storage order, so
    the rank is the site's index in the payload) crc = crc32 of its
    bytes, then suma ^= rotl32(crc, r % 29) and sumb ^= rotl32(crc, r %
    31).  Returns (suma, sumb).  One zlib.crc32 a site, the rotations and
    XORs vectorised."""
    n = len(payload) // site_bytes
    if n * site_bytes != len(payload):
        raise ValueError(f"payload of {len(payload)} bytes is not a whole number of "
                         f"{site_bytes}-byte sites")
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


def _scidac_checksum_xml(suma: int, sumb: int) -> bytes:
    return (f'<?xml version="1.0" encoding="UTF-8"?>'
            f'<scidacChecksum><version>1.0</version>'
            f'<suma>{suma:08x}</suma><sumb>{sumb:08x}</sumb>'
            f'</scidacChecksum>').encode()


def _parse_scidac_checksum(data) -> tuple[int, int] | None:
    txt = bytes(data).decode(errors="ignore")
    ma = re.search(r"<suma>([0-9a-fA-F]+)</suma>", txt)
    mb = re.search(r"<sumb>([0-9a-fA-F]+)</sumb>", txt)
    if ma is None or mb is None:
        return None
    return int(ma.group(1), 16), int(mb.group(1), 16)


def _ildg_format_xml(lat: Lattice, precision: int) -> bytes:
    return (f'<?xml version="1.0" encoding="UTF-8"?>'
            f'<ildgFormat xmlns="http://www.lqcd.org/ildg">'
            f'<version>1.0</version><field>su3gauge</field>'
            f'<precision>{precision}</precision>'
            f'<lx>{lat.Lx}</lx><ly>{lat.Ly}</ly>'
            f'<lz>{lat.Lz}</lz><lt>{lat.Lt}</lt>'
            f'</ildgFormat>').encode()


def site_bytes(precision: int) -> int:
    """Bytes of one site's four links in a payload of ``precision`` bits."""
    return 4 * 9 * 2 * (precision // 8)


def write_ildg_gauge(path: str, u_full, lat: Lattice, precision: int = 64) -> dict:
    """u_full: [4(mu: x, y, z, t), T, Z, Y, X, 3, 3] complex (a tensor on
    any device, or a numpy array) -> ILDG file.  Returns the seconds of
    its stages: "encode" (to big-endian bytes), "checksum", "write"."""
    t0 = time.perf_counter()
    if isinstance(u_full, torch.Tensor):
        u_full = u_full.detach().cpu().numpy()
    dt = np.dtype(">f8") if precision == 64 else np.dtype(">f4")
    u = np.transpose(np.asarray(u_full), (1, 2, 3, 4, 0, 5, 6))   # [T, Z, Y, X, mu, row, col]
    flat = np.empty((*u.shape, 2), dtype=np.float64)
    flat[..., 0] = u.real
    flat[..., 1] = u.imag
    payload = flat.astype(dt).tobytes()
    del flat
    t1 = time.perf_counter()
    suma, sumb = scidac_checksum(payload, site_bytes(precision))
    t2 = time.perf_counter()
    write_lime(path, [
        LimeRecord("ildg-format", _ildg_format_xml(lat, precision), msg_begin=True,
                   msg_end=False),
        LimeRecord("ildg-binary-data", payload, msg_begin=False, msg_end=False),
        LimeRecord("scidac-checksum", _scidac_checksum_xml(suma, sumb), msg_begin=False,
                   msg_end=True),
    ])
    return {"encode": t1 - t0, "checksum": t2 - t1, "write": time.perf_counter() - t2}


@dataclass
class IldgPayload:
    """An ILDG file's binary payload, its checksum verified when the file
    carried one, not decoded."""
    data: bytearray
    lat: Lattice
    precision: int
    #: the verified (suma, sumb), or None when the file carried no checksum
    checksum: tuple[int, int] | None = None
    #: host seconds: "read" (the file), "checksum"
    seconds: dict = field(default_factory=dict)


def read_ildg_payload(path: str) -> IldgPayload:
    """Read an ILDG file and verify its scidac-checksum record (real ETMC
    ensembles carry one): a mismatch raises ValueError.  The lattice
    comes from the ildg-format record; a file without one raises."""
    t0 = time.perf_counter()
    recs = read_lime(path)
    t1 = time.perf_counter()
    fmt = next((r for r in recs if r.lime_type == "ildg-format"), None)
    data = next((r for r in recs if r.lime_type == "ildg-binary-data"), None)
    if data is None:
        raise ValueError(f"{path} holds no ildg-binary-data record")
    csum = next((r for r in recs if r.lime_type == "scidac-checksum"), None)
    if fmt is None:
        raise ValueError(f"{path} holds no ildg-format record")
    txt = bytes(fmt.data).decode(errors="ignore")

    def grab(tag, default=None):
        m = re.search(f"<{tag}>(.*?)</{tag}>", txt)
        return int(m.group(1)) if m else default
    precision = grab("precision", 64)
    lat = Lattice((grab("lx"), grab("ly"), grab("lz"), grab("lt")))
    if precision not in (32, 64):
        raise ValueError(f"{path}: ILDG precision {precision}, not 32 or 64")
    if len(data.data) != lat.volume * site_bytes(precision):
        raise ValueError(f"{path}: {len(data.data)} payload bytes, not the "
                         f"{lat.volume * site_bytes(precision)} of {lat.dims} at {precision} bit")
    want = None
    if csum is not None:
        want = _parse_scidac_checksum(csum.data)
        if want is not None:
            got = scidac_checksum(data.data, site_bytes(precision))
            if got != want:
                raise ValueError(
                    f"scidac checksum mismatch in {path}: file says suma={want[0]:08x} "
                    f"sumb={want[1]:08x}, payload gives suma={got[0]:08x} sumb={got[1]:08x} "
                    f"(corrupt download/transfer?)")
    return IldgPayload(data.data, lat, precision, want,
                       {"read": t1 - t0, "checksum": time.perf_counter() - t1})


def read_ildg_gauge(path: str) -> tuple[torch.Tensor, Lattice]:
    """(u_full [4, T, Z, Y, X, 3, 3] complex64 on the CPU, Lattice), decoded
    on the host as tpuqcd decodes it (through float64)."""
    p = read_ildg_payload(path)
    dt = np.dtype(">f8") if p.precision == 64 else np.dtype(">f4")
    arr = np.frombuffer(p.data, dtype=dt).astype(np.float64)
    arr = arr.reshape(*p.lat.full_shape, 4, 3, 3, 2)
    u = (arr[..., 0] + 1j * arr[..., 1]).astype(np.complex64)
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(u, 4, 0))), p.lat
