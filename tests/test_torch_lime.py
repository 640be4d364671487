"""ILDG/LIME I/O of the port against tpuqcd's, the device decode, and the
background read-ahead.

tpuqcd's writer and the port's write byte-identical files (64 and 32
bit) and each package reads the other's; the SciDAC checksum equals
tpuqcd's; a flipped payload byte (read now or on the read-ahead thread),
a bad magic and a truncated payload raise.  The port's device decode (io/native.py, torch on the
run's device; here the CPU) equals tpuqcd's native C++ ingest to 2e-7,
as tests/test_io.py holds that to tpuqcd's own Python chain, and equals
the port's host decode -> even-odd -> device layout -> phase -> pack
exactly.  The prefetch contracts are tpuqcd's (tests/test_prefetch.py);
prefetch_after starts the next read only once the current one is taken,
as ensemble_members queues its files.  About 5 s serial."""
import threading

import numpy as np
import pytest
import torch

from tpuqcd.io import lime as jlime
from tpuqcd.io import native as jnative

from tpuqcd_torch.fields import apply_boundary_phase, gauge_full_to_eo
from tpuqcd_torch.io import lime, prefetch as pf
from tpuqcd_torch.io.native import ildg_payload_to_device, ildg_payload_to_packed
from tpuqcd_torch.ops.layout import gauge_to_device
from tpuqcd_torch.utils.packed import pack_gauge

from _torch_inputs import gauge_full, lattices, n

LAT, JLAT = lattices((4, 4, 4, 8))


def _payload(path):
    return next(r for r in lime.read_lime(path) if r.lime_type == "ildg-binary-data").data


@pytest.mark.parametrize("precision", [64, 32])
def test_each_package_reads_the_others_files(tmp_path, precision):
    u = gauge_full(LAT, 1)
    pj, pt = str(tmp_path / "j.lime"), str(tmp_path / "t.lime")
    jlime.write_ildg_gauge(pj, u, JLAT, precision=precision)
    lime.write_ildg_gauge(pt, torch.from_numpy(u), LAT, precision=precision)
    want, _ = jlime.read_ildg_gauge(pj)                       # complex64
    got, lat = lime.read_ildg_gauge(pj)
    assert lat.dims == LAT.dims and got.dtype == torch.complex64
    np.testing.assert_array_equal(n(got), want)
    back, jlat = jlime.read_ildg_gauge(pt)
    assert jlat.dims == LAT.dims
    np.testing.assert_array_equal(back, want)
    np.testing.assert_allclose(want, u, atol=1e-6 if precision == 32 else 1e-7)


@pytest.mark.parametrize("precision", [64, 32])
def test_the_two_writers_are_byte_identical(tmp_path, precision):
    u = gauge_full(LAT, 2)
    for name, arr in (("c128", u), ("c64", u.astype(np.complex64))):
        pj, pt = tmp_path / f"j{name}.lime", tmp_path / f"t{name}.lime"
        jlime.write_ildg_gauge(str(pj), arr, JLAT, precision=precision)
        stages = lime.write_ildg_gauge(str(pt), torch.from_numpy(arr), LAT,
                                       precision=precision)
        assert set(stages) == {"encode", "checksum", "write"}
        assert pj.read_bytes() == pt.read_bytes(), name


@pytest.mark.parametrize("site_bytes", [576, 288])
def test_scidac_checksum_equals_tpuqcds(site_bytes):
    payload = np.random.default_rng(site_bytes).integers(0, 256, 37 * site_bytes,
                                                         dtype=np.uint8).tobytes()
    assert lime.scidac_checksum(payload, site_bytes) == jlime.scidac_checksum(payload,
                                                                              site_bytes)
    assert lime.scidac_checksum(bytearray(payload), site_bytes) == \
        jlime.scidac_checksum(payload, site_bytes)
    with pytest.raises(ValueError, match="whole number"):
        lime.scidac_checksum(payload[:-1], site_bytes)


def test_corrupt_payload_bad_magic_and_wrong_size_raise(tmp_path):
    p = str(tmp_path / "cfg.lime")
    jlime.write_ildg_gauge(p, gauge_full(LAT, 3), JLAT)
    recs = lime.read_lime(p)
    assert [r.lime_type for r in recs] == ["ildg-format", "ildg-binary-data",
                                           "scidac-checksum"]
    recs[1].data[100] ^= 0xFF
    bad = str(tmp_path / "bad.lime")
    lime.write_lime(bad, recs)

    def prefetched(path):
        pf.prefetch(path)
        return pf.take(path)
    for read in (lime.read_ildg_gauge, lime.read_ildg_payload, pf.take, prefetched):
        with pytest.raises(ValueError, match="checksum mismatch"):
            read(bad)
    with pytest.raises(ValueError, match="checksum mismatch"):   # tpuqcd agrees
        jlime.read_ildg_gauge(bad)
    raw = bytearray(open(p, "rb").read())
    raw[0] ^= 0x01
    magic = tmp_path / "magic.lime"
    magic.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="bad LIME magic"):
        lime.read_ildg_payload(str(magic))
    recs = lime.read_lime(p)
    recs[1].data = recs[1].data[:-576]
    short = str(tmp_path / "short.lime")
    lime.write_lime(short, recs[:2])
    with pytest.raises(ValueError, match="payload bytes"):
        lime.read_ildg_payload(short)
    recs = lime.read_lime(p)
    nofmt = str(tmp_path / "nofmt.lime")
    lime.write_lime(nofmt, recs[1:])
    with pytest.raises(ValueError, match="no ildg-format record"):
        lime.read_ildg_payload(nofmt)


@pytest.mark.parametrize("antiperiodic_t", [True, False])
def test_payload_to_packed_matches_tpuqcds_native_ingest(tmp_path, antiperiodic_t):
    if jnative.get_lib() is None:
        pytest.skip("tpuqcd's native ingest needs g++")
    p = str(tmp_path / "conf.ildg")
    jlime.write_ildg_gauge(p, gauge_full(LAT, 7), JLAT)
    payload = _payload(p)
    want = jnative.ildg_payload_to_packed(bytes(payload), JLAT, antiperiodic_t=antiperiodic_t)
    got = ildg_payload_to_packed(payload, LAT, antiperiodic_t, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(n(got), want, atol=2e-7, rtol=0)


@pytest.mark.parametrize("precision,antiperiodic_t", [(64, True), (32, True), (64, False)])
def test_payload_to_packed_is_the_host_chain_exactly(tmp_path, precision, antiperiodic_t):
    p = str(tmp_path / "conf.ildg")
    lime.write_ildg_gauge(p, torch.from_numpy(gauge_full(LAT, 8)), LAT, precision=precision)
    u_full, lat = lime.read_ildg_gauge(p)
    u_dev = gauge_to_device(gauge_full_to_eo(u_full, lat), lat)
    payload = lime.read_ildg_payload(p)
    assert payload.precision == precision and set(payload.seconds) == {"read", "checksum"}
    assert payload.checksum == lime.scidac_checksum(payload.data, lime.site_bytes(precision))
    nock = str(tmp_path / "nock.ildg")
    lime.write_lime(nock, lime.read_lime(p)[:2])
    assert lime.read_ildg_payload(nock).checksum is None
    dev = ildg_payload_to_device(payload.data, lat, precision, "cpu")
    assert dev.dtype == torch.complex64 and torch.equal(dev, u_dev)
    want = pack_gauge(apply_boundary_phase(u_dev, lat, "device", antiperiodic_t), torch.float32)
    got = ildg_payload_to_packed(payload.data, lat, antiperiodic_t, precision, "cpu")
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="not a"):
        ildg_payload_to_device(payload.data[:-8], lat, precision, "cpu")


def _written(tmp_path, name, seed):
    u = gauge_full(LAT, seed)
    p = str(tmp_path / name)
    jlime.write_ildg_gauge(p, u, JLAT)
    return p, u.astype(np.complex64)


def _decoded(payload):
    return ildg_payload_to_device(payload.data, payload.lat, payload.precision, "cpu")


def test_prefetch_roundtrip(tmp_path):
    p, u = _written(tmp_path, "a.lime", 0)
    want = gauge_to_device(gauge_full_to_eo(torch.from_numpy(u), LAT), LAT)
    pf.prefetch(p)
    pf.prefetch(p)          # idempotent while in flight
    got = pf.take(p)
    assert got.lat.dims == LAT.dims and isinstance(got.data, bytearray)
    assert torch.equal(_decoded(got), want)
    # a taken entry is consumed: a second take is a fresh synchronous read
    assert torch.equal(_decoded(pf.take(p)), want)


def test_take_without_prefetch_reads(tmp_path):
    p, u = _written(tmp_path, "b.lime", 1)
    assert torch.equal(_decoded(pf.take(p)),
                       gauge_to_device(gauge_full_to_eo(torch.from_numpy(u), LAT), LAT))


def test_prefetch_error_surfaces_at_take(tmp_path):
    p = str(tmp_path / "missing.lime")
    pf.prefetch(p)
    with pytest.raises(FileNotFoundError):
        pf.take(p)


def test_prefetch_after_starts_the_next_read_once_take_returns(tmp_path):
    from tpuqcd_torch.cli.common import ensemble_members
    from tpuqcd_torch.utils.config import config_from_dict
    (a, _), (b, u_b) = _written(tmp_path, "m0.lime", 3), _written(tmp_path, "m1.lime", 4)
    cfg = config_from_dict({"gauge": {"dims": list(LAT.dims), "config_files": [a, b]},
                            "physics": {"output": str(tmp_path / "twop.h5")}})
    members = ensemble_members(cfg, torch.device("cpu"))
    next(members)
    assert a not in pf._pending and b not in pf._pending    # nothing read at the yield
    pf.take(a)                                              # member 0's own read ...
    assert b in pf._pending                                 # ... then member 1's read-ahead
    assert torch.equal(_decoded(pf.take(b)),
                       gauge_to_device(gauge_full_to_eo(torch.from_numpy(u_b), LAT), LAT))
    assert a not in pf._after and b not in pf._pending


def test_prefetch_thread_makes_no_torch_call(tmp_path, monkeypatch):
    """The read-ahead thread reads and verifies bytes only: a torch tensor
    made on it (the decode, a device copy) would fail here."""
    p, _ = _written(tmp_path, "c.lime", 2)
    main = threading.current_thread()
    real = torch.frombuffer

    def main_only(*a, **k):
        assert threading.current_thread() is main, "torch call on the read-ahead thread"
        return real(*a, **k)
    monkeypatch.setattr(torch, "frombuffer", main_only)
    monkeypatch.setattr(torch, "from_numpy", lambda *a: pytest.fail("from_numpy in thread"))
    pf.prefetch(p)
    got = pf.take(p)
    assert len(got.data) == LAT.volume * lime.site_bytes(64)
    monkeypatch.undo()
    assert _decoded(got).shape == (4, 2, 3, 3, *LAT.site_shape)
