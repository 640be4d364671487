"""The port's three-point functions (phys/threep_dev.py, the insertion
gammas, the timeslice smearing, io/hdf5io.write_threep) against tpuqcd on
shared inputs made from numpy seeds.

At 4x4x4x8 with random packed float32 propagators and a random gauge:
the covariant shift and symmetric derivative (every nu, with and without
conjugated links), the bilinear density, the ultra-local and the
one-derivative insertions on the phase-sum and on the FFT path, and the
backward propagator with the identity solver, each against its tpuqcd
twin in tpuqcd/phys/threep_dev.py.  The sequential source at
examples/threep.yaml's 2x2x2x4 against tpuqcd's host oracle
phys/threep.proton_seq_source (tpuqcd's packed one takes 20-40 s a call
on the CPU here, eagerly; its own test holds the two equal), and the
port's timeslice gradient against its own full-volume autograd at 4x4x4x8.
Tolerances, on max|port - tpuqcd| / max|tpuqcd|: 1e-6 for the shifts and
the backward propagator (the same float32 products), 1e-5 for densities,
correlators and sequential sources (float32 products summed in another
order).  Serial cost about 20 s, most of it tpuqcd's XLA compiles of its
one-derivative kernels (8 of them)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd import gammas as jg
from tpuqcd.io import hdf5io as jio
from tpuqcd.phys import contract_dev as jdev
from tpuqcd.phys import threep as jthreep
from tpuqcd.phys import threep_dev as jthreep_dev

from tpuqcd_torch import gammas as tg
from tpuqcd_torch.io import hdf5io
from tpuqcd_torch.phys import threep_dev as tthreep
from tpuqcd_torch.phys.contract_dev import prop_to_device, proton_2pt_site_dev
from tpuqcd_torch.phys.propagator import sink_smear_prop_pk, sink_smear_timeslice_pk
from tpuqcd_torch.phys.threep_dev import (backward_prop_pk, bilinear_density_pk,
                                          cov_deriv_sym_pk, cov_shift_pk, momentum_phases_pk,
                                          proton_seq_source_pk, threep_one_derivative_all_pk,
                                          threep_one_derivative_pk, threep_ultralocal_pk)

from _torch_inputs import gauge_full, jax_gauge_pk, lattices, n, t

LAT, JLAT = lattices((4, 4, 4, 8))
SEQ_LAT, SEQ_JLAT = lattices((2, 2, 2, 4))    # examples/threep.yaml's lattice
MOMENTA = np.array([[0, 0, 0], [1, 0, 0], [0, 1, -1]])
DENSE = np.array([(a, b, c) for a in range(-2, 3) for b in range(-2, 3) for c in range(-2, 3)
                  if a * a + b * b + c * c <= 4])          # 33 momenta: the FFT path
SRC = (1, 0, 2, 3)                                        # (t0, z0, y0, x0)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _props(lat, seed=5, k=2):
    """k random packed float32 propagators [2ri, 2par, 4, 3, 4, 3, T, Z, S]."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, 2, 4, 3, 4, 3, *lat.site_shape)).astype(np.float32)
            for _ in range(k)]


def _gauge():
    return jax_gauge_pk(gauge_full(LAT, 1), JLAT, True, jnp.float32)


def _full_props(lat, seed, k=2):
    """k random complex64 full-layout propagators [T, Z, Y, X, 4, 3, 4, 3]."""
    rng = np.random.default_rng(seed)
    shape = (*lat.full_shape, 4, 3, 4, 3)
    return [(rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
            for _ in range(k)]


def test_insertion_gammas_equal_tpuqcd_in_name_and_order():
    assert list(tg.INSERTION_GAMMAS) == list(jg.INSERTION_GAMMAS)
    for name, g in jg.INSERTION_GAMMAS.items():
        np.testing.assert_allclose(tg.INSERTION_GAMMAS[name].numpy(), g, atol=1e-15,
                                   err_msg=name)


@pytest.mark.parametrize("conj", [False, True], ids=["links", "conj_links"])
@pytest.mark.parametrize("nu", range(4))
def test_covariant_shift_and_derivative_match_tpuqcd(nu, conj):
    u = _gauge()
    (f,) = _props(LAT, seed=10 + nu, k=1)
    for sign in (+1, -1):
        want = jthreep_dev.cov_shift_pk(u, jnp.asarray(f), nu, sign, JLAT, conj)
        got = cov_shift_pk(t(u), t(f), nu, sign, LAT, conj)
        assert got.shape == f.shape and got.dtype == torch.float32
        _close(n(got), want, 1e-6)
    want = jthreep_dev.cov_deriv_sym_pk(u, jnp.asarray(f), nu, JLAT, conj)
    _close(n(cov_deriv_sym_pk(t(u), t(f), nu, LAT, conj)), want, 1e-6)


def test_chunked_sites_equal_one_chunk(monkeypatch):
    """A chunk that does not divide a parity's site count gives the same
    derivative and bilinear density as one chunk."""
    from tpuqcd_torch.phys import contract_dev as tdev
    b, s = (t(p) for p in _props(LAT))
    u = t(_gauge())
    whole = (cov_deriv_sym_pk(u, s, 3, LAT), bilinear_density_pk(b, s))
    monkeypatch.setattr(tdev, "SITE_CHUNK", 100)
    np.testing.assert_allclose(n(cov_deriv_sym_pk(u, s, 3, LAT)), n(whole[0]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(n(bilinear_density_pk(b, s)), n(whole[1]), rtol=1e-6, atol=1e-5)


def test_bilinear_density_matches_tpuqcd():
    b, s = _props(LAT)
    want = jthreep_dev.bilinear_density_pk(jnp.asarray(b), jnp.asarray(s))
    got = bilinear_density_pk(t(b), t(s))
    assert got.shape == (2, 2, 4, 4, *LAT.site_shape)
    _close(n(got), want, 1e-5)


@pytest.mark.parametrize("path", ["phase", "fft"])
def test_ultralocal_insertions_match_tpuqcd(path):
    """tpuqcd takes the FFT for 32 momenta or more; the port takes the path
    it is given."""
    moms = MOMENTA if path == "phase" else DENSE
    b, s = _props(LAT, seed=6)
    want = jthreep_dev.threep_ultralocal_pk(jnp.asarray(b), jnp.asarray(s), jg.INSERTION_GAMMAS,
                                            JLAT, moms, src_pos=SRC)
    got = threep_ultralocal_pk(t(b), t(s), tg.INSERTION_GAMMAS, LAT, moms, SRC,
                               fft=path == "fft")
    assert list(got) == list(want)
    for name in want:
        assert got[name].shape == (len(moms), LAT.Lt) and got[name].dtype == torch.complex128
        _close(n(got[name]), want[name], 1e-5)


@pytest.mark.parametrize("path", ["phase", "fft"])
def test_one_derivative_insertions_match_tpuqcd(path):
    moms = MOMENTA if path == "phase" else DENSE
    b, s = _props(LAT, seed=7)
    u = _gauge()
    want = jthreep_dev.threep_one_derivative_all_pk(jnp.asarray(b), jnp.asarray(s), u, JLAT,
                                                    moms, src_pos=SRC)
    got = threep_one_derivative_all_pk(t(b), t(s), t(u), LAT, moms, SRC, fft=path == "fft")
    assert sorted(got) == sorted(want) and len(got) == 16
    for name in want:
        _close(n(got[name]), want[name], 1e-5)
    one = threep_one_derivative_pk(t(b), t(s), t(u), 2, 1, LAT, moms, SRC, fft=path == "fft")
    _close(n(one), n(got["der_g2_D1"]), 1e-12)


def test_backward_propagator_with_the_identity_solver_matches_tpuqcd():
    (seq,) = _props(LAT, seed=8, k=1)
    seen = []

    def identity(bs):
        seen.append(tuple(bs.shape))
        assert bs.is_contiguous()
        return bs
    want = jthreep_dev.backward_prop_pk(jnp.asarray(seq), lambda b: b)
    got = backward_prop_pk(t(seq), identity)
    assert seen == [(12, 2, 2, 4, 3, *LAT.site_shape)]         # one batch of 12 columns
    _close(n(got), want, 1e-6)


SEQ_CASES = [("u", "P+", None), ("d", "P-", None), ("u", "P5z", None), ("d", "P5z", None),
             ("u", "P+", (1, 0, 1)), ("d", "P5z", (0, 1, 1))]


@pytest.mark.parametrize("leg,pname,snk", SEQ_CASES,
                         ids=[f"{a}-{b}-{'p0' if c is None else 'p1'}" for a, b, c in SEQ_CASES])
def test_sequential_source_matches_tpuqcd(leg, pname, snk):
    """At the origin the port's e^{-ip'.(x - x0)} is tpuqcd's e^{-ip'.x};
    with the source at x0 the port's is e^{+ip'.x0} times tpuqcd's."""
    su, sd = _full_props(SEQ_LAT, seed=20)
    snk_np = None if snk is None else np.asarray(snk)
    want = jdev.prop_to_device(
        jthreep.proton_seq_source(jnp.asarray(su), jnp.asarray(sd), 2, leg, SEQ_JLAT,
                                  proj=jg.PROJECTORS[pname], snk_mom=snk_np), SEQ_JLAT)
    pu, pd = (prop_to_device(t(p), SEQ_LAT) for p in (su, sd))
    got = proton_seq_source_pk(pu, pd, 2, leg, SEQ_LAT, tg.PROJECTORS[pname], snk)
    assert got.shape == pu.shape and got.dtype == torch.float32
    _close(n(got), want, 1e-5)
    assert not n(got)[..., [0, 1, 3], :, :].any()               # zero off t_sink
    if snk is not None:
        x0 = (1, 0, 1)
        moved = proton_seq_source_pk(pu, pd, 2, leg, SEQ_LAT, tg.PROJECTORS[pname], snk, x0)
        phase = np.exp(2j * np.pi * sum(q * x / 2 for q, x in zip(snk, x0)))
        w = np.asarray(want)
        _close(n(moved), np.stack([(phase * (w[0] + 1j * w[1])).real,
                                    (phase * (w[0] + 1j * w[1])).imag]), 1e-5)


def _to_full(prop_pk: np.ndarray, lat) -> np.ndarray:
    """Packed propagator -> complex [T, Z, Y, X, 4, 3, 4, 3]."""
    from tpuqcd_torch.fields import eo_to_full
    c = t(prop_pk[0] + 1j * prop_pk[1]).reshape(2, 4, 3, 4, 3, lat.Lt, lat.Lz, lat.Ly,
                                                lat.Lx // 2)
    return n(eo_to_full(torch.movedim(c, (1, 2, 3, 4), (5, 6, 7, 8)), lat))


def test_sequential_source_moves_with_the_source():
    """The sink-momentum convention, decided: propagators from a source moved
    by d (the gauge moved with it) are the old ones moved by d, and the
    two-point function at p' is unchanged.  So must the three-point
    function be, and so its sequential source must move with them.  The
    port's does; tpuqcd's picks up e^{-ip'.d}, which C2 at p' does not
    carry: C3 / C2 then depends on the source position."""
    su, sd = _full_props(SEQ_LAT, seed=21)
    snk, d = (1, 0, 0), (1, 1, 0)                                  # p' and d = (x, y, z)
    roll = lambda a: np.roll(a, (d[2], d[1], d[0]), axis=(1, 2, 3))  # noqa: E731
    proj = tg.PROJECTORS["P+"]
    pk = lambda a: prop_to_device(t(a), SEQ_LAT)                    # noqa: E731
    at0 = _to_full(n(proton_seq_source_pk(pk(su), pk(sd), 1, "u", SEQ_LAT, proj, snk)), SEQ_LAT)
    at_d = _to_full(n(proton_seq_source_pk(pk(roll(su)), pk(roll(sd)), 1, "u", SEQ_LAT, proj,
                                           snk, d)), SEQ_LAT)
    _close(at_d, roll(at0), 1e-6)
    c2 = lambda a, b, x0: tthreep.project_momenta_pk(                # noqa: E731
        proton_2pt_site_dev(pk(a), pk(b), proj), SEQ_LAT, [snk], x0)
    _close(n(c2(roll(su), roll(sd), d)), n(c2(su, sd, (0, 0, 0))), 1e-6)
    j = lambda a, b: np.asarray(jthreep.proton_seq_source(           # noqa: E731
        jnp.asarray(a), jnp.asarray(b), 1, "u", SEQ_JLAT, proj=jg.PARITY_PLUS,
        snk_mom=np.asarray(snk)))
    phase = np.exp(-2j * np.pi * sum(q * x / 2 for q, x in zip(snk, d)))   # -1 here
    _close(j(roll(su), roll(sd)), phase * roll(j(su, sd)), 1e-5)
    assert np.abs(j(roll(su), roll(sd)) - roll(j(su, sd))).max() > 1.0


@pytest.mark.parametrize("leg", ["u", "d"])
def test_timeslice_gradient_equals_full_volume_autograd(leg):
    su, sd = (t(p) for p in _props(LAT, seed=9))
    snk, x0, ts = (1, 0, -1), (3, 2, 0), 5
    proj = tg.PROJECTORS["P5z"]
    got = proton_seq_source_pk(su, sd, ts, leg, LAT, proj, snk, x0)
    var = (su if leg == "u" else sd).clone().requires_grad_(True)
    dens = proton_2pt_site_dev(var, sd, proj) if leg == "u" else proton_2pt_site_dev(su, var, proj)
    ph = momentum_phases_pk(LAT, [snk], x0)[:, 0]
    c2_re = (ph[0, :, ts] * dens[0, :, ts] - ph[1, :, ts] * dens[1, :, ts]).sum()
    (g,) = torch.autograd.grad(c2_re, var)
    _close(n(got), n(torch.stack([g[0], -g[1]])), 1e-6)


@pytest.mark.parametrize("ts", [4, 5])
def test_timeslice_smearing_equals_smearing_the_whole_field(ts):
    """A propagator that is zero off t_sink (t even or odd) smears as on the
    whole lattice."""
    (p,) = _props(LAT, seed=11, k=1)
    p[..., :ts, :, :] = 0
    p[..., ts + 1:, :, :] = 0
    u = t(jax_gauge_pk(gauge_full(LAT, 3), JLAT, False, jnp.float32))
    whole = sink_smear_prop_pk(u, t(p), LAT, 2.0, 3)
    got = sink_smear_timeslice_pk(u, t(p), LAT, ts, 2.0, 3)
    _close(n(got), n(whole), 1e-6)
    assert not n(got)[..., [t_ for t_ in range(LAT.Lt) if t_ != ts], :, :].any()


def test_write_threep_round_trip_and_tpuqcd_layout(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(4)
    corr = rng.standard_normal((3, 2, 8)) + 1j * rng.standard_normal((3, 2, 8))
    moms, names = np.array([[0, 0, 0], [1, 0, -1]]), ["1", "g5", "der_g0_D3"]
    meta = {"sink_momentum": np.array([0, 0, 1])}
    group = "threep/proton/P+/u/ts2/sx0sy0sz0st0"
    for path, writer in ((tmp_path / "port.h5", hdf5io.write_threep),
                         (tmp_path / "ref.h5", jio.write_threep)):
        writer(str(path), group, corr, moms, names, (0, 0, 0, 0), 2, meta=meta)
    with h5py.File(tmp_path / "port.h5", "r") as f, h5py.File(tmp_path / "ref.h5", "r") as g:
        seen = []
        f.visititems(lambda k, v: seen.append(k) if isinstance(v, h5py.Dataset) else None)
        want = []
        g.visititems(lambda k, v: want.append(k) if isinstance(v, h5py.Dataset) else None)
        assert seen == want and len(seen) == 6
        for k in seen:
            np.testing.assert_array_equal(f[k][()], g[k][()])
        a, b = dict(f[group].attrs), dict(g[group].attrs)
        assert sorted(a) == sorted(b) == ["sink_momentum", "src_pos", "t_sink"]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(
        hdf5io.read_dataset(str(tmp_path / "port.h5"), f"{group}/g5/mom_1_0_-1"), corr[1, 1])
    hdf5io.write_threep(str(tmp_path / "port.h5"), group, np.zeros_like(corr), moms, names,
                        (0, 0, 0, 0), 2)                            # writing again replaces
    assert not hdf5io.read_dataset(str(tmp_path / "port.h5"), f"{group}/1/mom_0_0_0").any()
