"""The frozen inputs and the plain reference against the port at 4^3x8:
the heatbath chain and the ILDG writer bit for bit, the operator, the
smearing, the contractions and the projection to float64 rounding.  The
test imports both; the reference itself imports nothing of the port."""
from __future__ import annotations

import torch

from qcdbench.inputs import heatbath, lime
from qcdbench.reference import fields, operator as op, twop as tw

DIMS = (4, 4, 4, 8)


def _port_gauge(seed=3):
    from tpuqcd_torch import su3
    from tpuqcd_torch.lattice import Lattice
    lat = Lattice(DIMS)
    u = su3.random_gauge(lat, torch.Generator().manual_seed(seed), dtype=torch.complex128)
    return lat, u


def _rand_spinor(seed, *lead):
    g = torch.Generator().manual_seed(seed)
    shape = (*lead, DIMS[3], DIMS[2], DIMS[1], DIMS[0], 4, 3)
    return torch.complex(torch.randn(shape, generator=g, dtype=torch.float64),
                         torch.randn(shape, generator=g, dtype=torch.float64))


def test_heatbath_chain_bit_for_bit():
    from tpuqcd_torch.fields import gauge_eo_to_full
    from tpuqcd_torch.lattice import Lattice
    from tpuqcd_torch.ops.heatbath import thermalize
    from tpuqcd_torch.ops.layout import gauge_from_device
    lat = Lattice(DIMS)
    port = thermalize(torch.Generator().manual_seed(11), lat, 6.0, 3)
    frozen = heatbath.thermalize(torch.Generator().manual_seed(11), DIMS, 6.0, 3)
    assert torch.equal(port, frozen)
    assert torch.equal(gauge_eo_to_full(gauge_from_device(port, lat), lat),
                       heatbath.gauge_device_to_full(frozen, DIMS))


def test_lime_writer_byte_for_byte(tmp_path):
    from tpuqcd_torch.io.lime import write_ildg_gauge
    lat, u = _port_gauge()
    write_ildg_gauge(str(tmp_path / "port.lime"), u, lat)
    lime.write_ildg_gauge(str(tmp_path / "frozen.lime"), u, DIMS)
    assert (tmp_path / "port.lime").read_bytes() == (tmp_path / "frozen.lime").read_bytes()
    back, dims = lime.read_gauge_f64(str(tmp_path / "frozen.lime"))
    assert dims == DIMS and torch.equal(back, u)


def test_layout_round_trip():
    from tpuqcd_torch.phys.propagator import full_to_packed
    from tpuqcd_torch.lattice import Lattice
    psi = _rand_spinor(5)
    pk = full_to_packed(psi, Lattice(DIMS), torch.float64)
    assert torch.equal(fields.full_to_packed(psi, DIMS, torch.float64), pk)
    assert torch.equal(fields.packed_to_full(pk, DIMS), psi)


def test_operator_equals_port():
    from tpuqcd_torch.fields import apply_boundary_phase, gauge_full_to_eo
    from tpuqcd_torch.mg.device import DeviceFineLevel
    from tpuqcd_torch.ops.layout import gauge_to_device
    from tpuqcd_torch.utils.packed import pack_gauge
    lat, u = _port_gauge()
    u_pk = pack_gauge(apply_boundary_phase(gauge_to_device(gauge_full_to_eo(u, lat), lat), lat,
                                           "device"), torch.float64)
    psi = _rand_spinor(6)
    for flavor in (+1, -1):
        lv = DeviceFineLevel(lat, u_pk, 0.157, 0.0009 * 30, flavor)
        x = fields.full_to_packed(psi, DIMS, torch.float64).transpose(0, 1).contiguous()
        port = lv.apply(x).transpose(0, 1)
        ref = fields.full_to_packed(op.apply_m(op.phased(u), psi, 0.157, 0.027, flavor), DIMS,
                                    torch.float64)
        assert (port - ref).abs().max() < 1e-13 * ref.abs().max()


def test_smearing_contractions_projection_equal_port():
    from tpuqcd_torch.fields import gauge_full_to_eo
    from tpuqcd_torch.gammas import GAMMA5, PARITY_PLUS
    from tpuqcd_torch.ops.gauge_tools import ape_smear
    from tpuqcd_torch.ops.layout import gauge_to_device
    from tpuqcd_torch.phys.contract_dev import (density_to_full, meson_2pt_site_dev,
                                                prop_to_device, proton_2pt_site_dev)
    from tpuqcd_torch.phys.smear import gaussian_smear_pk
    from tpuqcd_torch.phys.threep_dev import project_momenta_pk
    from tpuqcd_torch.utils.packed import pack_gauge
    lat, u = _port_gauge()
    u_sm = ape_smear(gauge_to_device(gauge_full_to_eo(u, lat), lat), lat, 0.5, 3)
    ref_sm = tw.ape_smear(u, 0.5, 3)
    psi = _rand_spinor(7)
    port = gaussian_smear_pk(pack_gauge(u_sm, torch.float64),
                             fields.full_to_packed(psi, DIMS, torch.float64), lat, 4.0, 5)
    ref = fields.full_to_packed(tw.gauss_smear(ref_sm, psi, 4.0, 5), DIMS, torch.float64)
    assert (port - ref).abs().max() < 1e-12 * ref.abs().max()
    su, sd = _rand_spinor(8, 4, 3), _rand_spinor(9, 4, 3)    # [src s, src c, T, Z, Y, X, 4, 3]
    full_u, full_d = (s.permute(2, 3, 4, 5, 6, 7, 0, 1) for s in (su, sd))
    pu, pd = (prop_to_device(f, lat, torch.float64) for f in (full_u, full_d))
    flat_u, flat_d = (f.reshape(-1, 4, 3, 4, 3) for f in (full_u, full_d))
    mom = [[0, 0, 0], [1, 0, 0], [0, 1, 1]]
    src = (1, 2, 3)
    for port_d, ref_d in ((proton_2pt_site_dev(pu, pd, PARITY_PLUS),
                           tw.proton_density(flat_u, flat_d, tw.PROJECTORS["P+"])),
                          (meson_2pt_site_dev(pu, pu, GAMMA5),
                           tw.meson_density(flat_u, flat_u, tw.MESONS["pion"]))):
        dens = ref_d.reshape(DIMS[3], DIMS[2], DIMS[1], DIMS[0])
        assert (density_to_full(port_d, lat) - dens).abs().max() < 1e-12 * dens.abs().max()
        c_port = project_momenta_pk(port_d, lat, mom, src)
        c_ref = tw.project(dens, mom, src)
        assert (c_port - c_ref).abs().max() < 1e-12 * c_ref.abs().max()
