"""Ensembles in the port: the heatbath chain, the members of an ensemble
run, and the two-point run over ILDG files against tpuqcd's.

generate_ensemble is one Markov chain (member 0 is thermalize(n_therm),
each next member n_skip sweeps on from the last, none aliased);
_heatbath_chain_members writes tpuqcd's file names, pins each member's
plaquette and reads back the generated links bit for bit; ensemble_members
gives tpuqcd's tags and output names.  run_twop.main over two ILDG files
that tpuqcd wrote matches tpuqcd's run_twop.main on the same files, member
by member, within test_torch_twop.py's tolerance (rtol 1e-4, atol 1e-6 of
the largest value), tpuqcd's setup_gauge patched to apply the configured
boundary phase (ROADMAP.md, Queue 3).  The example ensemble configs load
with every key, and a file of another lattice than gauge.dims raises.
About 65 s serial, 60 of it tpuqcd's two-point run over two members
(test_torch_ensemble_clis.py runs the port's four programs over
ensembles)."""
import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from tpuqcd.cli.common import ensemble_members as j_ensemble_members
from tpuqcd.io.lime import write_ildg_gauge as j_write_ildg_gauge
from tpuqcd.utils.config import load_config as j_load_config

from tpuqcd_torch.cli import run_twop
from tpuqcd_torch.cli.common import (_heatbath_chain_members, ensemble_members, setup_gauge)
from tpuqcd_torch.io.lime import read_ildg_gauge
from tpuqcd_torch.fields import gauge_full_to_eo
from tpuqcd_torch.ops.gauge_tools import plaquette
from tpuqcd_torch.ops.heatbath import generate_ensemble, thermalize
from tpuqcd_torch.ops.layout import gauge_to_device
from tpuqcd_torch.utils.config import ConfigError, config_from_dict, load_config

from _torch_inputs import gauge_full, lattices, tpuqcd_setup_gauge_phase_as_configured

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
LAT, JLAT = lattices((4, 4, 4, 8))
SMALL, _ = lattices((4, 4, 4, 4))


def _h5_all(path):
    import h5py
    vals = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: vals.__setitem__(name, np.asarray(obj))
                     if isinstance(obj, h5py.Dataset) else None)
    return vals


def _yaml(tmp_path, name, raw):
    path = tmp_path / name
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_generate_ensemble_is_one_chain():
    gen = torch.Generator().manual_seed(11)
    members = list(generate_ensemble(gen, SMALL, 6.0, 3, n_therm=2, n_skip=1))
    ref = torch.Generator().manual_seed(11)
    u = thermalize(ref, SMALL, 6.0, 2)
    assert torch.equal(members[0], u)
    for m in members[1:]:
        u = thermalize(ref, SMALL, 6.0, 1, u0=u)
        assert torch.equal(m, u)
    # the generator stopped after the last member: no sweep was spent past it
    assert torch.equal(gen.get_state(), ref.get_state())
    ptrs = {m.untyped_storage().data_ptr() for m in members}
    assert len(ptrs) == 3 and not torch.equal(members[0], members[1])
    keep = members[1].clone()
    members[0].zero_()
    assert torch.equal(members[1], keep)


def test_heatbath_chain_members_write_pin_and_read_back(tmp_path):
    raw = {"gauge": {"dims": list(SMALL.dims), "heatbath_beta": 6.0, "heatbath_sweeps": 2,
                     "heatbath_n_cfg": 2, "heatbath_skip": 1, "random_seed": 4},
           "physics": {"output": str(tmp_path / "out" / "twop.h5")}}
    cfg = config_from_dict(raw)
    keep = []
    members = _heatbath_chain_members(cfg, CPU, keep)
    d = tmp_path / "out" / "ensemble"                 # '<output dir>/ensemble'
    assert [m[0] for m in members] == ["c0000", "c0001"]
    assert [m[1].config_file for m in members] == [str(d / "hb_b6_0000.lime"),
                                                    str(d / "hb_b6_0001.lime")]
    for (ctag, g), k in zip(members, keep):
        assert g.heatbath_beta is None and g.plaquette_check == k["plaquette"]
        assert k["plaquette"] == plaquette(k["links"], SMALL)
        u_full, lat = read_ildg_gauge(g.config_file)
        assert lat.dims == SMALL.dims
        assert torch.equal(gauge_to_device(gauge_full_to_eo(u_full, lat), lat), k["links"])
        assert set(k["write"]) == {"encode", "checksum", "write"}
    # member 0 is setup_gauge's heatbath gauge; each member re-reads with its plaquette pinned
    single = setup_gauge(config_from_dict({**raw, "gauge": {**raw["gauge"],
                                                            "heatbath_n_cfg": 1}}), CPU)
    back = [setup_gauge(dataclasses.replace(cfg, gauge=g), CPU) for _, g in members]
    assert torch.equal(back[0].u_pk, single.u_pk)
    assert back[0].plaquette != back[1].plaquette
    # heatbath_dir wins
    cfg_dir = config_from_dict({**raw, "gauge": {**raw["gauge"],
                                                  "heatbath_dir": str(tmp_path / "hb")}})
    paths = [g.config_file for _, g in _heatbath_chain_members(cfg_dir, CPU)]
    assert paths == [str(tmp_path / "hb" / f"hb_b6_000{i}.lime") for i in (0, 1)]


@pytest.mark.parametrize("mode", ["config_files", "random_seeds", "single"])
def test_ensemble_members_tags_and_outputs_are_tpuqcds(tmp_path, mode):
    gauge = {"dims": list(LAT.dims),
             "config_files": {"config_files": [str(tmp_path / "a" / "conf.1000.lime"),
                                               str(tmp_path / "conf.1004.lime")]},
             "random_seeds": {"random_seeds": [3, 17]},
             "single": {"random_seed": 5}}
    raw = {"gauge": {"dims": list(LAT.dims), **gauge[mode]},
           "physics": {"output": str(tmp_path / "out" / "twop.ens.h5")}}
    path = _yaml(tmp_path, "ens.yaml", raw)
    ours = [(tag, c.physics.output, c.gauge.config_file, c.gauge.random_seed)
            for tag, c in ensemble_members(load_config(path), CPU)]
    theirs = [(tag, c.physics.output, c.gauge.config_file, c.gauge.random_seed)
              for tag, c in j_ensemble_members(j_load_config(path))]
    assert ours == theirs
    assert len(ours) == (1 if mode == "single" else 2)


def test_run_twop_main_matches_tpuqcd_over_its_ildg_files(tmp_path, monkeypatch):
    pytest.importorskip("h5py")
    import tpuqcd.cli.run_twop as j_run_twop
    tpuqcd_setup_gauge_phase_as_configured(monkeypatch)
    files = []
    for seed in (3, 5):
        files.append(str(tmp_path / f"conf{seed}.lime"))
        j_write_ildg_gauge(files[-1], gauge_full(LAT, seed), JLAT)
    ex = yaml.safe_load((ROOT / "examples/twop.yaml").read_text())
    # smearing is held by test_torch_twop.py; here the gauge input, at tpuqcd's cost
    physics = {**ex["physics"], "smear_n_ape": 0, "smear_n_gauss": 0,
               "meson_channels": ["pion"]}
    raw = {**ex, "gauge": {"dims": list(LAT.dims), "config_files": files}}
    j_path = _yaml(tmp_path, "j.yaml", {**raw, "physics": {
        **physics, "output": str(tmp_path / "j" / "twop.h5")}})
    t_path = _yaml(tmp_path, "t.yaml", {**raw, "physics": {
        **physics, "output": str(tmp_path / "t" / "twop.h5")}})
    os.makedirs(tmp_path / "j")
    monkeypatch.setattr(sys, "argv", ["run_twop", "--config", j_path, "--device", "cpu"])
    monkeypatch.delenv("TPUQCD_DEVICE_CONTRACT", raising=False)
    j_run_twop.main()
    run_twop.main(["--config", t_path, "--device", "cpu"])
    got = {}
    for tag in ("conf3", "conf5"):
        want = _h5_all(str(tmp_path / "j" / f"twop.{tag}.h5"))
        got[tag] = _h5_all(str(tmp_path / "t" / f"twop.{tag}.h5"))
        assert sorted(got[tag]) == sorted(want) and len(want) == 6
        for k, w in want.items():
            np.testing.assert_allclose(got[tag][k], w, rtol=1e-4, atol=1e-6 * np.abs(w).max(),
                                       err_msg=f"{tag} {k}")
    k = "twop/pion/sx0sy0sz0st0/mom_0_0_0"
    assert not np.allclose(got["conf3"][k], got["conf5"][k])


@pytest.mark.parametrize("name", ["twop_ensemble.yaml", "twop_ensemble_heatbath.yaml",
                                  "twop_ensemble_heatbath_mesh.yaml"])
def test_ensemble_examples_load_with_every_key(name):
    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v
    raw = yaml.safe_load((ROOT / "examples" / name).read_text())
    cfg = load_config(str(ROOT / "examples" / name))
    for section, keys in raw.items():
        for key, value in keys.items():
            assert getattr(getattr(cfg, section), key) == tup(value), (section, key)


def test_the_torchrun_chain_example_loads_as_in_tpuqcd():
    """examples/twop_ensemble_heatbath_mesh.yaml, a heatbath chain under
    torchrun: both packages read the same chain, mesh and physics, and its
    members (tags, files under heatbath_dir, outputs) are tpuqcd's."""
    path = str(ROOT / "examples" / "twop_ensemble_heatbath_mesh.yaml")
    cfg, jcfg = load_config(path), j_load_config(path)
    assert dataclasses.asdict(cfg.gauge) == dataclasses.asdict(jcfg.gauge)
    assert (cfg.mesh.nt, cfg.mesh.nz, cfg.mesh.ny) == (jcfg.mesh.nt, jcfg.mesh.nz,
                                                      jcfg.mesh.ny) == (2, 1, 1)
    for key in ("source_positions", "momenta", "projectors", "meson_channels", "output"):
        assert getattr(cfg.physics, key) == getattr(jcfg.physics, key), key
    assert cfg.gauge.heatbath_n_cfg == 2 and cfg.gauge.heatbath_beta is not None


def test_a_file_of_another_lattice_raises(tmp_path):
    """tpuqcd takes the lattice from the file, past the checks made on
    gauge.dims (MG blocks, dilute_t); the port refuses the mismatch."""
    path = str(tmp_path / "small.lime")
    j_write_ildg_gauge(path, gauge_full(SMALL, 1), lattices(SMALL.dims)[1])
    cfg = config_from_dict({"gauge": {"dims": list(LAT.dims), "config_file": path}})
    with pytest.raises(ConfigError, match="gauge.dims"):
        setup_gauge(cfg, CPU)
