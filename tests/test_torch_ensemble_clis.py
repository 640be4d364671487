"""The port's four programs over ensembles (their main loops over
cli/common.ensemble_members), on the CPU.

run_invert, run_threeptwop and run_loops over two ILDG files: one result
per member (an output file of its own, '<root>.<file stem><ext>'; for
run_invert the solution), each equal bit for bit to the run with that
file as gauge.config_file.  run_twop over random_seeds: the member equals
the single run with that seed bit for bit.  run_twop over a heatbath
chain: the members' files under heatbath_dir and one output each.
About 30 s serial."""
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from tpuqcd_torch.cli import run_invert, run_loops, run_threeptwop, run_twop
from tpuqcd_torch.io.lime import write_ildg_gauge
from tpuqcd_torch.lattice import Lattice

from _torch_inputs import gauge_full

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _h5_all(path):
    h5py = pytest.importorskip("h5py")
    vals = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: vals.__setitem__(name, np.asarray(obj))
                     if isinstance(obj, h5py.Dataset) else None)
    return vals


def _example(name, tmp_path, gauge=None, **physics):
    """An example config with gauge keys replaced and physics keys added,
    written to tmp_path; returns its path."""
    raw = yaml.safe_load((ROOT / "examples" / name).read_text())
    raw["gauge"] = {**{k: v for k, v in raw["gauge"].items() if k != "random_seed"},
                    **(gauge or {})}
    raw["physics"] = {**raw.get("physics", {}), **physics}
    path = tmp_path / f"cfg{len(list(tmp_path.glob('cfg*.yaml')))}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path), raw


def _files(tmp_path, dims, seeds=(3, 5)):
    lat = Lattice(tuple(dims))
    paths = []
    for s in seeds:
        paths.append(str(tmp_path / f"cfg{s}.lime"))
        write_ildg_gauge(paths[-1], torch.from_numpy(gauge_full(lat, s)), lat)
    return paths


@pytest.mark.parametrize("module,example", [(run_threeptwop, "threep.yaml"),
                                            (run_loops, "loops.yaml")],
                         ids=["run_threeptwop", "run_loops"])
def test_each_member_writes_the_single_config_file_run(tmp_path, module, example):
    dims = yaml.safe_load((ROOT / "examples" / example).read_text())["gauge"]["dims"]
    files = _files(tmp_path, dims)
    out = str(tmp_path / "ens" / "out.h5")
    ens, _ = _example(example, tmp_path, {"config_files": files}, output=out)
    module.main(["--config", ens, "--device", "cpu"])
    for f in files:
        stem = Path(f).stem
        one, _ = _example(example, tmp_path, {"config_file": f},
                          output=str(tmp_path / f"one.{stem}.h5"))
        module.main(["--config", one, "--device", "cpu"])
        got = _h5_all(str(tmp_path / "ens" / f"out.{stem}.h5"))
        want = _h5_all(str(tmp_path / f"one.{stem}.h5"))
        assert sorted(got) == sorted(want) and len(want) > 0
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{stem} {k}")
    a, b = (_h5_all(str(tmp_path / "ens" / f"out.{Path(f).stem}.h5")) for f in files)
    assert any(not np.array_equal(a[k], b[k]) for k in a)


def test_run_invert_solves_each_member_as_its_single_run(tmp_path, monkeypatch, capsys):
    files = _files(tmp_path, (4, 4, 4, 8))
    ens, _ = _example("invert.yaml", tmp_path, {"config_files": files})
    seen = []
    real = run_invert.invert

    def spy(cfg, device, gauge=None):
        res = real(cfg, device, gauge)
        seen.append((cfg.gauge.config_file, res))
        return res
    monkeypatch.setattr(run_invert, "invert", spy)
    run_invert.main(["--config", ens, "--device", "cpu"])
    assert [f for f, _ in seen] == files
    assert capsys.readouterr().out.count("RESULT solve_seconds=") == 2
    monkeypatch.undo()
    from tpuqcd_torch.utils.config import load_config
    for f, res in seen:
        one, _ = _example("invert.yaml", tmp_path, {"config_file": f})
        single = real(load_config(one), CPU)
        assert res.relres <= 1e-10 and torch.equal(res.x, single.x)
        assert res.plaquette == single.plaquette
    assert seen[0][1].plaquette != seen[1][1].plaquette


def test_random_seeds_member_is_the_single_run(tmp_path):
    out = str(tmp_path / "twop.h5")
    ens, raw = _example("twop.yaml", tmp_path, {"random_seeds": [3, 5]}, output=out)
    run_twop.main(["--config", ens, "--device", "cpu"])
    one, _ = _example("twop.yaml", tmp_path, {"random_seed": 5},
                      output=str(tmp_path / "one.h5"))
    run_twop.main(["--config", one, "--device", "cpu"])
    got, want = _h5_all(str(tmp_path / "twop.s5.h5")), _h5_all(str(tmp_path / "one.h5"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    other = _h5_all(str(tmp_path / "twop.s3.h5"))
    assert not np.array_equal(other[k], want[k])


def test_run_twop_over_a_heatbath_chain(tmp_path):
    out = str(tmp_path / "run" / "twop.h5")
    hb = str(tmp_path / "hb")
    cfg, _ = _example("twop.yaml", tmp_path, {
        "heatbath_beta": 6.0, "heatbath_sweeps": 2, "heatbath_n_cfg": 2,
        "heatbath_skip": 1, "heatbath_dir": hb}, output=out, smear_n_gauss=1)
    run_twop.main(["--config", cfg, "--device", "cpu"])
    assert sorted(p.name for p in Path(hb).iterdir()) == ["hb_b6_0000.lime", "hb_b6_0001.lime"]
    a, b = (_h5_all(str(tmp_path / "run" / f"twop.c000{i}.h5")) for i in (0, 1))
    k = "twop/pion/sx0sy0sz0st0/mom_0_0_0"
    assert np.isfinite(a[k]).all() and not np.array_equal(a[k], b[k])
