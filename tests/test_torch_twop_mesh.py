"""run_twop on a mesh of gloo ranks (torchrun, tests/_torch_physics_mesh_worker.py):
2 ranks over t (fused faces) here; 4 over (t, z) (fused) in
test_torch_twop_mesh_tz.py and 4 over (t, y) (the overlap engine) in
test_torch_twop_mesh_ty.py, at 4x4x4x8 with the source off the origin on a
rank other than 0.  The pieces and whole runs of every mesh are checked
by the tests of tests/_torch_twop_mesh.py; the (t) run is also held to
tpuqcd's run_twop.main on one device, on a gauge file tpuqcd wrote,
within test_torch_twop.py's limits (rtol 1e-4, atol 1e-6 of the largest
value).

The same launch runs a heatbath chain under torchrun (gauge.heatbath_n_cfg
2, cli/common._heatbath_chain_members: every rank generates the chain,
rank 0 writes each member, one all-reduce after each write): its member
files byte for byte the one-process chain's, each member's correlators
equal to run_twop.main's in one process within the mesh runs' limit
(1e-5 of each dataset's largest value), every column of both members
certified; and the chain made to fail on rank 0 (its directory) and on
rank 1 (a member's plaquette), each raising on both ranks.
Cost: about 70 s serial (one torchrun launch, the one-process chain run,
tpuqcd's run_twop once, 45 s)."""
import os
import sys

import numpy as np
import pytest

from tpuqcd_torch.cli import run_twop

from _torch_twop_mesh import (LAT, TWOP_RAW, _yaml, assert_runs_agree, gauge_file, h5_all,  # noqa: F401
                              mesh_run_of, pieces_inputs, reference,
                              test_every_column_is_certified_and_rank_0_alone_writes,
                              test_pieces_match_one_card,
                              test_run_twop_on_the_mesh_matches_one_rank)

pytestmark = pytest.mark.minutes

#: a two-member heatbath chain at 4x4x4x8 (the mesh runs' action and
#: physics), its files under gauge.heatbath_dir
CHAIN_GAUGE = {"dims": list(LAT.dims), "heatbath_beta": 6.0, "heatbath_sweeps": 2,
               "heatbath_n_cfg": 2, "heatbath_skip": 1, "random_seed": 4}
MEMBERS = ("c0000", "c0001")
FILES = ("hb_b6_0000.lime", "hb_b6_0001.lime")


def chain_raw(ens_dir) -> dict:
    return {**TWOP_RAW, "gauge": {**CHAIN_GAUGE, "heatbath_dir": str(ens_dir)}}


@pytest.fixture(scope="module", params=["t"])
def mesh_run(request, tmp_path_factory, pieces_inputs, gauge_file):
    tmp = tmp_path_factory.mktemp("chain_mesh")
    (tmp / "a_file").write_text("")
    failing = _yaml(tmp / "failing.yaml", chain_raw(tmp / "a_file" / "ensemble"),
                    tmp / "failing.h5")
    name, mesh, out = mesh_run_of(request.param, tmp_path_factory, pieces_inputs, gauge_file,
                                  chain=chain_raw(tmp / "ensemble"), chain_failures=failing)
    out["ensemble"] = tmp / "ensemble"
    return name, mesh, out


@pytest.fixture(scope="module")
def one_process_chain(tmp_path_factory):
    """run_twop.main over the chain in one process: its directory (the
    member files under ensemble/, the outputs chain.<ctag>.h5)."""
    tmp = tmp_path_factory.mktemp("chain_one")
    run_twop.main(["--config", _yaml(tmp / "one.yaml", chain_raw(tmp / "ensemble"),
                                     tmp / "chain.h5"), "--device", "cpu"])
    return tmp


def test_a_heatbath_chain_under_torchrun_writes_the_one_process_files(mesh_run,
                                                                     one_process_chain):
    _, _, out = mesh_run
    assert sorted(os.listdir(out["ensemble"])) == list(FILES)
    for name in FILES:
        assert (out["ensemble"] / name).read_bytes() == \
            (one_process_chain / "ensemble" / name).read_bytes(), name


def test_a_heatbath_chain_under_torchrun_matches_the_one_process_run(mesh_run,
                                                                    one_process_chain):
    _, mesh, out = mesh_run
    runs = {ctag: (h5_all(out["tmp"] / f"chain.{ctag}.h5"),
                   h5_all(one_process_chain / f"chain.{ctag}.h5")) for ctag in MEMBERS}
    for got, want in runs.values():
        assert_runs_agree(got, want)
    a, b = (runs[ctag][1] for ctag in MEMBERS)
    assert any(not np.allclose(a[k], b[k]) for k in a)       # two gauges, two results
    ranks = out["chain"]
    assert len(ranks) == int(np.prod(mesh))
    for r in ranks:
        assert int(r["members"]) == 2
        assert r["relres"].max() <= 1e-10 and r["columns"].sum() == 2 * 24
    assert int(ranks[0]["written"]) == 2 * len(runs["c0000"][1]) // 3
    assert all(int(r["written"]) == 0 for r in ranks[1:])


def test_a_chain_failure_on_any_rank_raises_on_every_rank(mesh_run):
    """Rank 0 cannot create the chain's directory: it raises its OSError,
    rank 1 a RuntimeError naming the step; rank 1's plaquette raises: it
    raises its own error, rank 0 a RuntimeError.  Neither waits for a file
    that is never written (the launch would time out)."""
    _, _, out = mesh_run
    raised = [{k: str(v) for k, v in r.items()} for r in out["failures"]]
    assert raised[0]["dir"] in ("FileExistsError", "NotADirectoryError")
    assert raised[1]["dir"] == "RuntimeError"
    assert raised[0]["member"] == "RuntimeError" and raised[1]["member"] == "ValueError"


@pytest.mark.parametrize("mesh_run", ["t"], indirect=True)
def test_the_t_mesh_run_matches_tpuqcd(mesh_run, tmp_path, monkeypatch, gauge_file):
    """tpuqcd's run_twop.main on one device, with its setup_gauge applying
    the configured boundary phase (tests/_torch_inputs.py), against the
    run over t."""
    _, _, out = mesh_run
    import tpuqcd.cli.run_twop as j_run_twop
    from _torch_inputs import tpuqcd_setup_gauge_phase_as_configured
    tpuqcd_setup_gauge_phase_as_configured(monkeypatch)
    path = _yaml(tmp_path / "j.yaml", TWOP_RAW, tmp_path / "j.h5", gauge_file=gauge_file)
    monkeypatch.setattr(sys, "argv", ["run_twop", "--config", path])
    monkeypatch.delenv("TPUQCD_DEVICE_CONTRACT", raising=False)
    j_run_twop.main()
    want = h5_all(tmp_path / "j.h5")
    assert sorted(out["h5"]) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(out["h5"][k], w, rtol=1e-4, atol=1e-6 * np.abs(w).max(),
                                   err_msg=k)
