"""Shared pieces of run_twop's gloo-mesh tests (test_torch_twop_mesh.py on
(t), _tz.py on (t, z), _ty.py on (t, y): one torchrun launch of
tests/_torch_physics_mesh_worker.py a file, so that pytest-xdist's
--dist loadfile runs them on different workers).  The tests of every mesh
are defined here and imported by each file, which gives its mesh_run
fixture: the worker on that mesh, the pieces and the whole run.

Piece by piece, each gathered on rank 0 for the test only and held to the
port's one-card function on the same inputs: the Gaussian smearing and
one spatial hop (float64 inputs to 1e-13, float32 to 1e-6 of the largest
value), the point sources (exactly), the momentum projection by the phase
sum and, on the t-only mesh, by the FFT (1e-13; a mesh with z or y split
refuses fft=True).  Whole runs through run_twop.main with every gather of
a field made to raise: every dataset equal to the port's one-rank run
within 1e-5 of the dataset's largest value (the one-rank run solves the
columns in lockstep batches, the mesh one at a time with sums over the
ranks: float32 x differs near 1e-7), every column certified to 1e-10,
rank 0 alone writing tpuqcd's dataset names."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tpuqcd_torch.cli import run_twop
from tpuqcd_torch.phys.propagator import packed_sources, point_sources
from tpuqcd_torch.phys.smear import cov_laplace_3d_pk, gaussian_smear_pk
from tpuqcd_torch.phys.threep_dev import project_momenta_pk
from tpuqcd_torch.utils.config import load_config

from _torch_inputs import gauge_full, jax_gauge_pk, lattices, spinor_pk, t
from _torch_mesh import MESHES, torchrun
from _torch_physics_mesh_worker import ALPHA, N_GAUSS, SRC, momenta

LAT, JLAT = lattices((4, 4, 4, 8))
CPU = torch.device("cpu")
#: the whole runs' limit, relative to each dataset's largest value
RUN_ATOL = 1e-5
#: the runs' gauge: an ILDG file tpuqcd writes (gauge_file), so that tpuqcd
#: reads the same links
TWOP_RAW = {
    "gauge": {"dims": list(LAT.dims)},
    "action": {"kappa": 0.115, "mu": 0.08},
    "solver": {"tol": 1.0e-10, "backend": "xla"},
    "physics": {"source_positions": [list(SRC)], "momenta": [[0, 0, 0], [1, 0, 0], [0, 1, 1]],
                "smear_alpha_ape": 0.5, "smear_n_ape": 2, "smear_alpha_gauss": 1.0,
                "smear_n_gauss": 4, "projectors": ["P+"],
                "meson_channels": ["pion", "rho_x"]},
}


def _yaml(path, raw, output, mesh=None, gauge_file=None) -> str:
    raw = {**raw, "physics": {**raw["physics"], "output": str(output)}}
    if gauge_file is not None:
        raw["gauge"] = {**raw["gauge"], "config_file": str(gauge_file)}
    if mesh is not None:
        raw["mesh"] = dict(zip(("nt", "nz", "ny"), mesh))
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def h5_all(path) -> dict:
    import h5py
    vals = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: vals.__setitem__(name, np.asarray(obj))
                     if isinstance(obj, h5py.Dataset) else None)
    return vals


def run_mesh(tmp, mesh, main, raw, pieces=None, gauge_file=None, chain=None,
             chain_failures=None) -> dict:
    """The worker on the ranks of ``mesh``: the pieces of ``pieces`` (a dict
    of inputs), with ``chain_failures`` (a configuration's path) the
    worker's failing heatbath chains, then ``main`` on ``raw`` with the
    mesh and, with ``chain`` (a configuration of a heatbath chain, a dict),
    on ``chain`` with the mesh (output tmp/chain.h5, one file a member, as
    ensemble_members names them); returns the pieces, each rank's record
    and the output file's datasets (and "chain": each rank's record,
    "failures": what each rank raised)."""
    n_ranks = int(np.prod(mesh))
    configs = [_yaml(tmp / "cfg.yaml", raw, tmp / "mesh.h5", mesh, gauge_file)]
    if chain is not None:
        configs.append(_yaml(tmp / "chain.yaml", chain, tmp / "chain.h5", mesh))
    args = ["--mesh", *map(str, mesh), "--out", str(tmp / "out.npz"), "--main", main,
            "--config", *configs]
    if pieces is not None:
        np.savez(tmp / "in.npz", **pieces)
        args += ["--pieces", str(tmp / "in.npz")]
    if chain_failures is not None:
        args += ["--chain-failures", chain_failures]
    torchrun(n_ranks, "tests/_torch_physics_mesh_worker.py", *args)
    first = "out.{}.npz" if chain is None else "out.0.{}.npz"
    out = {"pieces": dict(np.load(tmp / "out.npz")) if pieces is not None else {},
           "ranks": [dict(np.load(tmp / first.format(r))) for r in range(n_ranks)],
           "h5": h5_all(tmp / "mesh.h5"), "tmp": tmp}
    if chain is not None:
        out["chain"] = [dict(np.load(tmp / f"out.1.{r}.npz")) for r in range(n_ranks)]
    if chain_failures is not None:
        out["failures"] = [dict(np.load(tmp / f"out.failures.{r}.npz")) for r in range(n_ranks)]
    return out


def one_rank(tmp, raw, gauge_file=None) -> dict:
    """The port's run on one card (no mesh): its output file's datasets."""
    cfg = load_config(_yaml(tmp / "one.yaml", raw, tmp / "one.h5", gauge_file=gauge_file))
    run_twop.write(cfg, run_twop.measure(cfg, CPU))
    return h5_all(tmp / "one.h5")


def assert_runs_agree(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want) and want
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=RUN_ATOL * np.abs(w).max(), err_msg=k)


@pytest.fixture(scope="module")
def pieces_inputs():
    rng = np.random.default_rng(5)
    u_sm = jax_gauge_pk(gauge_full(LAT, 31), JLAT, False, jnp.float64)
    cols = np.stack([spinor_pk(LAT, 32 + i, parities=2) for i in range(2)])
    return dict(kind="twop", dims=np.array(LAT.dims), u_sm=np.asarray(u_sm), cols=cols,
                dens=rng.standard_normal((2, 2, *LAT.site_shape)))


@pytest.fixture(scope="module")
def gauge_file(tmp_path_factory):
    from tpuqcd.io.lime import write_ildg_gauge as j_write_ildg_gauge
    path = tmp_path_factory.mktemp("gauge") / "conf.lime"
    j_write_ildg_gauge(str(path), gauge_full(LAT, 2), JLAT)
    return path


@pytest.fixture(scope="module")
def reference(tmp_path_factory, gauge_file):
    return one_rank(tmp_path_factory.mktemp("one"), TWOP_RAW, gauge_file)


def mesh_run_of(name, tmp_path_factory, pieces_inputs, gauge_file, **kw):
    """mesh_run's value on the mesh MESHES[name]: (name, mesh, run_mesh's dict)."""
    mesh = MESHES[name]
    out = run_mesh(tmp_path_factory.mktemp(f"twop_{name}"), mesh, "run_twop", TWOP_RAW,
                   pieces_inputs, gauge_file, **kw)
    return name, mesh, out


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def test_pieces_match_one_card(mesh_run, pieces_inputs):
    name, mesh, out = mesh_run
    p, inp = out["pieces"], pieces_inputs
    u_sm, cols = t(inp["u_sm"]), t(inp["cols"])
    _close(p["smear_f64"], gaussian_smear_pk(u_sm, cols, LAT, ALPHA, N_GAUSS).numpy(), 1e-13)
    _close(p["smear_f32"], gaussian_smear_pk(u_sm.float(), cols.float(), LAT, ALPHA,
                                             N_GAUSS).numpy(), 1e-6)
    _close(p["laplace"], cov_laplace_3d_pk(u_sm, cols, LAT).numpy(), 1e-13)
    want = packed_sources(point_sources(LAT, SRC), LAT).numpy()
    np.testing.assert_array_equal(p["sources"], want)
    assert np.count_nonzero(want) == 12
    xyz, dens = (SRC[3], SRC[2], SRC[1]), t(inp["dens"])
    phase = project_momenta_pk(dens, LAT, momenta(), xyz, fft=False).numpy()
    _close(p["proj"], phase, 1e-13)
    if mesh[1] == mesh[2] == 1:
        fft = project_momenta_pk(dens, LAT, momenta(), xyz, fft=True).numpy()
        _close(p["proj_fft"], fft, 1e-13)
        _close(fft, phase, 1e-13)
    else:
        assert str(p["proj_fft"]) == "refused"


def test_run_twop_on_the_mesh_matches_one_rank(mesh_run, reference):
    _, _, out = mesh_run
    assert_runs_agree(out["h5"], reference)


def test_every_column_is_certified_and_rank_0_alone_writes(mesh_run, reference):
    _, mesh, out = mesh_run
    ranks = out["ranks"]
    assert len(ranks) == int(np.prod(mesh))
    for r in ranks:
        assert r["relres"].max() <= 1e-10 and r["columns"].sum() == 24
        assert set(r["stages"]) == {"gauge", "smearing", "sources", "solves_u", "solves_d",
                                    "sink_smearing", "contractions", "projection"}
    # one dataset group per correlator, three momenta each, all from rank 0
    assert int(ranks[0]["written"]) * 3 == len(reference)
    assert all(int(r["written"]) == 0 for r in ranks[1:])


