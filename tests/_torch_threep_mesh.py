"""Shared pieces of run_threeptwop's gloo-mesh tests (test_torch_threep_mesh.py
on (t), _tz.py on (t, z), _ty.py on (t, y): one torchrun launch of
tests/_torch_physics_mesh_worker.py a file, so that --dist loadfile runs
them on different workers); the tests are defined here and imported by
each file, which gives its mesh_run fixture.

run_threeptwop on a mesh of gloo ranks (torchrun,
tests/_torch_physics_mesh_worker.py): 2 ranks over t (fused faces), 4
over (t, z) (fused) and 4 over (t, y) (the overlap engine), at 4x4x4x8
with the source off the origin on a rank other than 0 and t_sink on
another t-block.

Piece by piece, each gathered on rank 0 for the test only and held to the
port's one-card function on the same float64 inputs to 1e-13 of the
largest value (float32 to 1e-6): the sequential sources of both legs
with a sink momentum (built on the ranks that hold t_sink), their
timeslice smearing, the covariant shifts in all four directions both
ways with and without conjugated links and the symmetric derivative
(faces in t, z and y), the ultra-local and one-derivative insertions,
projected.  Whole runs through run_threeptwop.main with every gather of
a field made to raise: every two- and three-point dataset equal to the
port's one-rank run within 1e-5 of the dataset's largest value (as in
tests/test_torch_twop_mesh.py: lockstep batches there, columns one at a
time here), every forward and backward column certified to 1e-10, rank
0 alone writing.  Cost: about 100 s serial (three torchrun launches, 25-43 s
each)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuqcd_torch.cli import run_threeptwop
from tpuqcd_torch.gammas import INSERTION_GAMMAS, PROJECTORS
from tpuqcd_torch.phys.propagator import sink_smear_timeslice_pk
from tpuqcd_torch.phys.threep_dev import (cov_deriv_sym_pk, cov_shift_pk, proton_seq_source_pk,
                                          threep_one_derivative_all_pk, threep_ultralocal_pk)
from tpuqcd_torch.utils.config import load_config

from _torch_inputs import gauge_full, jax_gauge_pk, lattices, t
from _torch_mesh import MESHES
from _torch_physics_mesh_worker import ALPHA, N_GAUSS, SNK_MOM, SRC, T_SINK, momenta
from _torch_twop_mesh import CPU, _yaml, assert_runs_agree, h5_all, run_mesh

LAT, JLAT = lattices((4, 4, 4, 8))
THREEP_RAW = {
    "gauge": {"dims": list(LAT.dims), "random_seed": 3},
    "action": {"kappa": 0.11, "mu": 0.07},
    "solver": {"tol": 1.0e-10, "backend": "xla"},
    "physics": {"source_positions": [list(SRC)], "t_sinks": [T_SINK], "projectors": ["P5z"],
                "baryons": ["proton"], "momenta": [[0, 0, 0], [1, 0, 0], [0, 1, 1]],
                "sink_momentum": list(SNK_MOM), "smear_n_ape": 1, "smear_alpha_ape": 0.5,
                "smear_n_gauss": 2, "smear_alpha_gauss": 1.0},
}


def _prop(rng) -> np.ndarray:
    return rng.standard_normal((2, 2, 4, 3, 4, 3, *LAT.site_shape))


@pytest.fixture(scope="module")
def pieces_inputs():
    rng = np.random.default_rng(7)
    u = jax_gauge_pk(gauge_full(LAT, 41), JLAT, True, jnp.float64)
    u_sm = jax_gauge_pk(gauge_full(LAT, 42), JLAT, False, jnp.float64)
    return dict(kind="threep", dims=np.array(LAT.dims), u=np.asarray(u), u_sm=np.asarray(u_sm),
                su=_prop(rng), sd=_prop(rng))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("one")
    cfg = load_config(_yaml(tmp / "one.yaml", THREEP_RAW, tmp / "one.h5"))
    run_threeptwop.write(cfg, run_threeptwop.measure(cfg, CPU))
    return h5_all(tmp / "one.h5")


def mesh_run_of(name, tmp_path_factory, pieces_inputs):
    """mesh_run's value on the mesh MESHES[name]: (name, mesh, run_mesh's dict)."""
    mesh = MESHES[name]
    out = run_mesh(tmp_path_factory.mktemp(f"threep_{name}"), mesh, "run_threeptwop",
                   THREEP_RAW, pieces_inputs)
    return name, mesh, out


def _close(got, want, rel, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=what)


def test_pieces_match_one_card(mesh_run, pieces_inputs):
    _, _, out = mesh_run
    p, inp = out["pieces"], pieces_inputs
    u, u_sm, su, sd = (t(inp[k]) for k in ("u", "u_sm", "su", "sd"))
    xyz = (SRC[3], SRC[2], SRC[1])
    for leg in ("u", "d"):
        seq = proton_seq_source_pk(su, sd, T_SINK, leg, LAT, PROJECTORS["P5z"], SNK_MOM, xyz)
        _close(p[f"seq_{leg}"], seq.numpy(), 1e-13, leg)
        assert np.abs(seq.numpy()).max() > 0
    _close(p["seq_smear"], sink_smear_timeslice_pk(u_sm, seq, LAT, T_SINK, ALPHA,
                                                   N_GAUSS).numpy(), 1e-13, "seq_smear")
    for nu in range(4):
        for sign in (1, -1):
            for conj in (False, True):
                key = f"shift_{nu}{'+' if sign > 0 else '-'}{'c' if conj else 'n'}"
                _close(p[key], cov_shift_pk(u, su, nu, sign, LAT, conj).numpy(), 1e-13, key)
        _close(p[f"deriv_f32_{nu}"], cov_deriv_sym_pk(u.float(), su.float(), nu, LAT).numpy(),
               1e-6, f"deriv {nu}")
    mom = momenta()[:3]
    ul = threep_ultralocal_pk(sd, su, INSERTION_GAMMAS, LAT, mom, SRC)
    _close(p["ultralocal"], torch.stack(list(ul.values())).numpy(), 1e-13, "ultralocal")
    od = threep_one_derivative_all_pk(sd, su, u, LAT, mom, SRC)
    _close(p["onederiv"], torch.stack(list(od.values())).numpy(), 1e-13, "onederiv")


def test_run_threeptwop_on_the_mesh_matches_one_rank(mesh_run, reference):
    _, _, out = mesh_run
    assert any(k.startswith("threep_der/") for k in reference)
    assert_runs_agree(out["h5"], reference)


def test_every_column_is_certified_and_rank_0_alone_writes(mesh_run):
    _, mesh, out = mesh_run
    ranks = out["ranks"]
    assert len(ranks) == int(np.prod(mesh))
    for r in ranks:
        # 12 forward columns a flavor, 12 backward a leg (u and d of the proton)
        assert r["relres"].max() <= 1e-10 and r["columns"].sum() == 48
        assert {"seq_sources", "seq_smearing", "solves_bwd", "insertions",
                "derivatives"} <= set(r["stages"])
    # the proton's two-point group and its two legs' threep and threep_der groups
    assert int(ranks[0]["written"]) == 5
    assert all(int(r["written"]) == 0 for r in ranks[1:])
