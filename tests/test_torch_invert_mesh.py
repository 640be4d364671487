"""run_invert on a mesh, the user's path: torchrun, two CPU ranks over
gloo, with twisted mass (fused faces along T), with twisted clover and
multigrid (the overlap engine along T) and on a y-sharded mesh (comm_policy
auto takes the overlap engine); and which configurations the programs
take on a mesh: every program all of them, the mass sweep too (run_loops
since the loop run came to the mesh).  Cost: about 45 s
serial (three torchrun launches)."""
import re

import pytest

from tpuqcd_torch.cli.common import check_in_slice
from tpuqcd_torch.utils.config import ConfigError, config_from_dict, load_config

from _torch_mesh import ROOT, torchrun


@pytest.mark.parametrize("example,policy", [("invert_mesh.yaml", "fused"),
                                            ("invert_clover_mg_mesh.yaml", "overlap"),
                                            ("invert_mesh_y.yaml", "overlap")],
                         ids=["tm-t", "clover-mg-t", "tm-y"])
def test_run_invert_on_two_gloo_ranks(example, policy):
    """Rank 0 alone prints the RESULT line, certified to the tolerance by
    the unsharded float64 operator on the gathered x."""
    cfg = load_config(str(ROOT / "examples" / example))
    r = torchrun(2, "-m", "tpuqcd_torch.cli.run_invert", "--config", f"examples/{example}",
                 "--device", "cpu")
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    assert len(lines) == 1, r.stdout[-2000:]
    fields = dict(kv.split("=", 1) for kv in re.findall(r"\w+=\S+", lines[0]))
    assert float(fields["relres"]) <= cfg.solver.tol
    m = cfg.mesh
    assert fields["mesh"] == f"{m.nt}x{m.nz}x{m.ny}" and fields["comm_policy"] == policy


MESH_CONFIGS = {
    "tm": {"mesh": {"nt": 2}},
    "clover": {"mesh": {"nt": 2}, "action": {"csw": 1.0}},
    "mg": {"mesh": {"nt": 2}, "mg": {"enabled": True, "block": [[2, 2, 2, 2]]}},
    "mg-clover": {"mesh": {"nt": 2}, "action": {"csw": 1.0},
                  "mg": {"enabled": True, "block": [[2, 2, 2, 2]]}},
    "eigcg": {"mesh": {"nt": 2, "nz": 2}, "solver": {"solver": "eigcg"}},
    "y": {"mesh": {"nt": 2, "ny": 2}},
    "overlap": {"mesh": {"nt": 2}, "solver": {"comm_policy": "overlap"}},
    "ndeg-y": {"mesh": {"ny": 2}, "action": {"epsbar": 0.1, "mubar": 0.2}},
}


@pytest.mark.parametrize("name", list(MESH_CONFIGS))
def test_run_invert_takes_a_mesh_and_the_physics_programs_refuse_it(name):
    """Every program takes every mesh configuration: run_invert, run_twop,
    run_threeptwop (tests/test_torch_twop_mesh.py and
    test_torch_threep_mesh.py run them on gloo ranks) and, since the loop
    run came to the mesh, run_loops (tests/test_torch_run_loops_mesh.py);
    the three-point run still refuses a configuration without t_sinks."""
    raw = {"gauge": {"dims": [4, 4, 4, 8]}, "physics": {"t_sinks": [2]}, **MESH_CONFIGS[name]}
    cfg = config_from_dict(raw)
    check_in_slice(cfg)
    check_in_slice(cfg, threep=True)
    with pytest.raises(ConfigError, match="t_sinks is empty"):
        check_in_slice(config_from_dict({**raw, "physics": {}}), threep=True)


def test_the_mass_sweep_stays_refused_on_a_mesh():
    """Since the mass sweep came, run_invert takes it on a mesh
    (tests/test_torch_musweep_mesh.py runs it); since the loop run came to
    the mesh, every program takes the mesh (the physics programs read no
    mu_list, as in tpuqcd)."""
    cfg = config_from_dict({"gauge": {"dims": [4, 4, 4, 8]}, "mesh": {"nt": 2},
                            "physics": {"t_sinks": [2]}, "action": {"mu_list": [0.01, 0.02]}})
    check_in_slice(cfg)
    check_in_slice(cfg, threep=True)
    assert tuple(cfg.action.mu_list) == (0.01, 0.02)
