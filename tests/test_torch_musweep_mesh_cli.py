"""run_invert's CLI with action.mu_list (examples/invert_musweep_mesh.yaml's
sweep) under torchrun on 2 gloo ranks, over t (fused) and over y
(overlap): one launch each, in a file apart from the sweep's worker tests
(tests/test_torch_musweep_mesh.py) so that --dist loadfile spreads them.
Cost: about 20 s serial."""
import re

import pytest

from _torch_mesh import ROOT, torchrun


@pytest.mark.parametrize("mesh,policy", [({"nt": 2}, "fused"), ({"ny": 2}, "overlap")],
                         ids=["t-fused", "y-overlap"])
def test_run_invert_sweep_on_two_gloo_ranks(mesh, policy, tmp_path):
    """The user's path: torchrun of run_invert with examples/invert_musweep_mesh.yaml's
    sweep; rank 0 alone prints the RESULT line, every mass certified by the
    unsharded float64 operator on the gathered x."""
    import yaml
    raw = yaml.safe_load((ROOT / "examples/invert_musweep_mesh.yaml").read_text())
    raw["mesh"] = mesh
    path = tmp_path / "sweep_mesh.yaml"
    path.write_text(yaml.safe_dump(raw))
    r = torchrun(2, "-m", "tpuqcd_torch.cli.run_invert", "--config", str(path), "--device",
                 "cpu")
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    assert len(lines) == 1, r.stdout[-2000:]
    f = dict(kv.split("=", 1) for kv in re.findall(r"\w+=\S+", lines[0]))
    rel = [float(v) for v in f["relres"].split(",")]
    assert len(rel) == len(raw["action"]["mu_list"]) and max(rel) <= raw["solver"]["tol"]
    assert f["comm_policy"] == policy and int(f["multishift_iters"]) > 0
