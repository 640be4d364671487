"""Shared pieces of the port's mesh tests (tests/test_torch_*_mesh.py,
test_torch_sharded_clover.py): the numpy inputs handed to tpuqcd and to
the gloo workers of tests/_torch_mesh_worker.py, and torchrun."""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from tpuqcd.solve import make_clover_fields as j_make_clover_fields

from _torch_inputs import gauge_full, jax_gauge_pk, lattices, spinor_pk

ROOT = Path(__file__).resolve().parents[1]
LAT, JLAT = lattices((4, 4, 4, 8))
KAPPA, MU, CSW = 0.115, 0.08, 1.2
#: the meshes of the tests: (t) on 2 ranks, (t, z) and (t, y) on 4
MESHES = {"t": (2, 1, 1), "tz": (2, 2, 1), "ty": (2, 1, 2)}


def torchrun(nproc: int, *args, timeout: int = 300) -> subprocess.CompletedProcess:
    """``args`` under torchrun on ``nproc`` gloo ranks; --standalone lets the
    rendezvous bind a free port itself (a port picked here and closed
    before torchrun binds it can be taken in between by a concurrent job)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(nproc), *args]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout,
                       env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r


@functools.lru_cache(maxsize=None)
def inputs(antiperiodic_t: bool = True) -> dict:
    """The global inputs: a float32-valued gauge (float64 numpy) with the
    boundary phase, tpuqcd's clover construction of it (float32, inverses
    in complex64), a spinor, a two-parity source, three columns (one dict
    per boundary condition, shared: do not modify it)."""
    u32 = jax_gauge_pk(gauge_full(LAT, 120), JLAT, antiperiodic_t, jnp.float32)
    cl, clp, clm = (np.asarray(a) for a in
                    j_make_clover_fields(u32, JLAT, kappa=KAPPA, mu=MU, csw=CSW))
    cols = np.stack([spinor_pk(LAT, 123 + i, parities=2) for i in range(3)]).astype(np.float32)
    return dict(u=np.asarray(u32, np.float64), cl=cl, clp=clp, clm=clm,
                psi=spinor_pk(LAT, 121), b=spinor_pk(LAT, 122, parities=2).astype(np.float32),
                cols=cols, dims=np.array(LAT.dims), kappa=KAPPA, mu=MU,
                t_boundary=-1 if antiperiodic_t else 1)


def run_worker(tmp: Path, inp: dict, mesh, policy: str, tasks) -> dict:
    """tests/_torch_mesh_worker.py on the gloo ranks of ``mesh``; its results."""
    np.savez(tmp / "in.npz", **inp)
    torchrun(int(np.prod(mesh)), "tests/_torch_mesh_worker.py", "--inputs", str(tmp / "in.npz"),
             "--out", str(tmp / "out.npz"), "--mesh", *map(str, mesh), "--policy", policy,
             "--tasks", *tasks)
    return dict(np.load(tmp / "out.npz"))
