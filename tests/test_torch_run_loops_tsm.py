"""The loop run with TSM and deflation against tpuqcd's, as
test_torch_run_loops.py holds the plain and the clover run (the same
stand-ins, tests/_torch_loops_run.py): two cheap noises of truncated
solves (8 steps, tol 1e-3) beside the correction noise, and four Lanczos
modes.  The cheap solves are each package's own truncated CG (the
port's is held to tpuqcd's solve_tm by test_torch_loops.py).  Every
dataset within 1e-4 of its largest value.  Serial cost about 45 s, most
of it tpuqcd's XLA compile of its batched solve."""
import pytest

from _torch_loops_run import check_basis, check_columns_and_stages, check_datasets, run_both

pytest.importorskip("h5py")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return run_both("tsm_deflation", tmp_path_factory.mktemp("tsm_deflation"))


def test_every_dataset_matches_tpuqcd(both):
    ref, got, _, cfg, _ = both
    check_datasets("tsm_deflation", ref, got, cfg)


def test_every_column_is_certified_and_the_stages_timed(both):
    _, _, res, cfg, audited = both
    check_columns_and_stages(res, cfg, audited)
    assert res.tsm["full"].keys() == res.tsm["cheap"].keys() == res.loops["loops/oneend"].keys()


def test_deflation_basis_is_orthonormal_and_saved(both):
    _, _, res, cfg, _ = both
    check_basis(res, cfg)
