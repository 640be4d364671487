"""The judge against a broken program: a run driven through the harness
(without the look for a card) with the timed path broken underneath comes
out not correct, for each fault these cells can have: a solve that returns
its state unchanged, half of a lockstep batch left out, an answer altered
where it is produced (a solution, a smeared source, a correlator), a
column left out, reordered or swapped for another source before the audit
sees it; and the control (the reference one precision lower in the
program's place) comes out not correct too.  One card a cell: no exchange between chips to leave
out."""
from __future__ import annotations

import pytest
import torch

from qcdbench.tests.small import rehearse


def _wrap_batch(monkeypatch, change):
    import tpuqcd_torch.solve as solve
    orig = solve.solve_tm_mg_batch

    def broken(mg, b_pks, **kw):
        res = orig(mg, b_pks, **kw)
        return res._replace(x=change(res.x))
    monkeypatch.setattr(solve, "solve_tm_mg_batch", broken)


def test_unchanged_state(monkeypatch):
    _wrap_batch(monkeypatch, torch.zeros_like)
    res, checks = rehearse("mg_nearcrit_32c64.point")
    assert res["correct"] is False and checks["relres"]["value"] > checks["relres"]["limit"]


def test_half_batch_left_out(monkeypatch):
    def half(x):
        x = x.clone()
        x[x.shape[0] // 2:] = 0
        return x
    _wrap_batch(monkeypatch, half)
    res, checks = rehearse("mg_nearcrit_32c64.lockstep4")
    assert res["correct"] is False and checks["relres"]["value"] > checks["relres"]["limit"]


def test_answer_altered(monkeypatch):
    def nudge(x):
        x = x.clone(memory_format=torch.contiguous_format)
        x.view(-1)[0] += 1e-6 * x.abs().max()
        return x
    _wrap_batch(monkeypatch, nudge)
    res, checks = rehearse("mg_nearcrit_32c64.point")
    assert res["correct"] is False and checks["relres"]["value"] > checks["relres"]["limit"]


def _drop_last(orig):
    """The batch's last column never reaches the solver or the audit; its
    place in the returned solutions is filled by the column before it."""
    def broken(self, b_pks, flavor, first_column):
        x = orig(self, b_pks[:-1], flavor, first_column)
        return torch.cat([x, x[-1:]])
    return broken


def _reorder(orig):
    """Solved and audited right, returned in reverse order."""
    def broken(self, b_pks, flavor, first_column):
        return orig(self, b_pks, flavor, first_column).flip(0)
    return broken


def _other_source(orig):
    """Another source solved (the spec's moved one site along x) and audited
    as if it were the spec's."""
    def broken(self, b_pks, flavor, first_column):
        return orig(self, b_pks.roll(1, dims=-1), flavor, first_column)
    return broken


def _swap_flavor(orig):
    def broken(self, b_pks, flavor, first_column):
        return orig(self, b_pks, -flavor, first_column)
    return broken


@pytest.mark.parametrize("fault, number", [(_drop_last, "columns_off"), (_reorder, "x_gap"),
                                           (_other_source, "columns_off"),
                                           (_swap_flavor, "columns_off")])
def test_column_faults_under_the_audit(monkeypatch, fault, number):
    """Faults at the Solver layer that leave every audited residual sound:
    only the check of the audited columns against the spec's, and of the
    returned solutions against the audited ones, sees them."""
    from tpuqcd_torch.cli.common import Solver
    monkeypatch.setattr(Solver, "_batch", fault(Solver._batch))
    res, checks = rehearse("mg_nearcrit_32c64.lockstep4")
    assert res["correct"] is False and checks[number]["value"] > checks[number]["limit"]


@pytest.mark.parametrize("where, number", [("project_momenta_pk", "corr_gap"),
                                           ("smeared_sources", "source_gap"),
                                           ("assemble_propagator_pk", "corr_gap")])
def test_twop_output_altered(monkeypatch, where, number):
    import tpuqcd_torch.cli.run_twop as run_twop
    orig = getattr(run_twop, where)

    def broken(*a, **kw):
        return orig(*a, **kw) * 1.001
    monkeypatch.setattr(run_twop, where, broken)
    res, checks = rehearse("twop_32c64.source")
    assert res["correct"] is False and checks[number]["value"] > checks[number]["limit"]


def test_twop_unchanged_state(monkeypatch):
    import tpuqcd_torch.solve as solve
    orig = solve.solve_tm_batch

    def broken(*a, **kw):
        res = orig(*a, **kw)
        return res._replace(x=torch.zeros_like(res.x))
    monkeypatch.setattr(solve, "solve_tm_batch", broken)
    res, checks = rehearse("twop_32c64.source")
    assert res["correct"] is False and checks["relres"]["value"] > checks["relres"]["limit"]


@pytest.mark.parametrize("cell, numbers", [
    ("mg_nearcrit_32c64.point", {"relres"}),
    ("twop_32c64.source", {"relres", "odd_res", "source_gap", "corr_gap"})])
def test_control_fails(cell, numbers):
    """The control fails every number of precision; the exact checks of
    which columns were solved (columns_off, x_gap) stay the program's."""
    res, checks = rehearse(cell, control=True)
    assert res["correct"] is False
    assert {k for k, c in checks.items() if c["value"] > c["limit"]} == numbers
