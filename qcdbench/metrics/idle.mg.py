"""The device's idle share (%) in the traced unit of a "solve" cell
(metrics/_common.idle_share)."""
from qcdbench.metrics._common import idle_share


def read(run):
    return idle_share(run, "solve")
