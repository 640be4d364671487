"""The device's idle share (%) in the traced unit of a "twop" cell
(metrics/_common.idle_share)."""
from qcdbench.metrics._common import idle_share


def read(run):
    return idle_share(run, "twop")
