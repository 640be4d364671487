"""dslash_eo's share of its bandwidth roofline (%) in the traced unit of a
"twop" cell (metrics/_common.hop_roofline)."""
from qcdbench.metrics._common import hop_roofline


def read(run):
    return hop_roofline(run, "twop")
