"""Seconds a two-point measurement: the window over the units (source
positions) certified whole."""
from qcdbench.metrics._common import per_certified


def read(run):
    return per_certified(run, lambda u: 1)
