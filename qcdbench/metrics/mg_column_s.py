"""Seconds a certified column: the window over the columns of the units
certified whole, counted from each unit's spec, not from the program's
records."""
from qcdbench.metrics._common import per_certified


def read(run):
    return per_certified(run, lambda u: len(u["spec"]["columns"]))
