"""Outer GCR iterations a column, summed over the defect-correction passes
(Solver.records "iters"), over the window's columns."""


def read(run):
    if run["kind"] != "solve":
        return None
    its = [it for u in run["units"] for it in u["summary"]["iters"]]
    return sum(its) / len(its) if its else None
