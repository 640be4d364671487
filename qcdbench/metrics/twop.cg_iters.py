"""Sloppy matvecs a column of the two-point run's CG (Solver.records
"iters"), over the window's columns."""


def read(run):
    if run["kind"] != "twop":
        return None
    its = [it for u in run["units"] for it in u["summary"]["iters"]]
    return sum(its) / len(its) if its else None
