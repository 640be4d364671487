"""Seconds a source in the forward solves: run_twop.measure's stages
solves_u + solves_d (host clock, device synchronised), over the window."""


def read(run):
    if run["kind"] != "twop":
        return None
    st = [u["summary"]["stages"] for u in run["units"]]
    return sum(s["solves_u"] + s["solves_d"] for s in st) / len(st) if st else None
