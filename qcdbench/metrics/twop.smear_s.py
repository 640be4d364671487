"""Seconds a source in the Gaussian smearing of sources and sinks:
run_twop.measure's stages sources + sink_smearing, over the window."""


def read(run):
    if run["kind"] != "twop":
        return None
    st = [u["summary"]["stages"] for u in run["units"]]
    return sum(s["sources"] + s["sink_smearing"] for s in st) / len(st) if st else None
