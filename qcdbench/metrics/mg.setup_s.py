"""MG set-up seconds: DeviceMG.setup_seconds (null vectors, Galerkin probing;
host clock, device synchronised), summed over the stages."""


def read(run):
    s = run["program"].get("mg_setup_seconds")
    return sum(s.values()) if s else None
