"""Unit kinds, one module a kind, found by the name a traffic file gives as
its "unit" (registry.kind).  A kind's module defines:

    Driver(config, traffic, gauge_file, device, detail)
        set-up: the port's input path, what the program builds once, and a
        warm-up of every shape the kind's units use; ``cfg`` (the port's
        RunConfig), ``run(spec) -> record`` (one unit: at least "records",
        the program's Solver.records of the unit, and "audit", what the
        judge reads), ``program() -> dict`` (the program's own spans for
        the per-layer readers) and ``close()`` (frees the program's state).
    summary(record, spec, tol) -> dict
        what the program reports of one unit: "columns" (the spec's count of
        columns the unit has to certify), "ok" (the program certified each
        of them) and whatever the per-layer readers read.
    judge(units, config, traffic, gauge_file, device, control=False) -> dict
        the numbers compared against the configuration's "limits", from the
        plain reference (qcdbench/reference/), after the window.

A new kind is a new module here and a traffic file that names it.
"""
