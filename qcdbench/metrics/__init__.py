"""Metric readers, end-to-end and per-layer, one file a metric named as in
BENCHMARK.json; each defines read(run) -> number or None (nothing to read
in this run)."""
