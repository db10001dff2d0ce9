"""Per-layer metrics: one reader a file, named as the metric is in
BENCHMARK.json, each with ``read(ctx) -> float | None`` over a
harness.TraceContext. A reader that finds nothing to read returns None,
and the harness leaves the metric out of the line."""
