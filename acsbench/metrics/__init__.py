"""Per-layer metric readers, one module a metric, found by the metric's
name in ``BENCHMARK.json``. Each has ``read(run)``, which takes a traced
run's readings (``kinds.<kind>``'s run object: spans, counters and the
device trace) and returns the metric's value, or None where it finds
nothing to read (a run of another kind, without the readings it takes,
included); the harness then leaves the metric out of the result."""
