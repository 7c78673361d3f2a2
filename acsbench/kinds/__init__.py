"""Drivers of the traffic kinds, one module a kind, found by the traffic
file's ``kind``. Each has ``Cell``, built as ``Cell(config=, traffic=,
seed=, seconds=, trace=, device=, log=)``, and ``run(cell)``, which
returns an object with the fields of ``train.Result``: the end-to-end
values the kind measured (by metric name; the harness leaves out a metric
the kind does not give), ``attempted``, ``failed``, ``correct``, the
numbers compared as ``{name: (value, limit)}``, the kind's own ``checks``,
``memory_peak_bytes``, ``setup_end``, and for a traced run ``run`` (what
the per-layer metrics' readers read) and ``busy_s``."""
