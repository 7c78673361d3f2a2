"""The share of the MoE layers' capacity rows that hold a kept
assignment: 100 * ``moe.kept_rows`` / ``moe.capacity_rows``, the program's
counters (``models/ffn.py:_moe_block``: each expert's C rows in each of
the three expert products, and those the capacity dispatch filled), over
steps run with its tracing on (``acsbench/spans.py``: ``inside_steps``).
None without the counters (a model with no MoE layer)."""

from acsbench.spans import useful_rows_pct


def read(run):
    return useful_rows_pct(getattr(run, "inside", None))
