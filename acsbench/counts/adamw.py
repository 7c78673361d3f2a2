"""The least bytes of the clip and the AdamW update over every leaf: the
clip reads each gradient once (for the global norm); the update reads the
gradient, the float32 master, m and v once and writes master, m, v and the
weight in its served dtype once. The gradient is in the weight's dtype."""

from . import peaks

SIZES = {"float32": 4, "bfloat16": 2, "float16": 2}


def least_bytes(leaves) -> int:
    """``leaves``: objects with ``numel`` and ``dtype`` (a dtype name)."""
    total = 0
    for leaf in leaves:
        w = SIZES[leaf.dtype]
        total += leaf.numel * (w + w + 3 * 4 + 3 * 4 + w)
    return total


def bound_s(leaves) -> float:
    return least_bytes(leaves) / peaks.HBM_BYTES_S
