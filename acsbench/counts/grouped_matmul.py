"""The grouped GEMM's least work (``repro_torch::grouped_matmul_fwd`` and
``::grouped_matmul_bwd``): rows ``x [M, K]`` in tiles of ``block_m`` rows,
each tile against its group's ``w [G, K, N]``. The capacity layout fixes
every group's rows (``block_m`` each), so the shapes give the work.

Forward ``y = x @ w[g]``: ``2 M K N`` FLOPs; reads x, w and the tile ids
once, writes y. Backward ``dx = dy @ w[g]^T`` and ``dw[g] = x^T dy``:
``2 M K N`` each; reads dy and, as needed, w (for dx) and x (for dw)
once; writes dx and dw."""

from . import peaks

FWD = "repro_torch::grouped_matmul_fwd"
BWD = "repro_torch::grouped_matmul_bwd"


def bound_s(op: str, shapes, scalars=None, elem: int = 2) -> float:
    """The least seconds of one call, from its input shapes (``x``, ``w``,
    the tile ids, and for the backward ``dy``) and, for the backward, its
    ``need_dx`` and ``need_dw`` where the profiler kept them (else both);
    ``elem`` bytes an element of x, w and y."""
    (m, k), (g, _, n) = shapes[0], shapes[1]
    tiles = shapes[2][0] if shapes[2] else 0
    if op == FWD:
        return peaks.bound_s(2 * m * k * n, elem * (m * k + g * k * n + m * n) + 4 * tiles)
    if op != BWD:
        raise ValueError(op)
    need_dx, need_dw = True, True
    if scalars and len(scalars) >= 7 and isinstance(scalars[5], bool):
        need_dx, need_dw = scalars[5], scalars[6]
    flops = 2 * m * k * n * (int(need_dx) + int(need_dw))
    nbytes = elem * m * n + 4 * tiles
    if need_dx:
        nbytes += elem * (g * k * n + m * k)
    if need_dw:
        nbytes += elem * (m * k + g * k * n)
    return peaks.bound_s(flops, nbytes)
