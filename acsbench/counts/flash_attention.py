"""Flash attention's least work (``repro_torch::flash_attention_lse``, the
forward with its row log-sum-exp, and ``::flash_attention_bwd``), over
the (query row, key) pairs a causal mask keeps: ``Sq (Sq + 1) / 2`` a
head where ``Sq == Sk``.

Forward: ``QK^T`` over D and ``PV`` over Dv, ``2 (D + Dv)`` FLOPs a pair;
reads q, k, v once, writes the output and the float32 log-sum-exp.
Backward: ``S`` again, ``dQ`` and ``dK`` over D, ``dP`` and ``dV`` over Dv,
``2 (3 D + 2 Dv)`` FLOPs a pair; reads q, k, v, the output, its gradient
and the log-sum-exp once, writes dq, dk, dv."""

from . import peaks

FWD = "repro_torch::flash_attention_lse"
BWD = "repro_torch::flash_attention_bwd"


def pairs(sq: int, sk: int, causal: bool) -> int:
    """The (query row, key) pairs a causal mask (queries at the end of the
    keys) or none keeps."""
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(min(off + r + 1, sk) for r in range(sq))


def bound_s(op: str, shapes, scalars=None, elem: int = 2) -> float:
    """The least seconds of one call from its input shapes (``q [B, H, Sq,
    D]``, ``k [B, Hkv, Sk, D]``, ``v [B, Hkv, Sk, Dv]``, then for the
    backward the output, the log-sum-exp and the output's gradient), causal
    unless the profiler kept a ``causal`` of False; ``elem`` bytes an
    element of q, k, v and the output."""
    (b, h, sq, d), (_, hkv, sk, _), (_, _, _, dv) = shapes[0], shapes[1], shapes[2]
    n_scalar = 3 if op == FWD else 6
    causal = True
    if scalars and len(scalars) > n_scalar and isinstance(scalars[n_scalar], bool):
        causal = scalars[n_scalar]
    seen = b * h * pairs(sq, sk, causal)
    qkv = elem * (b * h * sq * d + b * hkv * sk * (d + dv))
    out = elem * b * h * sq * dv
    lse = 4 * b * h * sq
    if op == FWD:
        return peaks.bound_s(2 * (d + dv) * seen, qkv + out + lse)
    if op != BWD:
        raise ValueError(op)
    return peaks.bound_s(2 * (3 * d + 2 * dv) * seen, 2 * qkv + 2 * out + lse)
