"""A decoder LM train step's model FLOPs, with no recompute: 6 FLOPs a
parameter a token over the parameters a token uses (a MoE layer's router
and its top-k experts; the tied embedding once, as the head's product
over the real vocabulary), plus causal attention's ``QK^T`` and ``PV``
forward and backward, ``6 B L H hd S (S + 1) / 2`` for ``Sq == Sk``."""


def active_params(spec) -> int:
    """``spec``: the reference's ``Spec``."""
    d, hd = spec.d_model, spec.head_dim
    attn = d * spec.n_heads * hd + 2 * d * spec.n_kv_heads * hd + spec.n_heads * hd * d
    if spec.moe:
        ffn = d * spec.n_experts + spec.top_k * 3 * d * spec.d_expert
    else:
        ffn = 3 * d * spec.d_ff
    head = spec.vocab * d
    return spec.n_layers * (attn + ffn) + head


def train_flops(spec, batch: int, seq: int) -> float:
    pairs = seq * (seq + 1) // 2
    attn = 6 * batch * spec.n_layers * spec.n_heads * spec.head_dim * pairs * 2
    return 6.0 * active_params(spec) * batch * seq + attn
