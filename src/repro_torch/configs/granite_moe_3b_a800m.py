"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8)
d_expert=512 vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf] — experts padded 40 -> 48
so E % TP(16) == 0 (padded experts receive no tokens; DESIGN.md §6)."""

from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    pattern_unit=("attn_global",),
    moe=MoEConfig(n_experts=40, top_k=8, d_expert=512, n_shared=0),
    tied_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
