"""paligemma-3b [vlm]: SigLIP vision prefix + gemma decoder backbone.
18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216.
[arXiv:2407.07726; hf] — vision frontend is a stub: ``input_specs``
supplies precomputed patch embeddings; the 256-token image prefix is
attended bidirectionally (prefix-LM)."""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=257216,
    pattern_unit=("attn_global",),
    frontend="vision_stub",
    prefix_len=256,
    embed_scale=True,
    tied_embeddings=True,
    source="arXiv:2407.07726; hf",
)
