"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 2:1 pattern.
26L d_model=2560 10H (GQA kv=1, MQA) d_ff=7680 vocab=256000.
[arXiv:2402.19427; hf] — pattern unit (rglru, rglru, attn_local), local
window 2048; 26 = 2 prefix recurrent layers + 8 x unit."""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    pattern_unit=("rglru", "rglru", "attn_local"),
    window=2048,
    rglru_width=2560,
    embed_scale=True,
    tied_embeddings=True,
    source="arXiv:2402.19427; hf",
)
