"""gemma2-27b [dense]: alternating local/global attention + logit softcaps.
46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000, window 4096,
attn softcap 50, final softcap 30. [arXiv:2408.00118; hf]"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab=256000,
    pattern_unit=("attn_local", "attn_global"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    embed_scale=True,
    tied_embeddings=True,
    source="arXiv:2408.00118; hf",
)
