"""minicpm-2b [dense]: llama-like with WSD schedule.
40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753.
[arXiv:2404.06395; hf] — the WSD LR schedule lives in optim/schedules."""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab=122753,
    pattern_unit=("attn_global",),
    embed_scale=True,
    tied_embeddings=True,
    source="arXiv:2404.06395; hf",
)
