"""h2o-danube-3-4b [dense]: llama+mistral mix with sliding-window attention.
24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, SWA window 4096.
[arXiv:2401.16818; unverified] — all-local => long_500k applicable."""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab=32000,
    pattern_unit=("attn_local",),
    window=4096,
    tied_embeddings=True,
    source="arXiv:2401.16818; unverified",
)
