"""musicgen-large [audio]: decoder-only transformer over EnCodec tokens.
48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048.
[arXiv:2306.05284; hf] — backbone only; the EnCodec frontend is a stub
(``input_specs`` supplies precomputed frame embeddings)."""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,          # 32 x 64 = 2048
    d_ff=8192,
    vocab=2048,           # EnCodec codebook size
    pattern_unit=("attn_global",),
    tied_embeddings=False,
    frontend="audio_stub",
    source="arXiv:2306.05284; hf",
)
