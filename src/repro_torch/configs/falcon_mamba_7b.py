"""falcon-mamba-7b [ssm]: attention-free Mamba-1 stack.
64L d_model=4096 d_ff=0 vocab=65024, ssm_state=16, d_inner=8192.
[arXiv:2410.05355; unverified]"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,            # attention-free; kept for config uniformity
    n_kv_heads=1,
    d_ff=0,               # mamba blocks have no separate FFN
    vocab=65024,
    pattern_unit=("mamba",),
    ssm_state=16,
    expand=2,             # d_inner = 8192
    d_conv=4,
    tied_embeddings=True,
    source="arXiv:2410.05355; unverified",
)
