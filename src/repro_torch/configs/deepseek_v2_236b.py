"""deepseek-v2-236b [moe]: MLA attention + fine-grained MoE.
60L d_model=5120 128H d_ff(dense layer 1)=12288 vocab=102400.
MLA: kv_lora=512 (+64 decoupled rope), q_lora=1536, 128/128 nope/v dims.
MoE: 2 shared + 160 routed experts, top-6, d_expert=1536; layer 1 dense.
[arXiv:2405.04434; hf]"""

from ..models.config import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,       # MLA reconstructs per-head KV from the latent
    head_dim=128,
    d_ff=12288,           # dense-FFN dim (first layer + sizing reference)
    vocab=102400,
    pattern_unit=("mla",),
    mla=MLAConfig(kv_lora=512, q_lora=1536, rope_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536, n_shared=2,
                  first_dense=1),
    tied_embeddings=False,
    source="arXiv:2405.04434; hf",
)
