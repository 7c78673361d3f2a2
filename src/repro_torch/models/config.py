"""Architecture configuration for the assigned LM-family transformers
(a copy of ``repro/models/config.py``, which imports no JAX).

One :class:`ArchConfig` fully determines a model: layer pattern (attention
variants / RG-LRU / Mamba), FFN kind (dense gated / MoE), embedding and
frontend. ``reduced()`` derives the CPU-smoke-test configuration of the
same family (small widths, few layers/experts, tiny vocab).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["MoEConfig", "MLAConfig", "ArchConfig", "LAYER_KINDS"]

# layer mixer kinds
ATTN_GLOBAL = "attn_global"
ATTN_LOCAL = "attn_local"      # sliding-window attention
MLA = "mla"                    # deepseek multi-head latent attention
RGLRU = "rglru"                # recurrentgemma RG-LRU recurrent block
MAMBA = "mamba"                # mamba-1 selective SSM block

LAYER_KINDS = (ATTN_GLOBAL, ATTN_LOCAL, MLA, RGLRU, MAMBA)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int              # per-expert FFN hidden dim
    n_shared: int = 0          # shared (always-on) experts
    capacity_factor: float = 1.25
    # experts padded up so n_experts % (model TP degree) == 0 (see DESIGN.md)
    first_dense: int = 0       # leading layers with dense FFN instead (deepseek: 1)
    # Beyond-paper perf option (§Perf): dtype of the expert-output combine
    # (the TP psum wire format). bf16 halves the dominant collective.
    combine_dtype: str = "float32"
    # Beyond-paper perf option (§Perf): dispatch tokens to experts within
    # ``dispatch_groups`` batch-aligned groups (set = DP degree) so the
    # gather/scatter and expert tensors shard over dp instead of carrying
    # the GLOBAL token axis through every device (the profile-discovered
    # 16x dispatch blowup). 1 = paper-faithful global dispatch.
    dispatch_groups: int = 1


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512         # compressed c_kv dim (the MLA KV cache)
    q_lora: int = 1536         # compressed query dim (0 = full-rank q proj)
    rope_dim: int = 64         # decoupled rope key dim (shared across heads)
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    pattern_unit: Tuple[str, ...] = (ATTN_GLOBAL,)
    window: Optional[int] = None           # for attn_local layers
    attn_softcap: Optional[float] = None   # gemma2 attention logit softcap
    final_softcap: Optional[float] = None  # gemma2 final logit softcap
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    # SSM / recurrent
    ssm_state: int = 16
    d_conv: int = 4
    expand: int = 2                        # mamba d_inner = expand * d_model
    rglru_width: Optional[int] = None      # defaults to d_model
    # embeddings / frontend
    tied_embeddings: bool = True
    embed_scale: bool = False              # gemma-style sqrt(d) embed scaling
    frontend: Optional[str] = None         # None | "audio_stub" | "vision_stub"
    prefix_len: int = 0                    # vlm: bidirectional prefix tokens
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    # Beyond-paper perf option (EXPERIMENTS.md §Perf): pad the head count
    # up to a TP-shardable multiple with zero-initialized heads (zero wo
    # rows => numerics unchanged) instead of replicating attention.
    pad_heads_to: Optional[int] = None
    # notes recorded for DESIGN.md provenance
    source: str = ""

    @property
    def eff_heads(self) -> int:
        return max(self.pad_heads_to or 0, self.n_heads)

    @property
    def eff_kv_heads(self) -> int:
        # MHA archs pad KV alongside Q so the group stays integral;
        # GQA/MQA kv heads are already <= padded Q and divide it.
        if self.n_kv_heads == self.n_heads:
            return self.eff_heads
        return self.n_kv_heads

    # -- derived -------------------------------------------------------------
    @property
    def pattern(self) -> Tuple[str, ...]:
        """Full per-layer mixer list (len == n_layers)."""
        unit = self.pattern_unit
        reps = self.n_layers // len(unit)
        rem = self.n_layers - reps * len(unit)
        return unit[:rem] + unit * reps  # remainder layers lead (unscanned)

    @property
    def sub_quadratic(self) -> bool:
        """True iff no layer needs a full-length KV cache (long_500k viable)."""
        return all(k in (ATTN_LOCAL, RGLRU, MAMBA) for k in self.pattern_unit)

    @property
    def has_attention(self) -> bool:
        return any(k in (ATTN_GLOBAL, ATTN_LOCAL, MLA) for k in self.pattern_unit)

    @property
    def n_params(self) -> float:
        """Approximate parameter count (embedding + blocks), for 6ND math."""
        p = self.vocab * self.d_model * (1 if self.tied_embeddings else 2)
        per_layer = {k: self._mixer_params(k) for k in set(self.pattern)}
        for i, kind in enumerate(self.pattern):
            p += per_layer[kind] + self._ffn_params(i, kind)
        return float(p)

    @property
    def n_active_params(self) -> float:
        """Active params per token (MoE: only routed top-k + shared)."""
        p = self.vocab * self.d_model * (1 if self.tied_embeddings else 2)
        per_layer = {k: self._mixer_params(k) for k in set(self.pattern)}
        for i, kind in enumerate(self.pattern):
            p += per_layer[kind] + self._ffn_params(i, kind, active_only=True)
        return float(p)

    def _mixer_params(self, kind: str) -> int:
        d = self.d_model
        if kind == MLA:
            m = self.mla
            q = self.n_heads * (m.nope_head_dim + m.rope_dim)
            p = d * m.q_lora + m.q_lora * q if m.q_lora else d * q
            p += d * (m.kv_lora + m.rope_dim)
            p += m.kv_lora * self.n_heads * (m.nope_head_dim + m.v_head_dim)
            p += self.n_heads * m.v_head_dim * d
            return p
        if kind in (ATTN_GLOBAL, ATTN_LOCAL):
            hd = self.head_dim
            return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if kind == RGLRU:
            w = self.rglru_width or d
            return 2 * d * w + w * d + 3 * w * self.d_conv + 2 * w * w
        if kind == MAMBA:
            di = self.expand * d
            return 2 * d * di + di * self.d_conv + di * (2 * self.ssm_state + 1) + di + di * d
        raise ValueError(kind)

    def _ffn_params(self, layer_idx: int, kind: str, active_only: bool = False) -> int:
        if kind == MAMBA:
            return 0  # mamba blocks have no separate FFN
        d = self.d_model
        if self.moe is not None and layer_idx >= self.moe.first_dense:
            e = self.moe
            n_eff = (e.top_k if active_only else e.n_experts) + e.n_shared
            return n_eff * 3 * d * e.d_expert + d * e.n_experts  # + router
        return 3 * d * self.d_ff

    def reduced(self) -> "ArchConfig":
        """Same-family smoke configuration runnable on CPU."""
        unit = self.pattern_unit
        n_layers = max(len(unit), 2 if len(unit) == 1 else len(unit))
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(2, self.moe.top_k),
                d_expert=32, n_shared=min(1, self.moe.n_shared),
                first_dense=min(1, self.moe.first_dense) if self.moe.first_dense else 0,
            )
            n_layers = max(n_layers, 2)
        mla = None
        if self.mla is not None:
            mla = MLAConfig(kv_lora=16, q_lora=24, rope_dim=8,
                            nope_head_dim=8, v_head_dim=8)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16 if mla is None else 8,
            d_ff=128,
            vocab=256,
            window=min(self.window, 16) if self.window else None,
            moe=moe,
            mla=mla,
            ssm_state=4,
            expand=2,
            rglru_width=64 if self.rglru_width else None,
            prefix_len=min(self.prefix_len, 4),
            dtype="float32",
        )
