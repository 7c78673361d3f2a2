"""The plain reference of a decoder-only LM train step: PyTorch operations
in float32 (TF32 off), written from a configuration file's description of
the architecture (its top-level published sizes and its ``as_run`` block,
which states where the measured program departs from the publication).
It imports nothing of the program and takes nothing the program made: the
harness hands it the same seeded weights and token batches, and it works
out the loss, the gradients and the AdamW state again.

The step runs a layer at a time so that it fits beside nothing else on one
card: a forward without autograd keeps each layer's input, then the
backward recomputes one layer at a time under autograd. Gradients are
float32; the optimizer state (master, m, v) is float32.

``precision="fp8"`` is the control: every matrix product rounds both of
its operands to float8 e4m3 (a per-tensor scale to the format's largest
value) in the forward and its incoming gradient to e5m2 in the backward,
the precision one step below the bfloat16 the configuration states.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["Spec", "Leaf", "layout", "train_step", "adamw_step", "Optimizer", "run_steps"]


@dataclasses.dataclass(frozen=True)
class Spec:
    """What the reference computes, from a configuration file."""

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    vocab_padded: int
    tied: bool
    embed_scale: Optional[float]
    norm_eps: float
    rope_theta: float
    dtype: str
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.0

    @classmethod
    def from_config(cls, cfg: dict, **sizes) -> "Spec":
        """The published sizes of ``cfg`` (a configuration file's object)
        with its ``as_run`` departures; ``sizes`` overrides any field (the
        tests' tiny models)."""
        run = cfg["as_run"]
        d = cfg["hidden_size"]
        vocab = cfg["vocab_size"]
        mult = run["vocab_pad_multiple"]
        fields = dict(
            n_layers=cfg["num_hidden_layers"], d_model=d,
            n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_key_value_heads"],
            head_dim=cfg.get("head_dim", d // cfg["num_attention_heads"]),
            d_ff=cfg["intermediate_size"], vocab=vocab,
            vocab_padded=-(-vocab // mult) * mult, tied=cfg["tie_word_embeddings"],
            embed_scale=None, norm_eps=run["norm_eps"], rope_theta=run["rope_theta"],
            dtype=run["dtype"],
        )
        if cfg.get("num_local_experts"):
            fields.update(n_experts=cfg["num_local_experts"], top_k=cfg["num_experts_per_tok"],
                          d_expert=cfg["intermediate_size"],
                          capacity_factor=run["capacity_factor"])
        fields.update(sizes)
        if "vocab" in sizes and "vocab_padded" not in sizes:
            fields["vocab_padded"] = -(-fields["vocab"] // mult) * mult
        if run["embed_scale"] == "sqrt_d":
            fields["embed_scale"] = float(torch.tensor(math.sqrt(fields["d_model"]),
                                                       dtype=torch.float32))
        return cls(**fields)

    @property
    def moe(self) -> bool:
        return self.n_experts > 0


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One weight: its name, shape, served dtype, and how it starts:
    ``"normal"`` (N(0, 1) / sqrt(fan_in)) or ``"zeros"``."""

    name: str
    shape: Tuple[int, ...]
    dtype: str
    init: str
    fan_in: int = 1

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def layout(spec: Spec) -> List[Leaf]:
    """Every weight of the model, in order. Norm scales are ``1 + w`` with
    ``w`` starting at zero; the router is float32; the rest is in the
    configuration's dtype. Each normal leaf's fan-in is its contraction
    width (the head's for the tied embedding)."""
    d, hd, dt = spec.d_model, spec.head_dim, spec.dtype
    leaves = [Leaf("embed", (spec.vocab_padded, d), dt, "normal", d)]
    if not spec.tied:
        leaves.append(Leaf("head", (d, spec.vocab_padded), dt, "normal", d))
    leaves.append(Leaf("final_norm", (d,), "float32", "zeros"))
    for i in range(spec.n_layers):
        p = f"layers.{i}."
        leaves += [
            Leaf(p + "norm", (d,), "float32", "zeros"),
            Leaf(p + "attn.wq", (d, spec.n_heads, hd), dt, "normal", d),
            Leaf(p + "attn.wk", (d, spec.n_kv_heads, hd), dt, "normal", d),
            Leaf(p + "attn.wv", (d, spec.n_kv_heads, hd), dt, "normal", d),
            Leaf(p + "attn.wo", (spec.n_heads * hd, d), dt, "normal", spec.n_heads * hd),
            Leaf(p + "ffn_norm", (d,), "float32", "zeros"),
        ]
        if spec.moe:
            e, de = spec.n_experts, spec.d_expert
            leaves += [
                Leaf(p + "ffn.router", (d, e), "float32", "normal", d),
                Leaf(p + "ffn.w_gate", (e, d, de), dt, "normal", d),
                Leaf(p + "ffn.w_up", (e, d, de), dt, "normal", d),
                Leaf(p + "ffn.w_down", (e, de, d), dt, "normal", de),
            ]
        else:
            leaves += [
                Leaf(p + "ffn.w_gate", (d, spec.d_ff), dt, "normal", d),
                Leaf(p + "ffn.w_up", (d, spec.d_ff), dt, "normal", d),
                Leaf(p + "ffn.w_down", (spec.d_ff, d), dt, "normal", spec.d_ff),
            ]
    return leaves


# ---------------------------------------------------------------------------
# precision of the matrix products
# ---------------------------------------------------------------------------

def _round_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    top = torch.finfo(dtype).max
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((x * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2)


def _operand(precision: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if precision == "fp32":
        return lambda x: x
    if precision == "fp8":
        return _Fp8.apply
    raise ValueError(f"unknown precision {precision!r}")


# ---------------------------------------------------------------------------
# the model, in float32
# ---------------------------------------------------------------------------

def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + w)


def _rope_tables(s: int, hd: int, theta: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))
    angles = torch.arange(s, dtype=torch.float32, device=device)[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of the last axis of ``x [B, H, S, hd]``."""
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(spec: Spec, p: Dict[str, torch.Tensor], h: torch.Tensor, q8) -> torch.Tensor:
    """Causal grouped-query attention with rotary positions; query head
    ``j`` reads key-value head ``j // (H / Hkv)``; scores scaled by
    ``1 / sqrt(head_dim)``."""
    b, s, d = h.shape
    hq, hkv, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    x = q8(h)
    q = torch.einsum("bsd,dhk->bhsk", x, q8(p["attn.wq"]))
    k = torch.einsum("bsd,dhk->bhsk", x, q8(p["attn.wk"]))
    v = torch.einsum("bsd,dhk->bhsk", x, q8(p["attn.wv"]))
    cos, sin = _rope_tables(s, hd, spec.rope_theta, h.device)
    q, k = _rope(q, cos, sin), _rope(k, cos, sin)
    g = hq // hkv
    qg = q.reshape(b, hkv, g, s, hd)
    scores = torch.einsum("bkgqd,bkld->bkgql", q8(qg), q8(k)) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = torch.einsum("bkgql,bkld->bkgqd", q8(probs), q8(v)).reshape(b, hq, s, hd)
    out = out.transpose(1, 2).reshape(b, s, hq * hd)
    return q8(out) @ q8(p["attn.wo"])


def _top(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest along the last axis, descending, ties to the
    lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe(spec: Spec, p: Dict[str, torch.Tensor], h: torch.Tensor, q8) -> torch.Tensor:
    """Token-choice top-k over a float32 softmax router, the k weights
    renormalised; then, as run, each expert keeps the ``C`` tokens that
    scored it highest (``C = tokens * k / E * capacity_factor``), and a
    token's output is the weighted sum of its kept experts' SwiGLU."""
    b, s, d = h.shape
    t, e, k = b * s, spec.n_experts, spec.top_k
    cap = min(max(int(t * k / e * spec.capacity_factor), 1), t)
    x = h.reshape(t, d)
    probs = torch.softmax(x @ p["ffn.router"], dim=-1)
    top_p, top_e = _top(probs, k)
    top_p = top_p / (top_p.sum(dim=-1, keepdim=True) + 1e-9)
    assign = torch.zeros((t, e), dtype=x.dtype, device=x.device).scatter(1, top_e, top_p)
    score, token = _top(assign.t(), cap)                       # [E, C]
    rows = q8(x[token])                                         # [E, C, D]
    gate = torch.bmm(rows, q8(p["ffn.w_gate"]))
    up = torch.bmm(rows, q8(p["ffn.w_up"]))
    y = torch.bmm(q8(F.silu(gate) * up), q8(p["ffn.w_down"]))   # [E, C, D]
    y = y * (score * (score > 0))[..., None]
    out = torch.zeros_like(x).index_add(0, token.reshape(-1), y.reshape(e * cap, d))
    return out.reshape(b, s, d)


def _dense(p: Dict[str, torch.Tensor], h: torch.Tensor, q8) -> torch.Tensor:
    x = q8(h)
    hidden = F.silu(x @ q8(p["ffn.w_gate"])) * (x @ q8(p["ffn.w_up"]))
    return q8(hidden) @ q8(p["ffn.w_down"])


def layer(spec: Spec, p: Dict[str, torch.Tensor], x: torch.Tensor, q8=lambda t: t
          ) -> torch.Tensor:
    """One pre-norm block: ``x + attn(norm(x))``, then ``+ ffn(norm(.))``;
    ``p`` holds the layer's weights under their names without the
    ``layers.<i>.`` prefix."""
    x = x + _attention(spec, p, _rms(x, p["norm"], spec.norm_eps), q8)
    h = _rms(x, p["ffn_norm"], spec.norm_eps)
    return x + (_moe(spec, p, h, q8) if spec.moe else _dense(p, h, q8))


def _embed(spec: Spec, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    x = table[ids.long()]
    return x * spec.embed_scale if spec.embed_scale is not None else x


def _head_loss(spec: Spec, x, final_norm, head_w, labels, q8) -> torch.Tensor:
    """Mean next-token cross entropy over the real vocabulary: the padded
    columns of the logits are left out."""
    h = _rms(x, final_norm, spec.norm_eps)
    logits = q8(h) @ q8(head_w)
    logits = logits[..., :spec.vocab]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def _layer_params(params: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    pre = f"layers.{i}."
    return {n[len(pre):]: t for n, t in params.items() if n.startswith(pre)}


def train_step(spec: Spec, params: Dict[str, torch.Tensor], ids: torch.Tensor,
               labels: torch.Tensor, precision: str = "fp32"
               ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The loss and every weight's gradient (float32) on one batch, a layer
    at a time; ``params`` are float32 and are not changed."""
    q8 = _operand(precision)
    head_name = "embed" if spec.tied else "head"
    with torch.no_grad():
        xs = [_embed(spec, params["embed"], ids)]
        for i in range(spec.n_layers):
            xs.append(layer(spec, _layer_params(params, i), xs[-1], q8))
    x_last = xs.pop().requires_grad_(True)
    final_norm = params["final_norm"].detach().requires_grad_(True)
    head = params[head_name].detach().requires_grad_(True)
    head_w = head.t()
    loss = _head_loss(spec, x_last, final_norm, head_w, labels, q8)
    dx, g_norm, g_head = torch.autograd.grad(loss, [x_last, final_norm, head])
    grads = {"final_norm": g_norm, head_name: g_head}
    del x_last, head_w
    for i in reversed(range(spec.n_layers)):
        x_in = xs.pop().requires_grad_(True)
        lp = {n: t.detach().requires_grad_(True)
              for n, t in _layer_params(params, i).items()}
        y = layer(spec, lp, x_in, q8)
        got = torch.autograd.grad(y, [x_in, *lp.values()], grad_outputs=dx)
        dx = got[0]
        for n, g in zip(lp, got[1:]):
            grads[f"layers.{i}.{n}"] = g
        del y, x_in, lp, got
    if spec.embed_scale is not None:
        dx = dx * spec.embed_scale
    g_embed = grads.get("embed")
    if g_embed is None:
        g_embed = torch.zeros_like(params["embed"])
    grads["embed"] = g_embed.index_add(0, ids.reshape(-1).long(),
                                       dx.reshape(-1, spec.d_model))
    return float(loss.detach()), grads


@dataclasses.dataclass
class Optimizer:
    """AdamW as the configuration states it: weight decay inside the step,
    ``master -= lr * (mh / (sqrt(vh) + eps) + wd * master)``, after a clip
    of the gradients' global norm, at the learning rate of the traffic's
    schedule: a linear warm-up from 0 to ``peak_lr`` over the job's first
    ``warmup_tokens``, at ``global_batch_tokens`` a step (the whole
    data-parallel batch, of which a cell runs one chip's share), then the
    peak (a run ends long before the warm-up does)."""

    peak_lr: float
    warmup_tokens: float
    global_batch_tokens: float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    clip: float

    @classmethod
    def from_traffic(cls, opt: dict) -> "Optimizer":
        return cls(**{f.name: opt[f.name] for f in dataclasses.fields(cls)})

    def lr_at(self, step: int) -> float:
        """The learning rate of the job's ``step``-th step (from 1)."""
        return self.peak_lr * min(1.0, step * self.global_batch_tokens / self.warmup_tokens)


@torch.no_grad()
def adamw_step(opt: Optimizer, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], m: Dict[str, torch.Tensor],
               v: Dict[str, torch.Tensor], step: int) -> Dict[str, float]:
    """Clip, then one AdamW step in place on ``params``, ``m``, ``v``
    (``step`` counts from 1). Returns each leaf's clipped-gradient norm:
    the gradient as the optimizer gets it."""
    sq = torch.zeros((), dtype=torch.float32, device=next(iter(grads.values())).device)
    for g in grads.values():
        sq += torch.sum(g * g)
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(opt.clip / (gnorm + 1e-9), max=1.0)
    c1 = 1.0 - opt.b1 ** step
    lr = opt.lr_at(step)
    c2 = 1.0 - opt.b2 ** step
    norms = {}
    for name, g in grads.items():
        g = g * scale
        norms[name] = torch.linalg.vector_norm(g)
        m[name].mul_(opt.b1).add_((1 - opt.b1) * g)
        v[name].mul_(opt.b2).add_((1 - opt.b2) * g * g)
        update = (m[name] / c1) / (torch.sqrt(v[name] / c2) + opt.eps)
        params[name].sub_(lr * (update + opt.weight_decay * params[name]))
    return {n: float(t) for n, t in zip(norms, torch.stack(list(norms.values())).tolist())}


def run_steps(spec: Spec, opt: Optimizer, params: Dict[str, torch.Tensor],
              batches: Sequence[Tuple[torch.Tensor, torch.Tensor]], precision: str = "fp32"
              ) -> Tuple[List[float], Dict[str, float]]:
    """Train ``params`` (float32, changed in place) on ``batches`` from a
    fresh optimizer state. Returns each step's loss and the first step's
    clipped-gradient norm of each leaf."""
    m = {n: torch.zeros_like(t) for n, t in params.items()}
    v = {n: torch.zeros_like(t) for n, t in params.items()}
    losses, first = [], None
    for i, (ids, labels) in enumerate(batches):
        loss, grads = train_step(spec, params, ids, labels, precision)
        norms = adamw_step(opt, params, grads, m, v, i + 1)
        del grads
        losses.append(loss)
        first = norms if first is None else first
    return losses, first
