"""The benchmark's counts (``acsbench/counts``) at granite-moe-3b-a800m's
and minicpm-2b's training shapes (4 x 512 tokens), against sums worked out
by hand."""

import math

import pytest

from acsbench import harness
from acsbench.reference.model import Spec, layout

HBM, BF16 = 3.35e12, 989e12


def _spec(config: str) -> Spec:
    bench = harness.load_benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == config)
    import json

    return Spec.from_config(json.load(open(harness.ROOT / entry["file"])))


def test_grouped_matmul_at_granites_experts():
    c = harness.counts("grouped_matmul")
    # C = 2048 * 8 / 40 * 1.25 = 512 rows an expert, 40 experts: M = 20480
    gate = [[20480, 1536], [40, 1536, 512], [40]]
    # x 31,457,280 + w 31,457,280 + y 10,485,760 elements of 2 bytes, 40 int32 tile ids
    fwd_bytes = 2 * (31_457_280 + 31_457_280 + 10_485_760) + 160
    assert c.bound_s(c.FWD, gate) == pytest.approx(fwd_bytes / HBM, rel=1e-12)
    assert 2 * 20480 * 1536 * 512 / BF16 < fwd_bytes / HBM  # bound by bytes
    down = [[20480, 512], [40, 512, 1536], [40]]
    assert c.bound_s(c.FWD, down) == pytest.approx(fwd_bytes / HBM, rel=1e-12)
    bwd = gate + [[20480, 512]]
    # reads dy, w, x; writes dx, dw: 10,485,760 + 2 * 31,457,280 + 2 * 31,457,280
    bwd_bytes = 2 * (10_485_760 + 4 * 31_457_280) + 160
    flops = 2 * 2 * 20480 * 1536 * 512
    assert c.bound_s(c.BWD, bwd) == pytest.approx(max(bwd_bytes / HBM, flops / BF16))
    only_dw = c.bound_s(c.BWD, bwd, [None] * 5 + [False, True])
    assert only_dw == pytest.approx(max((2 * (10_485_760 + 2 * 31_457_280) + 160) / HBM,
                                        flops / 2 / BF16))


@pytest.mark.parametrize("h, hkv", [(24, 8), (36, 36)])
def test_flash_attention_at_the_training_shapes(h, hkv):
    c = harness.counts("flash_attention")
    seen = 4 * h * (512 * 513 // 2)              # causal pairs, every head
    q = out = 4 * h * 512 * 64 * 2
    kv = 2 * 4 * hkv * 512 * 64 * 2
    lse = 4 * h * 512 * 4
    shapes = [[4, h, 512, 64], [4, hkv, 512, 64], [4, hkv, 512, 64]]
    assert c.bound_s(c.FWD, shapes) == pytest.approx(
        max(2 * 128 * seen / BF16, (q + kv + out + lse) / HBM))
    bwd = shapes + [[4, h, 512, 64], [4, h, 512], [4, h, 512, 64]]
    assert c.bound_s(c.BWD, bwd) == pytest.approx(
        max(2 * (3 * 64 + 2 * 64) * seen / BF16, (2 * (q + kv) + 2 * out + lse) / HBM))
    assert c.pairs(512, 512, True) == 131_328 and c.pairs(3, 5, True) == 3 + 4 + 5


def test_adamw_bytes_over_granites_leaves():
    leaves = layout(_spec("granite-moe-3b-a800m"))
    f32 = sum(leaf.numel for leaf in leaves if leaf.dtype == "float32")
    bf16 = sum(leaf.numel for leaf in leaves if leaf.dtype == "bfloat16")
    # final norm; a layer's two norms and its 1536 x 40 router
    assert f32 == 1536 + 32 * (2 * 1536 + 1536 * 40) == 2_065_920
    assert f32 + bf16 == 3_299_182_080
    # bf16: grad read twice (2 + 2), master, m, v read and written (24), weight written (2)
    want = 30 * bf16 + 36 * f32
    assert harness.counts("adamw").least_bytes(leaves) == want == 98_987_857_920
    assert harness.counts("adamw").bound_s(leaves) == pytest.approx(want / HBM)


@pytest.mark.parametrize("config, active, attn_heads, layers", [
    # 32 x (attention 6,291,456 + router 61,440 + 8 experts 18,874,368) + 49,155 x 1,536
    ("granite-moe-3b-a800m", 882_774_528, 24, 32),
    # 40 x (attention 21,233,664 + SwiGLU 39,813,120) + 122,753 x 2,304
    ("minicpm-2b", 2_724_694_272, 36, 40),
])
def test_model_flops(config, active, attn_heads, layers):
    m = harness.counts("model")
    spec = _spec(config)
    assert m.active_params(spec) == active
    attn = 12 * 4 * layers * attn_heads * 64 * 131_328
    assert m.train_flops(spec, 4, 512) == 6 * active * 2048 + attn
    assert math.isclose(m.train_flops(_spec("granite-moe-3b-a800m"), 4, 512), 1.1157e13,
                        rel_tol=1e-4)
