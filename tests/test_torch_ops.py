"""Flash attention's and the grouped GEMM's ``torch.library`` ops on the
CPU: ``torch.library.opcheck`` on each (its schema, its fake
implementation against the real one, its autograd registration), each
fake implementation's shapes and dtypes against the plain version's, the
FLOP formulas against the bounds' counts, and the wrappers reaching the
ops (``tests/test_torch_cuda.py`` holds the ops' bits and launches on the
card to the launch functions under them)."""

import importlib

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import ref

fa = importlib.import_module("repro_torch.kernels.flash_attention")
gm = importlib.import_module("repro_torch.kernels.grouped_matmul")

# (q heads, kv heads, Sq, Sk, D, Dv, flags)
FLASH_CASES = {
    "gqa_causal": (4, 2, 8, 8, 16, 16, (True, None, None, 0.25, 0, 0)),
    "mla_widths": (2, 2, 6, 6, 24, 16, (True, None, None, 0.2, 0, 0)),
    "window_softcap_prefix": (4, 1, 8, 8, 16, 16, (True, 3, 5.0, 0.25, 0, 2)),
    "decode_offset": (4, 2, 1, 9, 16, 16, (True, None, None, 0.25, 8, 0)),
}
# (G, K, N, block_m, tile ids)
GMM_CASES = {"one_tile_a_group": (3, 8, 6, 4, [0, 1, 2]),
             "repeated_groups": (2, 8, 5, 2, [1, 1, 0, 1])}


def _flash_inputs(case, requires_grad=False):
    h, hkv, sq, sk, d, dv, flags = FLASH_CASES[case]
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, h, sq, d, generator=gen)
    k = torch.randn(2, hkv, sk, d, generator=gen)
    v = torch.randn(2, hkv, sk, dv, generator=gen)
    return [t.requires_grad_(requires_grad) for t in (q, k, v)], flags


def _gmm_inputs(case):
    g, k, n, bm, tiles = GMM_CASES[case]
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(len(tiles) * bm, k, generator=gen)
    w = torch.randn(g, k, n, generator=gen)
    return x, w, torch.tensor(tiles, dtype=torch.int32), bm


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_ops_pass_opcheck(case):
    (q, k, v), flags = _flash_inputs(case)
    torch.library.opcheck(torch.ops.repro_torch.flash_attention.default, (q, k, v, *flags))
    (q, k, v), _ = _flash_inputs(case, requires_grad=True)
    torch.library.opcheck(torch.ops.repro_torch.flash_attention_lse.default, (q, k, v, *flags))
    out, lse = torch.ops.repro_torch.flash_attention_lse.default(q, k, v, *flags)
    args = [t.detach() for t in (q, k, v, out, lse, torch.randn_like(out))]
    torch.library.opcheck(torch.ops.repro_torch.flash_attention_bwd.default, (*args, *flags))


@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_grouped_matmul_ops_pass_opcheck(case):
    x, w, tiles, bm = _gmm_inputs(case)
    err = torch.zeros(1, dtype=torch.int32)
    torch.library.opcheck(torch.ops.repro_torch.grouped_matmul.default, (x, w, tiles, err, bm))
    torch.library.opcheck(torch.ops.repro_torch.grouped_matmul_fwd.default,
                          (x.requires_grad_(True), w.requires_grad_(True), tiles, bm))
    dy = torch.randn(x.shape[0], w.shape[2])
    for need in ((True, True), (True, False), (False, True)):
        torch.library.opcheck(torch.ops.repro_torch.grouped_matmul_bwd.default,
                              (x.detach(), w.detach(), tiles, dy, bm, *need))


def _fake_like(tensors):
    mode = FakeTensorMode()
    return mode, [mode.from_tensor(t) for t in tensors]


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_fakes_match_the_plain_versions(case):
    (q, k, v), flags = _flash_inputs(case)
    causal, window, softcap, scale, q_offset, prefix_len = flags
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale, q_offset=q_offset,
              prefix_len=prefix_len)
    out, lse = ref.attention_ref(q, k, v, **kw), ref.attention_lse_ref(q, k, **kw)
    grads = ref.attention_bwd_ref(q, k, v, out, lse, out, **kw)
    mode, (fq, fk, fv, fo, fl) = _fake_like([q, k, v, out, lse])
    with mode:
        f_out = torch.ops.repro_torch.flash_attention.default(fq, fk, fv, *flags)
        f_out2, f_lse = torch.ops.repro_torch.flash_attention_lse.default(fq, fk, fv, *flags)
        f_grads = torch.ops.repro_torch.flash_attention_bwd.default(fq, fk, fv, fo, fl, fo,
                                                                    *flags)
    for fake, real in [(f_out, out), (f_out2, out), (f_lse, lse)] + list(zip(
            f_grads, (g.to(t.dtype) for g, t in zip(grads, (q, k, v))))):
        assert (fake.shape, fake.dtype) == (real.shape, real.dtype)


@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_grouped_matmul_fakes_match_the_plain_versions(case):
    x, w, tiles, bm = _gmm_inputs(case)
    dy = torch.randn(x.shape[0], w.shape[2])
    out = ref.grouped_matmul_ref(x, w, tiles, block_m=bm)
    dx, dw = ref.grouped_matmul_bwd_ref(x, w, tiles, dy, block_m=bm)
    mode, (fx, fw, ft, fdy) = _fake_like([x, w, tiles, dy])
    with mode:
        f_out = torch.ops.repro_torch.grouped_matmul.default(
            fx, fw, ft, torch.zeros(1, dtype=torch.int32), bm)
        f_out2, f_err = torch.ops.repro_torch.grouped_matmul_fwd.default(fx, fw, ft, bm)
        f_dx, f_dw = torch.ops.repro_torch.grouped_matmul_bwd.default(fx, fw, ft, fdy, bm,
                                                                      True, True)
    for fake, real in ((f_out, out), (f_out2, out), (f_dx, dx), (f_dw, dw)):
        assert (fake.shape, fake.dtype) == (real.shape, real.dtype)
    assert (f_err.shape, f_err.dtype) == ((1,), torch.int32)


def test_flop_formulas_count_the_bounds_work():
    """Flash: 2 (D + Dv) FLOPs a visible (row, key) pair forward and
    2 (3 D + 2 Dv) backward, as ``chip_smoke.py``'s bounds count them; the
    grouped GEMM 2 M K N each way."""
    from torch.utils.flop_counter import FlopCounterMode

    (q, k, v), flags = _flash_inputs("window_softcap_prefix", requires_grad=True)
    b, h, sq, d = q.shape
    seen = fa.visible_pairs(sq, k.shape[2], causal=True, window=3, q_offset=0, prefix_len=2)
    mask = ref._visible(sq, k.shape[2], q.device, causal=True, window=3, q_offset=0,
                        prefix_len=2)
    assert seen == int(mask.sum())
    with FlopCounterMode(display=False) as counter:
        out = fa.flash_attention(q, k, v, window=3, softcap=5.0, scale=0.25, prefix_len=2)
        out.sum().backward()
    assert counter.get_total_flops() == b * h * seen * (2 * (d + d) + 2 * (3 * d + 2 * d))
    x, w, tiles, bm = _gmm_inputs("repeated_groups")
    with FlopCounterMode(display=False) as counter:
        gm.grouped_matmul(x.requires_grad_(True), w.requires_grad_(True), tiles,
                          block_m=bm).sum().backward()
    assert counter.get_total_flops() == 3 * 2 * x.shape[0] * x.shape[1] * w.shape[2]


def test_the_wrappers_reach_the_ops():
    (q, k, v), _ = _flash_inputs("gqa_causal")
    with torch.no_grad():
        mode, fakes = _fake_like([q, k, v])
        with mode:  # a fake tensor reaches the fake implementation: no build
            out = fa.flash_attention(*fakes)
    assert out.shape == q.shape
    x, w, tiles, bm = _gmm_inputs("one_tile_a_group")
    mode, (fx, fw, ft) = _fake_like([x, w, tiles])
    with mode:
        out = gm.grouped_matmul(fx, fw, ft, block_m=bm, err=torch.zeros(1, dtype=torch.int32))
    assert out.shape == (x.shape[0], w.shape[2])
