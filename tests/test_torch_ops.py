"""Flash attention's, the grouped GEMM's and the two scans' ``torch.library``
ops on the CPU: ``torch.library.opcheck`` on each (its schema, its fake
implementation against the real one, its autograd registration; the
Mamba scan's ``z``, ``b`` and ``c`` strided slices, as the model passes
them), each fake implementation's shapes and dtypes against the plain
version's, the FLOP formulas against the bounds' counts and a hand count,
and the wrappers reaching the ops (``tests/test_torch_cuda.py`` holds the
ops' bits and launches on the card to the launch functions under
them)."""

import importlib

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import ref

fa = importlib.import_module("repro_torch.kernels.flash_attention")
gm = importlib.import_module("repro_torch.kernels.grouped_matmul")
ls = importlib.import_module("repro_torch.kernels.lru_scan")
ss = importlib.import_module("repro_torch.kernels.selective_scan")

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


# (B, S, D) of the RG-LRU scan; (B, S, E, N, dtype) of the Mamba scan (S 70:
# two of its 64-step chunks, one saved state)
LRU_CASES = {"one_step": (2, 1, 8), "chunked": (2, 37, 12)}
MAMBA_CASES = {"decode_f32": (2, 1, 8, 4, torch.float32), "two_chunks_f32": (1, 70, 6, 3,
                                                                            torch.float32),
               "prefill_bf16": (2, 9, 8, 4, torch.bfloat16)}


def _lru_inputs(case, requires_grad=False):
    b, seq, d = LRU_CASES[case]
    gen = torch.Generator().manual_seed(2)
    a = torch.rand(b, seq, d, generator=gen)
    x = torch.randn(b, seq, d, generator=gen)
    h0 = torch.randn(b, d, generator=gen)
    return [t.requires_grad_(requires_grad) for t in (a, x, h0)]


def _mamba_inputs(case, requires_grad=False):
    """The fused entry's inputs as ``apply_mamba`` passes them: z a slice
    of the in-projection's output, b and c slices of x_proj's."""
    b, seq, e, n, dtype = MAMBA_CASES[case]
    gen = torch.Generator().manual_seed(3)
    xz = torch.randn(b, seq, 2 * e, generator=gen).to(dtype)
    proj = torch.randn(b, seq, 2 + 2 * n, generator=gen).to(dtype)
    dt_raw = torch.randn(b, seq, e, generator=gen).to(dtype)
    x = torch.randn(b, seq, e, generator=gen).to(dtype)
    params = (0.5 * torch.randn(e, generator=gen), torch.rand(e, n, generator=gen),
              torch.randn(e, generator=gen), torch.randn(b, e, n, generator=gen))
    dt_bias, a_log, d, h0 = params
    leaves = [dt_raw, dt_bias, x, xz, proj, a_log, d, h0]
    for t in leaves:
        t.requires_grad_(requires_grad)
    return (dt_raw, dt_bias, x, xz[..., e:], proj[..., 2:2 + n], proj[..., 2 + n:], a_log, d,
            h0)


@pytest.mark.parametrize("case", sorted(LRU_CASES))
def test_lru_scan_ops_pass_opcheck(case):
    torch.library.opcheck(torch.ops.repro_torch.lru_scan.default, _lru_inputs(case))
    torch.library.opcheck(torch.ops.repro_torch.lru_scan.default, _lru_inputs(case, True))
    a, x, h0 = _lru_inputs(case)
    h = torch.ops.repro_torch.lru_scan.default(a, x, h0)
    torch.library.opcheck(torch.ops.repro_torch.lru_scan_bwd.default,
                          (a, h, h0, torch.randn_like(h)))


@pytest.mark.parametrize("case", sorted(MAMBA_CASES))
def test_mamba_scan_ops_pass_opcheck(case):
    for save in (False, True):
        torch.library.opcheck(torch.ops.repro_torch.mamba_scan.default,
                              (*_mamba_inputs(case), save))
    torch.library.opcheck(torch.ops.repro_torch.mamba_scan.default,
                          (*_mamba_inputs(case, True), True))
    args = _mamba_inputs(case)
    y, ht, states = torch.ops.repro_torch.mamba_scan.default(*args, True)
    for dht in (None, torch.randn_like(ht)):
        torch.library.opcheck(torch.ops.repro_torch.mamba_scan_bwd.default,
                              (*args, states, torch.randn_like(y), dht))


@pytest.mark.parametrize("case", sorted(LRU_CASES))
def test_lru_scan_fakes_match_the_plain_versions(case):
    a, x, h0 = _lru_inputs(case)
    h = ref.lru_scan_ref(a, x, h0)
    grads = ref.lru_scan_bwd_ref(a, h, h0, h)
    mode, (fa_, fx, fh0, fh) = _fake_like([a, x, h0, h])
    with mode:
        f_h = torch.ops.repro_torch.lru_scan.default(fa_, fx, fh0)
        f_grads = torch.ops.repro_torch.lru_scan_bwd.default(fa_, fh, fh0, fh)
    for fake, real in [(f_h, h)] + list(zip(f_grads, grads)):
        assert (fake.shape, fake.dtype) == (real.shape, real.dtype)


@pytest.mark.parametrize("case", sorted(MAMBA_CASES))
def test_mamba_scan_fakes_match_the_plain_versions(case):
    args = _mamba_inputs(case)
    y, ht = ref.mamba_scan_ref(*args)
    _, _, states = torch.ops.repro_torch.mamba_scan.default(*args, True)
    seq, n_batch, ch, n = args[0].shape[1], *args[8].shape
    assert states.shape == (n_batch, -(-seq // ss.BWD_CHUNK) - 1, ch, n)
    assert states.dtype == torch.float32
    grads = ref.mamba_scan_bwd_ref(*args, y, ht)
    mode, fakes = _fake_like([*args, states, y, ht])
    with mode:
        f_y, f_ht, f_states = torch.ops.repro_torch.mamba_scan.default(*fakes[:9], True)
        f_none = torch.ops.repro_torch.mamba_scan.default(*fakes[:9], False)[2]
        f_grads = torch.ops.repro_torch.mamba_scan_bwd.default(*fakes)
    assert f_none.shape == (n_batch, 0, ch, n)
    for fake, real in [(f_y, y), (f_ht, ht), (f_states, states)] + list(zip(f_grads, grads)):
        assert (fake.shape, fake.dtype) == (real.shape, real.dtype)


class _ElementOps(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the elements that ``mul`` and ``add`` ops write: the
    plain RG-LRU scans' arithmetic, one op an element each."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func._overloadpacket in (torch.ops.aten.mul, torch.ops.aten.add):
            self.count += out.numel()
        return out


def test_scan_flop_formulas_count_the_work():
    """The RG-LRU scan: 2 B S D forward and 3 B S D - B D backward, the
    multiplies and adds its plain versions run, counted op by op; the Mamba
    scan: B S E (6 N + 4) forward and B S E (21 N + 15) backward, the counts
    the formulas' comments list."""
    from torch.utils.flop_counter import FlopCounterMode

    a, x, h0 = _lru_inputs("chunked", requires_grad=True)
    b, seq, d = a.shape
    with FlopCounterMode(display=False) as counter:
        h = ls.lru_scan(a, x, h0)
        fwd = counter.get_total_flops()
        h.backward(torch.ones_like(h))
    assert (fwd, counter.get_total_flops() - fwd) == (2 * b * seq * d, (3 * seq - 1) * b * d)
    with _ElementOps() as plain:
        ref.lru_scan_ref(a.detach(), x.detach(), h0.detach())
    assert plain.count == fwd
    with _ElementOps() as plain:
        ref.lru_scan_bwd_ref(a.detach(), h.detach(), h0.detach(), torch.ones_like(h))
    assert plain.count == (3 * seq - 1) * b * d

    args = _mamba_inputs("two_chunks_f32", requires_grad=True)
    b, seq, e = args[0].shape
    n = args[6].shape[1]
    assert (b, seq, e, n) == (1, 70, 6, 3)
    with FlopCounterMode(display=False) as counter:
        y, ht = ss.mamba_scan(*args)
        fwd = counter.get_total_flops()
        (y.sum() + ht.sum()).backward()
    assert fwd == 70 * 6 * (6 * 3 + 4) == 9240
    assert counter.get_total_flops() - fwd == 70 * 6 * (21 * 3 + 15) == 32760


def test_the_wrappers_reach_the_scan_ops():
    a, x, h0 = _lru_inputs("chunked")
    mode, fakes = _fake_like([a, x, h0])
    with mode:  # a fake tensor reaches the fake implementation: no build
        out = ls.lru_scan(*fakes)
    assert out.shape == a.shape
    args = _mamba_inputs("prefill_bf16")
    mode, fakes = _fake_like(list(args))
    with mode:
        y, ht = ss.mamba_scan(*fakes)
    assert (y.shape, y.dtype, ht.shape) == (args[2].shape, torch.bfloat16, args[8].shape)
    assert ls.launches == 0 and ss.launches == 0
