"""The host-side split of the wgmma backward kernels, on the CPU.

Which block does which work is decided in the Python wrappers and passed
to the kernels: flash attention's key-tile pass runs the rows of
``flash_attention.backward_plan`` (a key tile's (query head, query tile)
items split over blocks, split key tiles' partial sums added in slot
order), its query-tile pass a grid of ``dq_blocks`` whose query tiles
stream the key tiles of the plan's ``dq_span``; the grouped GEMM's ``dw``
a persistent grid of ``dw_grid`` blocks, its ``dx`` the persistent grid
and tile width of ``dx_plan``. These tests hold each to a brute-force
enumeration over the shapes of ``chip_smoke.py``'s ``FLASH_BWD_SWEEP``
and ``GMM_BWD_SWEEP`` and a property sweep: every visible (query head,
query tile, key tile) is covered exactly once, partial sums are added in
one fixed order, the dw grid is no larger than its tiles, and dx's linear
tile index covers every (m-tile, chunk, column tile) once with no tile
leaving its m-tile. How each dw block walks its tiles is the kernel's
alone, held on the card. They also check the shape rules that send each
call to the wgmma path or, for tensors TMA cannot address, to the same
kernels on aligned, padded copies.
"""

from __future__ import annotations

import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from _prophelper import given, settings, st

fa = importlib.import_module("repro_torch.kernels.flash_attention")
gm = importlib.import_module("repro_torch.kernels.grouped_matmul")

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


def tile_table(tile_groups, g):
    """``(order, offs)``, the float32 dw path's table
    (``gmm_tile_table_kernel``): group ``i``'s tiles are
    ``order[offs[i]:offs[i + 1]]`` in index order; ids outside ``[0, G)``
    are in no list."""
    order = [t for gid in range(g) for t, tg in enumerate(tile_groups) if tg == gid]
    offs = [0]
    for gid in range(g):
        offs.append(offs[-1] + sum(1 for tg in tile_groups if tg == gid))
    return order, offs


def _visible(sq, sk, causal=True, window=None, q_offset=0, prefix_len=0):
    """[sq, sk] bool: whether local query row i sees key j (the kernels'
    mask, written out)."""
    rows = q_offset + np.arange(sq)[:, None]
    cols = np.arange(sk)[None, :]
    vis = np.ones((sq, sk), bool)
    if causal:
        vis &= cols <= rows
    if window is not None:
        vis &= cols > rows - window
    return vis | (cols < prefix_len)


def _tile_pairs(vis, rows, keys):
    """Set of (query tile, key tile) with at least one visible pair."""
    sq, sk = vis.shape
    out = set()
    for qt in range(-(-sq // rows)):
        for kt in range(-(-sk // keys)):
            if vis[qt * rows:(qt + 1) * rows, kt * keys:(kt + 1) * keys].any():
                out.add((qt, kt))
    return out


def _flags(flags):
    return dict(causal=flags.get("causal", True), window=flags.get("window"),
                q_offset=flags.get("q_offset", 0), prefix_len=flags.get("prefix_len", 0))


def check_key_tile_plan(b, h, hkv, sq, sk, d, flags, n_sm, dv=None):
    """The key-tile pass's plan covers every visible (batch, head, query
    tile, key tile) exactly once and nothing twice; each key tile's dK and
    dV are written exactly once (by its only block, or by the reduction of
    its slots, in slot order, whose item runs follow one another); a key
    tile no query sees is zeroed by the reduction."""
    kw = _flags(flags)
    plan = fa.backward_plan(b, h, hkv, sq, sk, d, n_sm=n_sm, dv=dv, **kw)
    keys, group = fa.bwd_keys(d, dv), h // hkv
    n_kt = -(-sk // keys)
    want = _tile_pairs(_visible(sq, sk, **kw), fa.BWD_ROWS, keys)
    seen = {}
    by_tile = {}
    for row in plan.blocks:
        kt, bhk, first, count, lo, hi, slot, pad = row
        assert pad == 0 and 0 <= kt < n_kt and 0 <= bhk < b * hkv and lo < hi
        assert (first, count) == fa.key_tile_queries(kt, keys, sq, sk, **kw)
        by_tile.setdefault((kt, bhk), []).append(row)
        bi, hk = divmod(bhk, hkv)
        for it in range(lo, hi):
            key = (bi, hk * group + it // count, first + it % count, kt)
            assert key not in seen, f"item {key} twice"
            seen[key] = slot
    for bi in range(b):
        for head in range(h):
            for qt, kt in want:
                assert (bi, head, qt, kt) in seen, f"visible item {(bi, head, qt, kt)} missed"
    red = {(kt, bhk): (lo, hi) for kt, bhk, lo, hi in plan.red}
    assert len(red) == len(plan.red)
    for kt in range(n_kt):
        first, count = fa.key_tile_queries(kt, keys, sq, sk, **kw)
        for bhk in range(b * hkv):
            rows = by_tile.get((kt, bhk), [])
            if (kt, bhk) in red:  # split (or seen by no query): the reduction writes it
                lo, hi = red[(kt, bhk)]
                assert sorted(r[6] for r in rows) == list(range(lo, hi))
                runs = sorted((r[6], r[4], r[5]) for r in rows)
                assert [r[1] for r in runs] == [0] + [r[2] for r in runs[:-1]] or not runs
                assert (runs[-1][2] if runs else 0) == group * count
            else:  # its only block writes dK and dV
                assert len(rows) == 1 and rows[0][6] == -1
                assert (rows[0][4], rows[0][5]) == (0, group * count)
    slots = sorted(r[6] for r in plan.blocks if r[6] >= 0)
    assert slots == list(range(plan.n_slots))
    sizes = [r[5] - r[4] for r in plan.blocks]
    total = b * h * sum(fa.key_tile_queries(kt, keys, sq, sk, **kw)[1] for kt in range(n_kt))
    per_block = max(1, -(-total // (fa.BWD_BLOCKS_PER_SM * n_sm)))
    assert max(sizes, default=0) <= max(per_block, 1)
    if fa.backward_persistent(d, dv):
        check_lpt(plan.starts, [s + fa.BWD_UNIT_FIXED for s in sizes], n_sm, sizes)
    else:
        assert plan.starts is None and plan.grid == len(plan.blocks)
        assert sizes == sorted(sizes, reverse=True), "the blocks with the most items launch first"
    return plan


def check_lpt(starts, costs, n_sm, items):
    """A persistent pass's split of its units (in block order, ``costs``
    each) over ``len(starts) - 1`` blocks: ``min(n_sm, units)`` blocks, each
    a contiguous, non-empty run of the list, whose cost (and whose items)
    exceed the even share by at most one unit's; each block's units
    largest first, as the longest-processing-time rule hands them out."""
    grid = len(starts) - 1
    assert grid == max(1, min(n_sm, len(costs)))
    assert starts[0] == 0 and starts[-1] == len(costs)
    assert all(lo < hi for lo, hi in zip(starts, starts[1:])) or not costs
    for values in (costs, items):
        loads = [sum(values[lo:hi]) for lo, hi in zip(starts, starts[1:])]
        assert max(loads) <= -(-sum(values) // grid) + max(costs, default=0)
    for lo, hi in zip(starts, starts[1:]):
        assert costs[lo:hi] == sorted(costs[lo:hi], reverse=True)


def dq_tiles(span):
    """The key tiles a query tile streams, in order, from its
    ``(prefix_tiles, window_tile, end)``: the kernel's loop."""
    prefix_tiles, window_tile, end = span
    return [kt for kt in range(end) if kt < prefix_tiles or kt >= window_tile]


def check_dq_plan(b, h, sq, sk, d, flags, dv=None):
    """The query-tile pass: block i takes query tile ``n_qt - 1 - i // (B
    H)`` of (batch, head) ``i % (B H)``, each once, the last first; each
    streams, in order and once, every key tile its rows see."""
    kw = _flags(flags)
    n_qt = -(-sq // fa.BWD_DQ_ROWS)
    plan = fa.backward_plan(b, h, 1, sq, sk, d, dv=dv, **kw)
    grid = fa.dq_blocks(b, h, sq)
    assert grid == plan.dq_blocks == n_qt * b * h and len(plan.dq_span) == n_qt
    blocks = [(n_qt - 1 - i // (b * h), i % (b * h)) for i in range(grid)]
    assert sorted(blocks) == sorted((qt, bh) for qt in range(n_qt) for bh in range(b * h))
    assert [qt for qt, _ in blocks] == sorted((qt for qt, _ in blocks), reverse=True)
    bn = fa.dq_keys(d, dv)
    pairs = _tile_pairs(_visible(sq, sk, **kw), fa.BWD_DQ_ROWS, bn)
    for qt in range(n_qt):
        tiles = dq_tiles(plan.dq_span[qt])
        assert tiles == sorted(set(tiles)) and all(0 <= t < -(-sk // bn) for t in tiles)
        assert {kt for q, kt in pairs if q == qt} <= set(tiles)
        assert fa.dq_tiles_streamed(plan.dq_span[qt]) == len(tiles)
    if fa.backward_persistent(d, dv):  # every unit exactly once over the persistent grid
        assert sorted(plan.dq_units) == list(range(grid)) and plan.dq_grid == len(plan.dq_starts) - 1
        n_tiles = [len(dq_tiles(plan.dq_span[n_qt - 1 - i // (b * h)])) for i in plan.dq_units]
        check_lpt(plan.dq_starts, [t + fa.BWD_UNIT_FIXED for t in n_tiles], 132, n_tiles)
    else:
        assert plan.dq_units is None and plan.dq_grid == grid


@pytest.mark.parametrize("case", range(len(smoke.FLASH_BWD_SWEEP)))
@pytest.mark.parametrize("n_sm", [132, 7])
def test_flash_key_tile_plan_covers_the_sweep(case, n_sm):
    (b, h, hkv, sq, sk, d, dv), flags = smoke._bwd_shape(smoke.FLASH_BWD_SWEEP[case][0]), \
        smoke.FLASH_BWD_SWEEP[case][1]
    check_key_tile_plan(b, h, hkv, sq, sk, d, flags, n_sm, dv=dv)


@pytest.mark.parametrize("case", range(len(smoke.FLASH_BWD_SWEEP)))
def test_flash_dq_plan_covers_the_sweep(case):
    (b, h, hkv, sq, sk, d, dv), flags = smoke._bwd_shape(smoke.FLASH_BWD_SWEEP[case][0]), \
        smoke.FLASH_BWD_SWEEP[case][1]
    check_dq_plan(b, h, sq, sk, d, flags, dv=dv)


def test_recurrentgemma_key_tile_pass_fills_the_card():
    """recurrentgemma-2b's training shape (10 query heads over one kv head,
    D 256): one block a key tile gave 64 blocks for 132 SMs; the plan
    gives more than 132, and splits every key tile's items."""
    plan = check_key_tile_plan(4, 10, 1, 512, 512, 256, {"window": 2048}, 132)
    assert len(plan.blocks) > 132
    assert len(plan.red) == 4 * 8 and plan.n_slots == len(plan.blocks)


def test_mla_widths_take_the_wide_tiles():
    """MLA's D 192 / Dv 128 run on the (192, 128) instantiation: 64 keys a
    key-tile unit shared by both warpgroups, 64-key tiles in the dQ pass
    (32 only at D 256), both passes persistent; any other Dv != D pair takes
    the same instantiation. deepseek-v2's 128 heads over 128 at its
    training shape need no workspace: 4,096 key-tile units of 1-8 items
    over 132 blocks, each within one unit of the even share."""
    assert fa._wgmma_widths(192, 128) == fa._wgmma_widths(16, 8) == (192, 128)
    assert fa.bwd_keys(192, 128) == fa.bwd_keys(16, 8) == 64 and fa.bwd_keys(128) == 128
    assert fa.dq_keys(192, 128) == fa.dq_keys(16, 8) == 64 and fa.dq_keys(128) == 64
    assert fa.dq_keys(256) == 32
    assert fa.backward_persistent(192, 128) and fa.backward_persistent(16, 8)
    assert not any(fa.backward_persistent(d, d) for d in (64, 128, 256))
    plan = check_key_tile_plan(4, 128, 128, 512, 512, 192, {}, 132, dv=128)
    assert plan.red == [] and plan.n_slots == 0 and len(plan.blocks) == 4 * 128 * 8
    assert plan.grid == 132 and plan.dq_grid == 132 and len(plan.dq_units) == 4 * 128 * 4
    items = [r[5] - r[4] for r in plan.blocks]
    loads = [sum(items[lo:hi]) for lo, hi in zip(plan.starts, plan.starts[1:])]
    assert sum(items) == 4 * 128 * 36 and max(loads) <= -(-sum(items) // 132) + 8
    check_dq_plan(4, 128, 512, 512, 192, {}, dv=128)


@pytest.mark.parametrize("n_sm", [132, 5])
def test_persistent_plan_walks_units_longest_first(n_sm):
    """``lpt_split``: every index once, each bin's indices in decreasing
    cost, the same bins for the same costs, and no bin past the even share
    by more than the largest cost; a split with more bins than units
    leaves the extra bins empty (the wrappers launch ``min(n_sm, units)``
    blocks)."""
    rng = np.random.RandomState(n_sm)
    costs = list(rng.randint(1, 10, size=300))
    bins = fa.lpt_split(costs, n_sm)
    assert bins == fa.lpt_split(costs, n_sm)
    assert sorted(i for b in bins for i in b) == list(range(len(costs)))
    for b in bins:
        assert [costs[i] for i in b] == sorted((costs[i] for i in b), reverse=True)
    loads = [sum(costs[i] for i in b) for b in bins]
    assert max(loads) <= -(-sum(costs) // n_sm) + max(costs)
    assert sum(1 for b in fa.lpt_split([3, 1], n_sm) if b) == 2


def test_minicpm_plan_needs_no_workspace():
    """minicpm-2b's (36 heads over 36, D 64): no key tile has more items
    than a block takes, so every block writes dK and dV itself."""
    plan = check_key_tile_plan(4, 36, 36, 512, 512, 64, {}, 132)
    assert plan.red == [] and plan.n_slots == 0 and len(plan.blocks) == 4 * 36 * 4


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 3), st.integers(1, 4), st.integers(1, 3), st.integers(1, 300),
       st.integers(1, 300), st.sampled_from([(8, 8), (64, 64), (72, 72), (128, 128),
                                             (136, 136), (256, 256), (192, 128), (16, 8)]),
       st.sampled_from([None, 1, 17, 64, 200]), st.integers(-80, 80), st.integers(0, 90),
       st.booleans(), st.sampled_from([1, 5, 132]))
def test_flash_plans_cover_every_visible_item(b, hkv, group, sq, sk, widths, window, q_offset,
                                              prefix_len, causal, n_sm):
    d, dv = widths
    flags = {"causal": causal, "window": window, "q_offset": q_offset,
             "prefix_len": prefix_len}
    check_key_tile_plan(b, hkv * group, hkv, sq, sk, d, flags, n_sm, dv=dv)
    check_dq_plan(b, hkv * group, sq, sk, d, flags, dv=dv)


def check_dw_plan(g, k, n, n_sm):
    """The persistent grid: one block an SM, none without a (group, K
    tile, N tile) tile to take."""
    grid = gm.dw_grid(g, k, n, n_sm)
    k_tiles, n_tiles = -(-k // gm.DW_TILE_K), -(-n // gm.DW_TILE_N)
    assert grid == min(n_sm, g * k_tiles * n_tiles) >= 1


@pytest.mark.parametrize("name", sorted(smoke.GMM_BWD_SWEEP))
@pytest.mark.parametrize("n_sm", [132, 3])
def test_dw_grid_fits_the_sweep(name, n_sm):
    g, k, n, _, tiles = smoke.GMM_BWD_SWEEP[name]
    check_dw_plan(g, k, n, n_sm)


@pytest.mark.parametrize("name", sorted(smoke.GMM_BWD_SWEEP))
def test_dw_sums_each_group_in_tile_order(name):
    """Both dw kernels add a group's tiles in index order (the float32
    path's table lists them so; the wgmma kernel walks ``tile_groups`` in
    order),
    and summing per-tile products in that order is
    ``grouped_matmul_bwd_ref``'s dw bit for bit."""
    from repro_torch.kernels.ref import grouped_matmul_bwd_ref

    g, k, n, bm, tiles = smoke.GMM_BWD_SWEEP[name]
    order, offs = tile_table(list(tiles), g)
    assert offs[0] == 0 and offs[-1] == len(order) == sum(0 <= t < g for t in tiles)
    for grp in range(g):
        assert order[offs[grp]:offs[grp + 1]] == [i for i, t in enumerate(tiles) if t == grp]
    rng = np.random.RandomState(len(name))
    x = torch.from_numpy(rng.randn(len(tiles) * bm, k).astype(np.float32))
    dy = torch.from_numpy(rng.randn(len(tiles) * bm, n).astype(np.float32))
    w = torch.zeros(g, k, n)
    _, dw = grouped_matmul_bwd_ref(x, w, torch.tensor(tiles, dtype=torch.int32), dy, block_m=bm)
    per_tile = torch.einsum("tmk,tmn->tkn", x.reshape(len(tiles), bm, k),
                            dy.reshape(len(tiles), bm, n))
    for grp in range(g):
        acc = torch.zeros(k, n)
        for t in order[offs[grp]:offs[grp + 1]]:
            acc += per_tile[t]
        assert torch.equal(dw[grp], acc)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 50), st.integers(1, 700), st.integers(1, 900), st.integers(1, 140))
def test_dw_grid_fits_every_shape(g, k, n, n_sm):
    check_dw_plan(g, k, n, n_sm)


def check_dx_plan(m, k, block_m, n_sm):
    """The persistent grid: one block an SM, none without a tile; the
    linear index covers every (m-tile, chunk, column tile) exactly once,
    m-tile slowest; each tile's rows lie inside one m-tile; the width is
    one of the kernel's."""
    plan = gm.dx_plan(m, k, block_m, n_sm)
    m_tiles = m // block_m
    assert plan.width in gm.DX_TILE_WIDTHS
    assert plan.chunks == -(-block_m // gm.DX_TILE_M)
    assert plan.col_tiles == -(-k // plan.width)
    assert plan.tiles == m_tiles * plan.chunks * plan.col_tiles
    assert 1 <= plan.grid <= n_sm and plan.grid <= max(1, plan.tiles)
    seen = [plan.tile(i) for i in range(plan.tiles)]
    assert sorted(seen) == seen  # consecutive indices walk one m-tile's tiles together
    assert set(seen) == {(t, c, j) for t in range(m_tiles) for c in range(plan.chunks)
                         for j in range(plan.col_tiles)}
    assert len(set(seen)) == len(seen)
    for t, c, j in seen:
        first = t * block_m + c * gm.DX_TILE_M
        last = min(first + gm.DX_TILE_M, (t + 1) * block_m) - 1
        assert t * block_m <= first <= last < (t + 1) * block_m  # never across an m-tile
        assert j * plan.width < k
    return plan


@pytest.mark.parametrize("name", sorted(smoke.GMM_BWD_SWEEP))
@pytest.mark.parametrize("n_sm", [132, 3])
def test_dx_plan_fits_the_sweep(name, n_sm):
    _, k, _, bm, tiles = smoke.GMM_BWD_SWEEP[name]
    check_dx_plan(len(tiles) * bm, k, bm, n_sm)


@pytest.mark.parametrize("block_m", [1, 8, 70, 512])
@pytest.mark.parametrize("k", [8, 200, 512, 1536])
def test_dx_tiles_stay_in_their_m_tile(block_m, k):
    check_dx_plan(5 * block_m, k, block_m, 132)


def test_dx_plan_at_granites_training_shapes():
    """Both of granite's products on the whole card: 960 tiles of 128 x
    256 for gate / up (K 1536); for down (K 512) 640 tiles of 128 x 128,
    whose last round fills the card better than 320 of 128 x 256 (2.42
    rounds), as the card measured. deepseek-v2's experts (C 96: one
    128-row chunk an m-tile): 3,200 tiles of 128 x 256 at gate / up (K
    5120), 960 at down (K 1536)."""
    want = {"": (256, 960), "down_": (128, 640), "deepseek_": (256, 3200),
            "deepseek_down_": (256, 960)}
    for prefix, (g, k, _, cap) in smoke.GMM_TRAIN.items():
        plan = check_dx_plan(g * cap, k, cap, 132)
        assert (plan.grid, plan.width, plan.tiles) == (132, *want[prefix]), prefix


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 12), st.integers(1, 300), st.integers(1, 700), st.integers(1, 140))
def test_dx_plan_fits_every_shape(m_tiles, block_m, k, n_sm):
    check_dx_plan(m_tiles * block_m, k, block_m, n_sm)


def _scan_bwd_source_constants():
    """The scan backward's channel tile and its workspace's formula, as
    ``csrc/selective_scan.cu`` writes them."""
    import re

    from repro_torch.kernels import selective_scan as ss

    src = ss.SOURCE.read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))
    lanes = int(re.search(r"constexpr int kBwdLanes = (\d+);", src).group(1))
    body = src[src.index('extern "C" long long acs_mamba_scan_bwd_workspace('):]
    formula = re.search(r"return ([^;]+);", body).group(1)
    return threads // lanes, formula


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 5), st.integers(1, 300), st.integers(1, 9000), st.integers(1, 16))
def test_scan_bwd_grid_covers_every_channel(b, s, e, n):
    """The scan backward's Python mirror: its blocks take every (batch row,
    channel) exactly once in tiles of the kernel's ``kBwdChans`` channels,
    batch rows outermost, and its workspace is the size the C entry's
    ``acs_mamba_scan_bwd_workspace`` computes (its return expression,
    evaluated on the same sizes)."""
    from repro_torch.kernels import selective_scan as ss

    chans, formula = _scan_bwd_source_constants()
    assert ss.BWD_CHANNELS == chans
    grid = ss.scan_bwd_grid(b, e)
    seen = [(bi, c) for bi, c0, width in grid for c in range(c0, c0 + width)]
    assert seen == [(bi, c) for bi in range(b) for c in range(e)]
    assert all(0 < width <= chans and c0 % chans == 0 for _, c0, width in grid)
    tiles = -(-e // chans)
    want = eval(formula, {}, {"n_batch": b, "tiles": tiles, "seq": s, "n": n, "ch": e})
    assert ss.scan_bwd_workspace(b, s, e, n) == want


def test_scan_bwd_grid_at_falcons_training_shape():
    """falcon-mamba-7b's training shape [4, 512, 8192], N 16: 1,024 blocks
    of 32 channels, 7.76 waves of one block an SM on 132 SMs; the partial
    db and dc sums 2 x 33.5 MB."""
    from repro_torch.kernels import selective_scan as ss

    assert len(ss.scan_bwd_grid(4, 8192)) == 1024
    floats = ss.scan_bwd_workspace(4, 512, 8192, 16)
    assert floats - 4 * 8192 * 16 - 2 * 4 * 8192 == 2 * 1024 * 16 * 512
    assert 2 * 1024 * 16 * 512 * 4 / 2 / 1e6 == pytest.approx(33.55, abs=0.01)


def _bf16(*shape, offset=0):
    """A contiguous bf16 tensor ``offset`` elements into its buffer."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=torch.bfloat16)[offset:].view(*shape)


def test_flash_backward_path_rule():
    """wgmma where TMA can address every tensor; wgmma on padded copies for
    rows that are not whole 16-byte units or pointers off 16-byte
    alignment; the scalar path for float32."""
    q, k, v, o, do = (_bf16(1, 2, 9, 64) for _ in range(5))
    assert fa.backward_path(q, k, v, o, do) == "wgmma"
    assert fa.backward_path(*(_bf16(1, 2, 9, 24) for _ in range(5))) == "wgmma"
    assert fa.backward_path(*(_bf16(1, 2, 9, 36) for _ in range(5))) == "wgmma_padded"
    assert fa.backward_path(_bf16(1, 2, 9, 64, offset=1), k, v, o, do) == "wgmma_padded"
    assert fa.backward_path(q, k, v, o, _bf16(1, 2, 9, 64, offset=4)) == "wgmma_padded"
    f32 = [t.float() for t in (q, k, v, o, do)]
    assert fa.backward_path(*f32) == "fma_f32"


def test_dw_path_rule():
    x, dy, dw = _bf16(64, 128), _bf16(64, 256), _bf16(2, 128, 256)
    assert gm.dw_path(x, dy, dw) == "wgmma"
    assert gm.dw_path(_bf16(64, 37), _bf16(64, 256), _bf16(2, 37, 256)) == "wgmma_padded"
    assert gm.dw_path(x, _bf16(64, 131), _bf16(2, 128, 131)) == "wgmma_padded"
    assert gm.dw_path(_bf16(64, 128, offset=1), dy, dw) == "wgmma_padded"
    assert gm.dw_path(_bf16(0, 128), _bf16(0, 256), dw) == "wgmma"
    assert gm.dw_path(x, dy, _bf16(gm.DW_MAX_GROUPS + 1, 8, 8)) == "wgmma_padded"
    assert gm.dw_path(x.float(), dy.float(), dw.float()) == "fma_f32"


def test_dx_path_rule():
    """wgmma where TMA can address dy, w and dx, for any number of groups;
    the padded copies for K or N off the 8-element rows or a pointer off
    16-byte alignment; FMAs for float32."""
    dy, w, dx = _bf16(64, 256), _bf16(2, 128, 256), _bf16(64, 128)
    assert gm.dx_path(dy, w, dx) == "wgmma"
    assert gm.dx_path(dy.half(), w.half(), dx.half()) == "wgmma"
    assert gm.dx_path(_bf16(64, 256), _bf16(2, 37, 256), _bf16(64, 37)) == "wgmma_padded"
    assert gm.dx_path(_bf16(64, 131), _bf16(2, 128, 131), dx) == "wgmma_padded"
    assert gm.dx_path(_bf16(64, 256, offset=1), w, dx) == "wgmma_padded"
    assert gm.dx_path(dy, _bf16(2, 128, 256, offset=4), dx) == "wgmma_padded"
    assert gm.dx_path(dy, w, _bf16(64, 128, offset=2)) == "wgmma_padded"
    assert gm.dx_path(_bf16(0, 256), w, _bf16(0, 128)) == "wgmma"
    assert gm.dx_path(_bf16(4, 24), _bf16(gm.DW_MAX_GROUPS + 4, 16, 24), _bf16(4, 16)) == "wgmma"
    assert gm.dx_path(dy.float(), w.float(), dx.float()) == "fma_f32"


def test_wrappers_count_paths_per_call():
    """The path counters start at zero after reset_launches and name every
    path; the launch counters stay one per call (checked on the card)."""
    gm.dx_paths["wgmma"] = gm.dw_paths["wgmma_padded"] = 3
    fa.reset_launches()
    gm.reset_launches()
    assert fa.backward_paths == {"wgmma": 0, "wgmma_padded": 0, "fma_f32": 0}
    assert gm.dx_paths == {"wgmma": 0, "wgmma_padded": 0, "fma_f32": 0}
    assert gm.dw_paths == {"wgmma": 0, "wgmma_padded": 0, "fma_f32": 0}
    assert (gm.launches, gm.dx_launches, gm.dw_launches) == (0, 0, 0)


def test_backward_counts_nothing_on_the_cpu():
    """On the CPU the backward is the plain version: no launch and no path
    is counted, under autograd as well."""
    gm.reset_launches()
    x = torch.randn(16, 8, dtype=torch.bfloat16, requires_grad=True)
    w = torch.randn(2, 8, 16, dtype=torch.bfloat16, requires_grad=True)
    tg = torch.tensor([1, 0], dtype=torch.int32)
    gm.grouped_matmul(x, w, tg, block_m=8).float().sum().backward()
    assert x.grad is not None and w.grad is not None
    assert (gm.launches, gm.dx_launches, gm.dw_launches) == (0, 0, 0)
    assert sum(gm.dx_paths.values()) == sum(gm.dw_paths.values()) == 0


def test_bwd_trace_finds_every_anchor():
    """``bwd_trace`` stamps copies of the backward sources at fixed lines of
    text. Flash's: every line is in the source once (both key-tile
    arrangements, both query-tile passes) and gets its stamp. The scan's:
    each stamp finds exactly one of its lines (the tool's other lines are
    the first design's, for timing a parent tree), and every stamp and the
    readers are in the copy."""
    from repro_torch.kernels import bwd_trace, selective_scan as ss

    text = bwd_trace.stamped_text()
    src = fa.BACKWARD_WGMMA_SOURCE.read_text()
    for pass_, mark, where, alternatives in bwd_trace._ANCHORS:
        for anchor in alternatives:
            assert src.count(anchor) == 1, anchor
            line = anchor.rstrip("\n").split("\n")[-1 if where == "after" else 0]
            stamp = bwd_trace._stamp(pass_, mark, line[:len(line) - len(line.lstrip())])
            assert (anchor + stamp if where == "after" else stamp + anchor) in text
    assert 'extern "C" int acs_trace_read(' in text
    scan_src = ss.SOURCE.read_text()
    scan = bwd_trace.scan_stamped_text()
    for inserted, _, alternatives in bwd_trace._SCAN_ANCHORS:
        assert sum(scan_src.count(a) for a in alternatives) == 1, alternatives[0]
        assert scan.count(inserted) == 1, inserted
    assert 'extern "C" int acs_trace_read(' in scan and 'extern "C" int acs_trace_clear(' in scan


@pytest.mark.parametrize("kernel", ["grouped_matmul", "flash_attention"])
def test_tile_sweep_variants_find_their_lines(kernel):
    """``tile_sweep`` builds each variant from a copy of the source with a
    line of text replaced: every line it replaces is still in the source
    (the forward's launch shapes, once the dx kernel left its template)."""
    from repro_torch.kernels import tile_sweep

    mod, variants = ((tile_sweep.gm, tile_sweep.GMM_VARIANTS) if kernel == "grouped_matmul"
                     else (tile_sweep.fa, tile_sweep.FLASH_VARIANTS))
    text = mod.SOURCE.read_text()
    for name, subs in variants.items():
        for old in subs:
            assert text.count(old) == 1, (name, old)
