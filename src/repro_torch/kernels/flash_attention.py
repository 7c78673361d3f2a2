"""Blocked online-softmax attention (flash attention) on the H100 (port of
``repro/kernels/flash_attention.py``).

Serves every attention prefill of the models (``models/attention.py``
through ``ops.attention``): GQA, a causal mask at a global ``q_offset``
(decode: Sq = 1 against a cache), a sliding ``window``, ``prefix_len``
keys visible to every query, a gemma2-style ``softcap``, a ragged Sk, and
values of another width than the keys (MLA: q and k at D = 192, v at
Dv = 128). The kernel takes Dv == D up to 256, or D up to 192 with Dv up to
128; the wrapper refuses any other pair on every device.
The kernel is the hand-written CUDA in ``csrc/flash_attention.cu`` (its
header says what bounds it and how it is laid out): for bfloat16 and
float16 both products on the tensor cores (``mma.sync``) with keys and
values streamed through a 2-stage ``cp.async`` ring, P rounded to the
input dtype before the PV product as FlashAttention-2 does; float32 (the
tolerance tests) on scalar FMAs. It computes what the
plain version :func:`~.ref.attention_ref` computes, fully masked rows
included (they give 0, where the Pallas kernel gives the row's mean of
``v``).

The entry points are ``torch.library`` ops in the ``repro_torch``
namespace (``flash_attention``, ``flash_attention_lse``,
``flash_attention_bwd``), each with a fake implementation and a FLOP
formula, so a model traced under ``FakeTensorMode`` over a mesh of
DTensors reaches them without a build or a launch.

Training: on tensors that need a gradient the call is the op
``flash_attention_lse``, whose forward is the same kernel, also writing
each row's log-sum-exp, and whose autograd runs the op
``flash_attention_bwd``: on the card the hand-written
``csrc/flash_attention_bwd_wgmma.cu`` (dQ, dK, dV in two deterministic
passes on ``wgmma`` with TMA-fed tiles; every width pair the forward
takes: Dv == D up to ``MAX_BACKWARD_HEAD_DIM`` = 256, and MLA's D 192 with
Dv 128 on an instantiation whose products run over each width) in
bfloat16 and float16: on the tensors themselves where TMA can address
them (``"wgmma"``), else on aligned copies, D and Dv each zero-padded to a
multiple of 8 columns (``"wgmma_padded"``); in float32
``csrc/flash_attention_bwd.cu`` (scalar kernels, ``"fma_f32"``), by the
shape rule :func:`backward_path`.
The wrapper plans the wgmma path's key-tile pass (:func:`backward_plan`:
which unit takes which (query head, query tile) items of which key tile,
and the float32 workspace in which split key tiles' partial sums wait for
their fixed-order reduction) and counts the path of each call in
``backward_paths``. At MLA's widths both passes are persistent
(:func:`backward_persistent`): one block an SM walks a list of units that
:func:`lpt_split` balances, so a key tile's handful of items no longer
pays a block's set-up and epilogue each. Without a gradient the call is the serving call, bit
for bit. On the CPU the ops run the plain versions (``attention_ref``,
``attention_lse_ref``, ``attention_bwd_ref``).

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises. The kernels build at first use (``_nvcc.py``).
"""

from __future__ import annotations

import ctypes
import heapq
from collections import OrderedDict
from pathlib import Path
from typing import List, NamedTuple, Optional, Tuple

import torch

from ._nvcc import NVCC_FLAGS, CudaLibrary, raw_stream
from .ref import attention_bwd_ref, attention_lse_ref, attention_ref

__all__ = ["flash_attention", "flash_attention_lse", "flash_attention_bwd", "build",
           "build_backward", "build_backward_wgmma", "launches", "backward_launches",
           "reset_launches", "SOURCE", "BACKWARD_SOURCE", "BACKWARD_WGMMA_SOURCE",
           "MAX_HEAD_DIM", "MAX_BACKWARD_HEAD_DIM", "kernel_takes",
           "backward_path", "backward_paths", "backward_plan", "BackwardPlan",
           "key_tile_queries", "dq_blocks", "dq_key_span", "dq_keys", "bwd_keys", "BWD_ROWS",
           "BWD_DQ_ROWS", "backward_persistent", "lpt_split", "visible_pairs"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BACKWARD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")  # the float32 path
BACKWARD_WGMMA_SOURCE = SOURCE.with_name("flash_attention_bwd_wgmma.cu")
# The head widths the kernel is instantiated for, written only here: the
# build passes them to csrc/flash_attention.cu as -D defines (kMaxD, kMlaD,
# kMlaDv there). Dv == D up to MAX_HEAD_DIM; for Dv != D, D up to
# MAX_QK_DIM_SPLIT with Dv up to MAX_V_DIM_SPLIT (MLA's 192 and 128).
MAX_HEAD_DIM = 256
MAX_QK_DIM_SPLIT, MAX_V_DIM_SPLIT = 192, 128
# The backward (kMaxD in both of its sources): Dv == D up to this; Dv != D
# on the forward's split widths (kSplitD, kSplitDv: the wgmma path's
# (192, 128) instantiation).
MAX_BACKWARD_HEAD_DIM = 256

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# The attention kernel is held to its plain version within a tolerance, not
# bit for bit, so it may contract multiply-adds.
_FLAGS = (*(f for f in NVCC_FLAGS if f != "-fmad=false"),
          f"-DACS_FLASH_MAX_D={MAX_HEAD_DIM}", f"-DACS_FLASH_SPLIT_D={MAX_QK_DIM_SPLIT}",
          f"-DACS_FLASH_SPLIT_DV={MAX_V_DIM_SPLIT}")
_BACKWARD_FLAGS = (*(f for f in NVCC_FLAGS if f != "-fmad=false"),
                   f"-DACS_FLASH_BWD_MAX_D={MAX_BACKWARD_HEAD_DIM}",
                   f"-DACS_FLASH_SPLIT_D={MAX_QK_DIM_SPLIT}", f"-DACS_FLASH_SPLIT_DV={MAX_V_DIM_SPLIT}")

# The wgmma path's tiles (csrc/flash_attention_bwd_wgmma.cu WgShape, kWgRows):
# the key-tile pass's blocks own bwd_keys(D) keys and take query tiles of
# BWD_ROWS rows; the query-tile pass's blocks own BWD_DQ_ROWS rows and
# stream key tiles of dq_keys(D) keys.
BWD_ROWS, BWD_DQ_ROWS = 64, 128
# The key-tile pass aims at this many blocks an SM: a key tile whose items
# (query head, query tile) exceed the total over that many blocks is split
# over several blocks, whose float32 partial sums a reduction adds in slot
# order.
BWD_BLOCKS_PER_SM = 2
# The persistent passes (MLA's widths, backward_persistent): one block an
# SM, each walking a list of units that lpt_split balances by cost, a
# unit's cost being its items (key-tile pass) or key tiles (dQ pass) plus
# this, for its fixed work (k and v or q and dO landing, the results out).
BWD_UNIT_FIXED = 1

# Kernel launches since the last reset_launches(): incremented once per
# launch of the forward kernel, and once per call of the backward's entry
# (its prologue, passes and reduction), never by the plain version;
# backward_paths counts each call's path.
launches = 0
backward_launches = 0
backward_paths = {"wgmma": 0, "wgmma_padded": 0, "fma_f32": 0}


def reset_launches() -> None:
    global launches, backward_launches
    launches = backward_launches = 0
    for key in backward_paths:
        backward_paths[key] = 0


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.acs_flash_attention.argtypes = [
        ptr, ptr, ptr, ptr,            # q, k, v, o
        ptr,                           # lse or null
        i32, i32, i32, i32, i32, i32,  # B, H, Hkv, Sq, Sk, D
        i32,                           # Dv
        i32, f32, i32,                 # dtype, scale, causal
        i32, i32, i32, f32,            # has_window, window, has_softcap, softcap
        i32, i32,                      # q_offset, prefix_len
        ptr,                           # stream
    ]
    lib.acs_flash_attention.restype = i32


def _bind_backward(lib: ctypes.CDLL) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.acs_flash_attention_bwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr,       # q, k, v, o, dout
        ptr, ptr,                      # lse, di scratch
        ptr, ptr, ptr,                 # dq, dk, dv
        i32, i32, i32, i32, i32, i32,  # B, H, Hkv, Sq, Sk, D
        i32,                           # Dv
        i32, f32, i32,                 # dtype, scale, causal
        i32, i32, i32, f32,            # has_window, window, has_softcap, softcap
        i32, i32,                      # q_offset, prefix_len
        ptr,                           # stream
    ]
    lib.acs_flash_attention_bwd.restype = i32


def _bind_backward_wgmma(lib: ctypes.CDLL) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.acs_flash_attention_bwd_wgmma.argtypes = [
        ptr, ptr, ptr, ptr, ptr,       # q, k, v, o, dout
        ptr, ptr,                      # lse, scratch (Di, lse in the log2 domain)
        ptr, ptr, ptr,                 # dq, dk, dv
        i32, i32, i32, i32, i32, i32,  # B, H, Hkv, Sq, Sk, D
        i32,                           # Dv
        i32, f32, i32,                 # dtype, scale, causal
        i32, i32, i32, f32,            # has_window, window, has_softcap, softcap
        i32, i32,                      # q_offset, prefix_len
        ptr, i32, ptr, i32,            # plan, n_plan, red, n_red
        ptr, i32,                      # ws, n_slots
        ptr,                           # dq_span
        ptr, i32, ptr, ptr, i32,       # starts, grid, dq_units, dq_starts, dq_grid
        ptr,                           # stream
    ]
    lib.acs_flash_attention_bwd_wgmma.restype = i32


_LIB = CudaLibrary(SOURCE, _bind, _FLAGS)
_BACKWARD_LIB = CudaLibrary(BACKWARD_SOURCE, _bind_backward, _BACKWARD_FLAGS)
_BACKWARD_WGMMA_LIB = CudaLibrary(BACKWARD_WGMMA_SOURCE, _bind_backward_wgmma, _BACKWARD_FLAGS)
_ENTRY = None  # the bound C entry points, looked up at the first launch
_BACKWARD_ENTRY = None
_BACKWARD_WGMMA_ENTRY = None


def build() -> Tuple[Path, float]:
    """Compile ``csrc/flash_attention.cu`` for ``sm_90a`` (once per source
    and flag set). Returns the library's path and the compile's seconds."""
    return _LIB.build()


def build_backward() -> Tuple[Path, float]:
    """Compile ``csrc/flash_attention_bwd.cu`` (the float32 path), as
    :func:`build`."""
    return _BACKWARD_LIB.build()


def build_backward_wgmma() -> Tuple[Path, float]:
    """Compile ``csrc/flash_attention_bwd_wgmma.cu``, as :func:`build`."""
    return _BACKWARD_WGMMA_LIB.build()


def kernel_takes(dim: int, dv: int) -> bool:
    """Whether the kernel, forward and backward, has an instantiation for q
    and k of width ``dim`` and v of width ``dv``."""
    if dv == dim:
        return 1 <= dim <= MAX_HEAD_DIM
    return 1 <= dim <= MAX_QK_DIM_SPLIT and 1 <= dv <= MAX_V_DIM_SPLIT


def backward_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                  dout: torch.Tensor) -> str:
    """The backward's path for these tensors (all contiguous):
    ``"wgmma"`` for bfloat16 and float16 when TMA can address every tensor
    (D and Dv multiples of 8, so that each row is whole 16-byte units, and
    every pointer 16-byte aligned), ``"wgmma_padded"`` for the other 16-bit
    cases (the same kernels on aligned copies, D and Dv each zero-padded to
    a multiple of 8 columns) and ``"fma_f32"`` for float32."""
    if q.dtype == torch.float32:
        return "fma_f32"
    if (q.shape[3] % 8 == 0 and v.shape[3] % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v, out, dout))):
        return "wgmma"
    return "wgmma_padded"


def _wgmma_widths(dim: int, dv: int) -> Tuple[int, int]:
    """The wgmma instantiation's padded widths (csrc WgShape<DK, DV>): Dv ==
    D to 64, 128 or 256; Dv != D on the split widths."""
    if dv != dim:
        return MAX_QK_DIM_SPLIT, MAX_V_DIM_SPLIT
    width = 64 if dim <= 64 else 128 if dim <= 128 else 256
    return width, width


def backward_persistent(dim: int, dv: Optional[int] = None) -> bool:
    """Whether the wgmma path runs both passes persistent (csrc
    WgShape::kPersistent): MLA's ``(192, 128)`` instantiation, which every
    Dv != D takes; the Dv == D widths launch a block a unit."""
    return dv is not None and dv != dim


def lpt_split(costs: List[int], n_bins: int) -> List[List[int]]:
    """Longest processing time first: the indices of ``costs``, largest
    cost first (ties by index), each given to the bin with the least load
    so far (ties to the lowest bin); each bin's indices in the order given.
    Deterministic, and no bin's load exceeds ``ceil(sum / n_bins)`` by
    more than the largest cost."""
    heap = [(0, b) for b in range(n_bins)]
    bins: List[List[int]] = [[] for _ in range(n_bins)]
    for i in sorted(range(len(costs)), key=lambda i: (-costs[i], i)):
        load, b = heapq.heappop(heap)
        bins[b].append(i)
        heapq.heappush(heap, (load + costs[i], b))
    return bins


def bwd_keys(dim: int, dv: Optional[int] = None) -> int:
    """Keys a block of the wgmma key-tile pass (csrc WgShape::kKeys): 64 to
    a consumer warpgroup at D, Dv <= 128, 64 shared by both wider (D 256;
    MLA's 192 / 128)."""
    dk_pad, dv_pad = _wgmma_widths(dim, dim if dv is None else dv)
    return 128 if dk_pad <= 128 and dv_pad <= 128 else 64


def key_tile_queries(kt: int, keys: int, sq: int, sk: int, *, causal: bool,
                     window: Optional[int], q_offset: int, prefix_len: int) -> Tuple[int, int]:
    """``(first, count)``: the query tiles of ``BWD_ROWS`` rows that may see
    a key of key tile ``kt`` (``keys`` keys), the causal mask bounding the
    first and the window the last, unless the tile holds a prefix key
    (every row sees those). A superset: the kernel masks each pair."""
    k0 = kt * keys
    keys_here = min(keys, sk - k0)
    n_qt = -(-sq // BWD_ROWS)
    first, end = 0, n_qt
    if k0 >= prefix_len:
        if causal:
            lo = k0 - q_offset  # the first local row that can see key k0
            first = min(n_qt, lo // BWD_ROWS) if lo > 0 else 0
        if window is not None:  # the last local row that can see the tile's last key
            hi = k0 + keys_here - 1 + window - 1 - q_offset
            end = 0 if hi < 0 else min(n_qt, hi // BWD_ROWS + 1)
    return first, max(0, end - first)


class BackwardPlan(NamedTuple):
    """The wgmma path's key-tile pass. ``blocks``: one row a block, in
    launch order, ``(kt, b * Hkv + hk, first query tile, query tiles,
    item_lo, item_hi, slot, 0)``: items ``item_lo .. item_hi - 1`` of key
    tile ``kt``, item ``i`` being query head ``hk * group + i // count`` and
    query tile ``first + i % count``; slot -1 for a key tile's only block
    (it writes dK and dV), else its partial sums' slot in the workspace.
    ``red``: ``(kt, b * Hkv + hk, slot_lo, slot_hi)`` for each key tile the
    reduction writes (split over slots ``slot_lo .. slot_hi - 1``, added in
    that order; none for a key tile no query sees, which gets zeros).
    ``dq_blocks``: the query-tile pass's units (a block each, block ``i``
    taking the unit :func:`dq_blocks` names); ``dq_span``: for each of its
    query tiles, the key tiles it streams (:func:`dq_key_span`).
    Persistent (:func:`backward_persistent`): ``blocks`` lists each grid
    block's units in turn, block ``b`` running ``blocks[starts[b]:starts[b
    + 1]]``; the query-tile pass's block ``b`` runs the units
    ``dq_units[dq_starts[b]:dq_starts[b + 1]]``; both split by
    :func:`lpt_split`. Else ``starts``, ``dq_units`` and ``dq_starts`` are
    None and both passes launch a block a unit."""
    blocks: List[Tuple[int, ...]]
    red: List[Tuple[int, int, int, int]]
    n_slots: int
    dq_blocks: int
    dq_span: List[Tuple[int, int, int]]
    starts: Optional[List[int]] = None
    dq_units: Optional[List[int]] = None
    dq_starts: Optional[List[int]] = None

    @property
    def grid(self) -> int:
        """The key-tile pass's blocks launched."""
        return len(self.blocks) if self.starts is None else len(self.starts) - 1

    @property
    def dq_grid(self) -> int:
        """The query-tile pass's blocks launched."""
        return self.dq_blocks if self.dq_starts is None else len(self.dq_starts) - 1


def backward_plan(n_batch: int, n_heads: int, n_kv_heads: int, sq: int, sk: int, dim: int, *,
                  causal: bool = True, window: Optional[int] = None, q_offset: int = 0,
                  prefix_len: int = 0, n_sm: int = 132, dv: Optional[int] = None
                  ) -> BackwardPlan:
    """Split the key-tile pass (key tiles of ``bwd_keys(dim, dv)`` keys) into
    units so that ``n_sm`` SMs are full: every unit takes at most
    ``ceil(items / (BWD_BLOCKS_PER_SM n_sm))`` items, a key tile's items
    split into contiguous runs in item order, and the units with the most
    items come first. Persistent (:func:`backward_persistent`), the units
    of both passes are then split over ``min(n_sm, units)`` blocks by
    :func:`lpt_split`, each unit costing its items or key tiles plus
    ``BWD_UNIT_FIXED``."""
    group = n_heads // n_kv_heads
    n_kv = n_batch * n_kv_heads
    keys = bwd_keys(dim, dv)
    spans = [key_tile_queries(kt, keys, sq, sk, causal=causal, window=window,
                              q_offset=q_offset, prefix_len=prefix_len)
             for kt in range(-(-sk // keys))]
    total = n_kv * group * sum(count for _, count in spans)
    per_block = max(1, -(-total // (BWD_BLOCKS_PER_SM * n_sm)))
    blocks, red, n_slots = [], [], 0
    for kt, (first, count) in enumerate(spans):
        n_items = group * count
        n_split = -(-n_items // per_block)
        for bhk in range(n_kv):
            if n_split == 1:
                blocks.append((kt, bhk, first, count, 0, n_items, -1, 0))
                continue
            red.append((kt, bhk, n_slots, n_slots + n_split))
            for part in range(n_split):
                blocks.append((kt, bhk, first, count, part * n_items // n_split,
                               (part + 1) * n_items // n_split, n_slots, 0))
                n_slots += 1
    blocks.sort(key=lambda row: row[4] - row[5])  # most items first; stable otherwise
    dq_span = [dq_key_span(qt, sq, sk, dim, causal=causal, window=window, q_offset=q_offset,
                           prefix_len=prefix_len, dv=dv)
               for qt in range(-(-sq // BWD_DQ_ROWS))]
    n_dq = dq_blocks(n_batch, n_heads, sq)
    if not backward_persistent(dim, dv):
        return BackwardPlan(blocks, red, n_slots, n_dq, dq_span)
    bins = lpt_split([row[5] - row[4] + BWD_UNIT_FIXED for row in blocks],
                     max(1, min(n_sm, len(blocks))))
    rows = [blocks[i] for b in bins for i in b]
    starts = [0]
    for b in bins:
        starts.append(starts[-1] + len(b))
    n_qt, n_bh = -(-sq // BWD_DQ_ROWS), n_batch * n_heads
    tiles = [dq_tiles_streamed(dq_span[n_qt - 1 - i // n_bh]) for i in range(n_dq)]
    dq_bins = lpt_split([t + BWD_UNIT_FIXED for t in tiles], max(1, min(n_sm, n_dq)))
    dq_starts = [0]
    for b in dq_bins:
        dq_starts.append(dq_starts[-1] + len(b))
    return BackwardPlan(rows, red, n_slots, n_dq, dq_span, starts,
                        [i for b in dq_bins for i in b], dq_starts)


def dq_tiles_streamed(span: Tuple[int, int, int]) -> int:
    """How many key tiles a query tile of the query-tile pass streams, from
    its :func:`dq_key_span`."""
    prefix_tiles, window_tile, end = span
    return min(prefix_tiles, end) + max(0, end - max(prefix_tiles, window_tile))


def dq_keys(dim: int, dv: Optional[int] = None) -> int:
    """Keys a streamed tile of the wgmma query-tile pass (csrc
    WgShape::kDqKeys): 32 at a padded D of 256, else 64 (MLA's 192 too)."""
    return 32 if _wgmma_widths(dim, dim if dv is None else dv)[0] == 256 else 64


def dq_blocks(n_batch: int, n_heads: int, sq: int) -> int:
    """The wgmma query-tile pass's grid: ``BWD_DQ_ROWS`` rows of one
    (batch, head) a block; block ``i`` takes query tile
    ``n_qt - 1 - i // (B H)`` (the last, which see the most keys, first) of
    ``(batch, head)`` ``i % (B H)``."""
    return -(-sq // BWD_DQ_ROWS) * n_batch * n_heads


def dq_key_span(qt: int, sq: int, sk: int, dim: int, *, causal: bool, window: Optional[int],
                q_offset: int, prefix_len: int, dv: Optional[int] = None
                ) -> Tuple[int, int, int]:
    """``(prefix_tiles, window_tile, end)``: query tile ``qt`` of the
    query-tile pass (``BWD_DQ_ROWS`` rows) streams key tiles of
    ``dq_keys(dim, dv)`` keys ``0 .. prefix_tiles - 1``, then
    ``max(prefix_tiles, window_tile) .. end - 1``, in order (each below
    ``end``): the prefix's tiles always, none past the causal bound and none
    wholly before the window. A superset: the kernel masks each pair."""
    keys = dq_keys(dim, dv)
    q0 = qt * BWD_DQ_ROWS
    row_lo = q_offset + q0
    row_hi = row_lo + min(BWD_DQ_ROWS, sq - q0) - 1
    n_kt = -(-sk // keys)
    end = n_kt
    if causal:
        last = max(row_hi, prefix_len - 1)
        end = 0 if last < 0 else min(n_kt, last // keys + 1)
    window_tile = 0
    if window is not None:
        lo = row_lo - window + 1
        window_tile = lo // keys if lo > 0 else 0
    return -(-prefix_len // keys), window_tile, end


# Device copies of plans, by shape, masks, SM count and device (a training
# run repeats a handful of shapes).
_PLANS: "OrderedDict[tuple, tuple]" = OrderedDict()
_PLAN_CACHE = 64


def _sm_count(device) -> int:
    """The SMs the plans fill (a test narrows it to make the persistent
    passes' blocks walk many units)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _device_plan(q, n_kv, sk, dv, masks):
    n_batch, n_heads, sq, dim = q.shape
    causal, has_window, window, _, _, q_offset, prefix_len = masks
    n_sm = _sm_count(q.device)
    key = (n_batch, n_heads, n_kv, sq, sk, _wgmma_widths(dim, dv), causal, has_window, window,
           q_offset, prefix_len, n_sm, q.device)
    hit = _PLANS.get(key)
    if hit is None:
        plan = backward_plan(n_batch, n_heads, n_kv, sq, sk, dim, causal=bool(causal),
                             window=window if has_window else None, q_offset=q_offset,
                             prefix_len=prefix_len, n_sm=n_sm, dv=dv)
        blocks = torch.tensor(plan.blocks or [[0] * 8], dtype=torch.int32).to(q.device)
        red = torch.tensor(plan.red or [[0] * 4], dtype=torch.int32).to(q.device)
        span = torch.tensor(plan.dq_span, dtype=torch.int32).to(q.device)
        persist = tuple(None if a is None else torch.tensor(a, dtype=torch.int32).to(q.device)
                        for a in (plan.starts, plan.dq_units, plan.dq_starts))
        hit = (blocks, len(plan.blocks), red, len(plan.red), plan.n_slots, span, persist,
               plan.grid, plan.dq_grid)
        _PLANS[key] = hit
        if len(_PLANS) > _PLAN_CACHE:
            _PLANS.popitem(last=False)
    else:
        _PLANS.move_to_end(key)
    return hit


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The CUDA path's checks of shape, dtype, device and contiguity."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"flash_attention: q [B, H, Sq, D], k [B, Hkv, Sk, D] and "
                         f"v [B, Hkv, Sk, Dv] expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    n_batch, n_heads, sq, dim = q.shape
    n_kv = k.shape[1]
    if k.shape[0] != n_batch or k.shape[3] != dim:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if n_kv < 1 or n_heads % n_kv:
        raise ValueError(f"flash_attention: {n_heads} query heads over {n_kv} kv heads")
    if n_batch * n_heads * sq == 0:
        raise ValueError(f"flash_attention: empty query {tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one of "
                        f"{sorted(map(str, _DTYPES))}, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")


def _check_cuda(name: str, q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors only, got {q.device}")


def _masks(causal, window, softcap, q_offset, prefix_len) -> tuple:
    """The mask arguments of both C entries, after the dtype and scale."""
    return (int(causal), int(window is not None), int(window or 0), int(softcap is not None),
            float(softcap or 0.0), int(q_offset), int(prefix_len))


def _scale(scale: Optional[float], dim: int) -> float:
    return float(scale if scale is not None else 1.0 / dim ** 0.5)


def _forward(q, k, v, masks, scale, want_lse: bool):
    """Launch the forward kernel: ``(out, lse or None)``."""
    n_batch, n_heads, sq, dim = q.shape
    _, n_kv, sk, _ = k.shape
    dv = v.shape[3]
    out = torch.empty((n_batch, n_heads, sq, dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((n_batch, n_heads, sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    global _ENTRY, launches
    if _ENTRY is None:
        _ENTRY = _LIB.get().acs_flash_attention
    err = _ENTRY(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        n_batch, n_heads, n_kv, sq, sk, dim, dv, _DTYPES[q.dtype], scale, *masks,
        raw_stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out, lse


def _backward(q, k, v, out, lse, dout, masks, scale):
    """Launch the backward's prologue and passes on the path
    :func:`backward_path` picks: ``(dq, dk, dv)``."""
    dout = dout.contiguous()
    path = backward_path(q, k, v, out, dout)
    dim, dim_v = q.shape[3], v.shape[3]
    if path == "wgmma_padded":  # aligned copies, zero columns up to a multiple of 8
        q, k = (_padded(t, -(-dim // 8) * 8) for t in (q, k))
        v, out, dout = (_padded(t, -(-dim_v // 8) * 8) for t in (v, out, dout))
    n_batch, n_heads, sq, width = q.shape
    _, n_kv, sk, width_v = v.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr())
    shape = (n_batch, n_heads, n_kv, sq, sk, width, width_v, _DTYPES[q.dtype], scale, *masks)
    global _BACKWARD_ENTRY, _BACKWARD_WGMMA_ENTRY, backward_launches
    if path != "fma_f32":
        (plan, n_plan, red, n_red, n_slots, span, persist, grid,
         dq_grid) = _device_plan(q, n_kv, sk, width_v, masks)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        dk_pad, dv_pad = _wgmma_widths(width, width_v)
        ws = torch.empty((2, max(n_slots, 1), bwd_keys(width, width_v), max(dk_pad, dv_pad)),
                         dtype=torch.float32, device=q.device)
        scratch = torch.empty((2, n_batch, n_heads, sq), dtype=torch.float32, device=q.device)
        if _BACKWARD_WGMMA_ENTRY is None:
            _BACKWARD_WGMMA_ENTRY = _BACKWARD_WGMMA_LIB.get().acs_flash_attention_bwd_wgmma
        err = _BACKWARD_WGMMA_ENTRY(
            *args, scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *shape,
            plan.data_ptr(), n_plan, red.data_ptr(), n_red, ws.data_ptr(), n_slots,
            span.data_ptr(), ptr(persist[0]), grid, ptr(persist[1]), ptr(persist[2]), dq_grid,
            raw_stream(q.device))
    else:
        di = torch.empty((n_batch, n_heads, sq), dtype=torch.float32, device=q.device)
        if _BACKWARD_ENTRY is None:
            _BACKWARD_ENTRY = _BACKWARD_LIB.get().acs_flash_attention_bwd
        err = _BACKWARD_ENTRY(*args, di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                              dv.data_ptr(), *shape, raw_stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed ({path} path): "
                           f"CUDA error {err}")
    backward_launches += 1
    backward_paths[path] += 1
    if width != dim:
        dq, dk = (t[..., :dim].contiguous() for t in (dq, dk))
    if width_v != dim_v:
        dv = dv[..., :dim_v].contiguous()
    return dq, dk, dv


def _padded(t: torch.Tensor, width: int) -> torch.Tensor:
    """An aligned copy of ``t`` [..., D] with zero columns up to ``width``."""
    out = t.new_zeros((*t.shape[:-1], width))
    out[..., :t.shape[-1]] = t
    return out


# ---------------------------------------------------------------------------
# The torch.library ops: repro_torch::flash_attention (the serving call),
# ::flash_attention_lse (the forward with its row log-sum-exp, which autograd
# differentiates through ::flash_attention_bwd). Each has the plain version
# on the CPU, the kernel on CUDA (the same builds and counters, no
# fallback), a fake implementation (shapes and dtypes: no build, no launch)
# for FakeTensorMode, and a FLOP formula for the flop counter. DTensors run
# them batch- or head-sharded through their sharding rules.
# ---------------------------------------------------------------------------

_OPT_INT, _OPT_FLOAT = Optional[int], Optional[float]


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(), device_types="cpu")
def _attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                  window: _OPT_INT, softcap: _OPT_FLOAT, scale: float, q_offset: int,
                  prefix_len: int) -> torch.Tensor:
    return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale,
                         q_offset=q_offset, prefix_len=prefix_len)


@_attention_op.register_kernel("cuda")
def _attention_cuda(q, k, v, causal, window, softcap, scale, q_offset, prefix_len):
    _check(q, k, v)
    return _forward(q, k, v, _masks(causal, window, softcap, q_offset, prefix_len), scale,
                    False)[0]


@_attention_op.register_fake
def _attention_fake(q, k, v, causal, window, softcap, scale, q_offset, prefix_len):
    return q.new_empty((*q.shape[:3], v.shape[3]))


@torch.library.custom_op("repro_torch::flash_attention_lse", mutates_args=(),
                         device_types="cpu")
def _attention_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                      window: _OPT_INT, softcap: _OPT_FLOAT, scale: float, q_offset: int,
                      prefix_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    flags = dict(causal=causal, window=window, softcap=softcap, scale=scale,
                 q_offset=q_offset, prefix_len=prefix_len)
    return attention_ref(q, k, v, **flags), attention_lse_ref(q, k, **flags)


@_attention_lse_op.register_kernel("cuda")
def _attention_lse_cuda(q, k, v, causal, window, softcap, scale, q_offset, prefix_len):
    _check(q, k, v)
    return _forward(q, k, v, _masks(causal, window, softcap, q_offset, prefix_len), scale,
                    True)


@_attention_lse_op.register_fake
def _attention_lse_fake(q, k, v, causal, window, softcap, scale, q_offset, prefix_len):
    return (q.new_empty((*q.shape[:3], v.shape[3])),
            q.new_empty(q.shape[:3], dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cpu")
def _attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                      lse: torch.Tensor, dout: torch.Tensor, causal: bool, window: _OPT_INT,
                      softcap: _OPT_FLOAT, scale: float, q_offset: int, prefix_len: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dq, dk, dv = attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, window=window,
                                   softcap=softcap, scale=scale, q_offset=q_offset,
                                   prefix_len=prefix_len)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@_attention_bwd_op.register_kernel("cuda")
def _attention_bwd_cuda(q, k, v, out, lse, dout, causal, window, softcap, scale, q_offset,
                        prefix_len):
    _check(q, k, v)
    return _backward(q, k, v, out.contiguous(), lse.contiguous(), dout,
                     _masks(causal, window, softcap, q_offset, prefix_len), scale)


@_attention_bwd_op.register_fake
def _attention_bwd_fake(q, k, v, out, lse, dout, causal, window, softcap, scale, q_offset,
                        prefix_len):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _lse_setup(ctx, inputs, output):
    q, k, v = inputs[:3]
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.flags = inputs[3:]
    ctx.mark_non_differentiable(lse)


def _lse_backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd.default(q, k, v, out, lse, dout,
                                                                   *ctx.flags)
    return (dq, dk, dv) + (None,) * len(ctx.flags)


_attention_lse_op.register_autograd(_lse_backward, setup_context=_lse_setup)


def visible_pairs(sq: int, sk: int, *, causal: bool, window: Optional[int], q_offset: int,
                  prefix_len: int) -> int:
    """The (query row, key) pairs the mask keeps: what the kernels compute
    over, and what their bounds and FLOP formulas count."""
    import numpy as np

    rows = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(rows, sk - 1) if causal else np.full(sq, sk - 1, dtype=np.int64)
    lo = np.maximum(rows - window + 1, 0) if window is not None else np.zeros(sq, np.int64)
    seen = np.clip(hi - lo + 1, 0, None)
    if prefix_len:  # keys [0, prefix_len) are visible to every row
        p = min(prefix_len, sk)
        overlap = np.clip(np.minimum(hi, p - 1) - lo + 1, 0, None)
        seen = seen + p - overlap
    return int(seen.sum())


def _pairs_flops(q_shape, k_shape, v_shape, causal, window, q_offset, prefix_len, per_pair):
    b, h, sq, d = q_shape
    dv = v_shape[3]
    seen = visible_pairs(sq, k_shape[2], causal=causal, window=window, q_offset=q_offset,
                         prefix_len=prefix_len)
    return per_pair(d, dv) * b * h * seen


def _register_flop_formulas() -> None:
    from torch.utils.flop_counter import register_flop_formula

    def fwd(q_shape, k_shape, v_shape, causal, window, softcap, scale, q_offset, prefix_len,
            *_, out_shape=None, **__):
        # QK^T over D and PV over Dv, 2 FLOPs a multiply-add
        return _pairs_flops(q_shape, k_shape, v_shape, causal, window, q_offset, prefix_len,
                            lambda d, dv: 2 * (d + dv))

    def bwd(q_shape, k_shape, v_shape, out_shape_, lse_shape, dout_shape, causal, window,
            softcap, scale, q_offset, prefix_len, *_, out_shape=None, **__):
        # S, dQ and dK over D; dP and dV over Dv
        return _pairs_flops(q_shape, k_shape, v_shape, causal, window, q_offset, prefix_len,
                            lambda d, dv: 2 * (3 * d + 2 * dv))

    register_flop_formula(torch.ops.repro_torch.flash_attention)(fwd)
    register_flop_formula(torch.ops.repro_torch.flash_attention_lse)(fwd)
    register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)(bwd)


_register_flop_formulas()


def _register_sharding() -> None:
    """DTensor rules: every tensor replicated, or all sharded alike over
    the batch (dim 0) or the heads (dim 1; the caller keeps q's and k's
    heads in step, ``models/attention.py``). The sequence-sharded fallback
    is a ``local_map`` in the caller, which owns the ``q_offset`` shift."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    def rule(n_tensors: int, n_out: int):
        def strategies(*args):
            n_rest = len(args) - n_tensors
            return [([p] * n_out, [p] * n_tensors + [None] * n_rest)
                    for p in (Replicate(), Shard(0), Shard(1))]
        return strategies

    register_sharding(torch.ops.repro_torch.flash_attention.default)(rule(3, 1))
    register_sharding(torch.ops.repro_torch.flash_attention_lse.default)(rule(3, 2))
    register_sharding(torch.ops.repro_torch.flash_attention_bwd.default)(rule(6, 3))


_register_sharding()


def flash_attention(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Sk, D]
    v: torch.Tensor,  # [B, Hkv, Sk, Dv]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
    prefix_len: int = 0,
) -> torch.Tensor:
    """Attention ``[B, H, Sq, Dv]`` in ``q``'s dtype, float32 inside, with
    the scale ``1 / sqrt(D)`` unless given. Launches on the current CUDA
    stream without synchronizing. Under grad the forward also keeps its
    row log-sum-exp and the gradient runs the backward op."""
    if q.dim() == 4 and v.dim() == 4 and not kernel_takes(q.shape[3], v.shape[3]):
        # on every device, so that a model the CPU runs is one the card runs
        raise ValueError(f"flash_attention: no kernel for head dims D {q.shape[3]}, "
                         f"Dv {v.shape[3]}: it takes Dv == D in 1..{MAX_HEAD_DIM}, or D in "
                         f"1..{MAX_QK_DIM_SPLIT} with Dv in 1..{MAX_V_DIM_SPLIT}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    flags = (bool(causal), window, softcap, _scale(scale, q.shape[3]), int(q_offset),
             int(prefix_len))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return torch.ops.repro_torch.flash_attention_lse.default(q, k, v, *flags)[0]
    return torch.ops.repro_torch.flash_attention.default(q, k, v, *flags)


def flash_attention_lse(q, k, v, *, causal=True, window=None, softcap=None, scale=None,
                        q_offset=0, prefix_len=0):
    """The forward kernel with its row log-sum-exp: ``(out, lse [B, H, Sq]
    float32)``, -inf for a row that sees no key. CUDA tensors only."""
    _check_cuda("flash_attention_lse", q)
    return torch.ops.repro_torch.flash_attention_lse.default(
        q, k, v, bool(causal), window, softcap, _scale(scale, q.shape[3]), int(q_offset),
        int(prefix_len))


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True, window=None, softcap=None,
                        scale=None, q_offset=0, prefix_len=0):
    """The backward kernel alone: ``(dq, dk, dv)`` in q's dtype from the
    forward's ``out`` and ``lse`` and the output's gradient ``dout``. CUDA
    tensors only (the plain version is ``ref.attention_bwd_ref``)."""
    _check_cuda("flash_attention_bwd", q)
    if not kernel_takes(q.shape[3], v.shape[3]):
        raise ValueError(f"flash_attention_bwd: no instantiation for D {q.shape[3]}, "
                         f"Dv {v.shape[3]}")
    return torch.ops.repro_torch.flash_attention_bwd.default(
        q, k, v, out, lse, dout, bool(causal), window, softcap, _scale(scale, q.shape[3]),
        int(q_offset), int(prefix_len))
