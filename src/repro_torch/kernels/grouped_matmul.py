"""Ragged grouped GEMM on the H100 (port of
``repro/kernels/grouped_matmul.py``): many small matrix products in ONE
launch, each row tile against its own group's weights.

``out[t] = x[t] @ w[tile_groups[t // block_m]]`` with ``x [M, K]``,
``w [G, K, N]``, ``tile_groups [M // block_m]`` int32 and the output
``[M, N]`` in ``x``'s dtype, accumulated in float32. It serves the MoE
FFN's three expert products (``models/ffn.py`` ``apply_moe``: the
``[E_pad * C, D]`` capacity layout, ``block_m = C``, one tile per expert)
and any ragged stream of same-shape expert tasks. The kernel is the
hand-written CUDA in ``csrc/grouped_matmul.cu`` (its header says what
bounds it and how it is laid out): any ``block_m >= 1``, any K and N with
no padding copy, tensor cores fed by a 4-stage ``cp.async`` ring for
float16 and bfloat16 (a GEMV-shaped tile for ``block_m <= 16``, 128-row
tiles for prefill), FMAs for float32, and the same bits for the same
inputs run after run.

The wrapper is on the MoE decode step's path 96 times a step, so its host
work is kept short: the C entry point is looked up once, the shape and
dtype checks run once per shape (cached), and the stream handle comes
from PyTorch's raw accessor.

A group id outside ``[0, G)`` never makes the kernel read outside ``w``:
its tile writes nothing and sets an error flag. With ``err=None`` the
wrapper reads the flag after the launch (one host sync) and raises
``ValueError``; a caller that launches many passes its own ``err`` tensor
and calls :func:`raise_on_error` where it synchronizes anyway. On the CPU
the ids are checked before the plain version runs, so both devices refuse
the same inputs.

The entry points are ``torch.library`` ops in the ``repro_torch``
namespace (``grouped_matmul``, ``grouped_matmul_fwd``,
``grouped_matmul_bwd``), each with a fake
implementation and a FLOP formula, so a model traced under
``FakeTensorMode`` reaches them without a build or a launch.

Training: where ``x`` or ``w`` needs a gradient the call is the op
``grouped_matmul_fwd``, whose forward is the same kernel and whose
autograd runs the op ``grouped_matmul_bwd``: ``dx`` (``dy @ w[g]^T``)
and ``dw`` (each group's tiles summed in tile order, deterministic, 0 for
a group no tile names), the hand-written entries of the same ``csrc/grouped_matmul.cu``, counted on
``dx_launches`` and ``dw_launches``; ``tile_groups`` and ``err`` get no
gradient. In bfloat16 and float16 both run on ``wgmma`` with TMA-fed tiles
over a persistent grid, one block an SM. ``dx`` reads dy and w[g] both
K-major in place (no transposed copy of w) over the output tiles of
:func:`dx_plan`, which also picks the tiles' width; ``dw`` reads x and dy
MN-major over the grid of :func:`dw_grid`. Each takes its operands
themselves where TMA can address them (``"wgmma"``), else aligned copies
zero-padded to whole 16-byte rows (``"wgmma_padded"``; ``dw`` a launch for
each run of ``DW_MAX_GROUPS`` groups), by the shape rules :func:`dx_path`
and :func:`dw_path`; float32 runs on FMAs (``"fma_f32"``). ``dx_paths``
and ``dw_paths`` count each call's path. On the CPU the same ops run the
plain forward and the plain backward :func:`~.ref.grouped_matmul_bwd_ref`.

A CPU tensor goes to the plain version :func:`~.ref.grouped_matmul_ref`; a
CUDA tensor launches the kernel or raises. The kernel builds at first use
(``_nvcc.py``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from ._nvcc import NVCC_FLAGS, CudaLibrary, raw_stream
from .ref import grouped_matmul_bwd_ref, grouped_matmul_ref

__all__ = ["grouped_matmul", "grouped_matmul_bwd", "raise_on_error", "build", "launches",
           "dx_launches", "dw_launches", "dx_paths", "dw_paths", "reset_launches", "SOURCE",
           "dx_path", "dx_plan", "DxPlan", "DX_TILE_M", "DX_STEP_N", "DX_TILE_WIDTHS",
           "DX_TILE_FIXED", "dw_path", "dw_grid", "DW_TILE_K", "DW_TILE_N", "DW_STEP_ROWS",
           "DW_MAX_GROUPS"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "grouped_matmul.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# The wgmma dw kernel's tile (csrc/grouped_matmul.cu kDwBM, kDwBN, kDwBK):
# DW_TILE_K rows of K by DW_TILE_N columns of N, contracted DW_STEP_ROWS
# rows of a group's tiles at a time.
DW_TILE_K, DW_TILE_N, DW_STEP_ROWS = 128, 256, 64
DW_MAX_GROUPS = 4096  # kDwMaxGroups
# The wgmma dx kernel's tile (kDxBM, kDxBK): DX_TILE_M rows of one m-tile
# by one of DX_TILE_WIDTHS columns of K (the plan picks), contracted
# DX_STEP_N columns of N at a time.
DX_TILE_M, DX_STEP_N = 128, 64
DX_TILE_WIDTHS = (256, 128)
# A dx tile's time in columns of K: its width plus this much fixed work
# (the epilogue, the ring's fill). On an H100 a 128-wide tile took 0.57 of
# a 256-wide one at both of granite-moe's training shapes (chip_smoke.py
# numbers_gmm_bwd); (128 + 32) / (256 + 32) = 0.56.
DX_TILE_FIXED = 32

# Kernel launches since the last reset_launches(): incremented once per
# launch of the CUDA kernel (the forward), of the dx entry and of the dw
# entry (its table and its product), never by the plain versions;
# dx_paths and dw_paths count each backward call's path.
launches = 0
dx_launches = 0
dw_launches = 0
dx_paths = {"wgmma": 0, "wgmma_padded": 0, "fma_f32": 0}
dw_paths = {"wgmma": 0, "wgmma_padded": 0, "fma_f32": 0}


def reset_launches() -> None:
    global launches, dx_launches, dw_launches
    launches = dx_launches = dw_launches = 0
    for paths in (dx_paths, dw_paths):
        for key in paths:
            paths[key] = 0


def dx_path(dy: torch.Tensor, w: torch.Tensor, dx: torch.Tensor) -> str:
    """dx's path for these contiguous tensors: ``"wgmma"`` for bfloat16 and
    float16 when TMA can address dy ``[M / block_m, block_m, N]``, w
    ``[G, K, N]`` and dx ``[M / block_m, block_m, K]`` (K and N multiples
    of 8, so rows are whole 16-byte units; every pointer 16-byte aligned),
    for any number of groups; ``"wgmma_padded"`` for the other 16-bit
    cases (the same kernel on aligned, padded copies) and ``"fma_f32"``
    for float32."""
    if dy.dtype == torch.float32:
        return "fma_f32"
    if (w.shape[1] % 8 == 0 and w.shape[2] % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (dy, w, dx))):
        return "wgmma"
    return "wgmma_padded"


class DxPlan(NamedTuple):
    """The wgmma dx kernel's work: ``tiles`` output tiles of DX_TILE_M rows
    by ``width`` columns of K, ``chunks`` of them down each m-tile and
    ``col_tiles`` across K, walked by a linear index on ``grid`` persistent
    blocks (block b takes b, b + grid, ...)."""
    grid: int
    width: int
    chunks: int
    col_tiles: int
    tiles: int

    def tile(self, i: int) -> Tuple[int, int, int]:
        """Linear index -> (m-tile, chunk, column tile), the kernel's
        ``dx_tile``: the m-tile slowest, the column tile fastest."""
        per_mtile = self.chunks * self.col_tiles
        return i // per_mtile, (i % per_mtile) // self.col_tiles, i % self.col_tiles


def dx_plan(m: int, k: int, block_m: int, n_sm: int,
            widths: Tuple[int, ...] = DX_TILE_WIDTHS) -> DxPlan:
    """The wgmma dx kernel's persistent grid (one block an SM, no more than
    there are tiles) and tile width. A tile's rows stay inside one m-tile
    (``chunks`` = ceil(block_m / DX_TILE_M) a tile), so each tile has one
    group. The width is the one of ``widths`` (the kernel's
    DX_TILE_WIDTHS) whose busiest block finishes first: ceil(tiles / grid)
    tiles, each taking width + DX_TILE_FIXED; the wider tile wins ties. At
    granite-moe's gate / up product (K 1536) that is 256 (960 tiles, 7.27
    a block), at its down product (K 512) 128 (640 tiles, 4.85 a block,
    where 256 would leave 2.42 and a last round on 56 of 132 SMs)."""
    m_tiles = m // block_m
    chunks = -(-block_m // DX_TILE_M)
    best = None
    for width in widths:
        col_tiles = -(-k // width)
        tiles = m_tiles * chunks * col_tiles
        grid = max(1, min(n_sm, tiles))
        cost = -(-tiles // grid) * (width + DX_TILE_FIXED)
        if best is None or cost < best[0]:
            best = (cost, DxPlan(grid, width, chunks, col_tiles, tiles))
    return best[1]


def dw_path(x: torch.Tensor, dy: torch.Tensor, dw: torch.Tensor) -> str:
    """dw's path for these contiguous tensors: ``"wgmma"`` for bfloat16 and
    float16 when TMA can address x ``[M / block_m, block_m, K]``, dy and
    dw (K and N multiples of 8, so rows are whole 16-byte units; every
    pointer 16-byte aligned) and there are at most ``DW_MAX_GROUPS`` groups
    (the kernel counts their tiles in shared memory), ``"wgmma_padded"``
    for the other 16-bit cases (the same kernel on aligned, padded copies,
    over runs of groups) and ``"fma_f32"`` for float32."""
    if x.dtype == torch.float32:
        return "fma_f32"
    if (x.shape[1] % 8 == 0 and dy.shape[1] % 8 == 0 and dw.shape[0] <= DW_MAX_GROUPS
            and all(t.data_ptr() % 16 == 0 for t in (x, dy, dw))):
        return "wgmma"
    return "wgmma_padded"


def dw_grid(g: int, k: int, n: int, n_sm: int) -> int:
    """The wgmma dw kernel's persistent grid: one block an SM (its shared
    memory allows one), no more than there are (group, K tile, N tile)
    tiles."""
    return max(1, min(n_sm, g * -(-k // DW_TILE_K) * -(-n // DW_TILE_N)))


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.acs_grouped_matmul.argtypes = [
        ptr, ptr, ptr, ptr, ptr,  # x, w, tile_groups, out, err
        i32, i32, i32, i32, i32,  # M, K, N, G, block_m
        i32,                      # dtype
        ptr,                      # stream
    ]
    lib.acs_grouped_matmul.restype = i32
    lib.acs_grouped_matmul_dx.argtypes = [
        ptr, ptr, ptr, ptr, ptr,  # dy, w, tile_groups, dx, err
        i32, i32, i32, i32, i32,  # M, K, N, G, block_m
        i32,                      # dtype
        i32, i32,                 # grid, tile width (16-bit: the plan's)
        ptr,                      # stream
    ]
    lib.acs_grouped_matmul_dx.restype = i32
    lib.acs_grouped_matmul_dw.argtypes = [
        ptr, ptr, ptr,            # x, dy, tile_groups
        ptr, ptr, ptr,            # order, offs (float32's scratch), dw
        i32, i32, i32, i32, i32,  # M, K, N, G, block_m
        i32,                      # dtype
        i32,                      # grid (16-bit)
        ptr,                      # stream
    ]
    lib.acs_grouped_matmul_dw.restype = i32


# Held to its plain version within a tolerance, not bit for bit: it may
# contract multiply-adds.
_LIB = CudaLibrary(SOURCE, _bind, tuple(f for f in NVCC_FLAGS if f != "-fmad=false"))
_ENTRY = None  # the bound C entry point, looked up at the first launch
# (shapes, dtypes, block_m) that passed _check: checked once each.
_CHECKED = set()


def build() -> Tuple[Path, float]:
    """Compile ``csrc/grouped_matmul.cu`` for ``sm_90a`` (once per source
    and flag set). Returns the library's path and the compile's seconds."""
    return _LIB.build()


def raise_on_error(err: torch.Tensor) -> None:
    """Read the kernel's error flag (a host sync) and raise ``ValueError``
    if any launch that shared it met a group id outside ``[0, G)``."""
    if int(err.reshape(-1)[0]) != 0:
        raise ValueError("grouped_matmul: a tile's group id lies outside [0, G)")


def _check(x: torch.Tensor, w: torch.Tensor, tile_groups: torch.Tensor, block_m: int) -> None:
    if x.dim() != 2 or w.dim() != 3 or tile_groups.dim() != 1:
        raise ValueError(f"grouped_matmul: x [M, K], w [G, K, N] and tile_groups [T] "
                         f"expected, got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(tile_groups.shape)}")
    m, k = x.shape
    g, kw, _ = w.shape
    if kw != k or g < 1:
        raise ValueError(f"grouped_matmul: w {tuple(w.shape)} does not match x {tuple(x.shape)}")
    if block_m < 1 or m % block_m:
        raise ValueError(f"grouped_matmul: block_m {block_m} does not divide M {m}")
    if tile_groups.shape[0] != m // block_m:
        raise ValueError(f"grouped_matmul: {tile_groups.shape[0]} tile ids for "
                         f"{m // block_m} tiles of {block_m} rows")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"grouped_matmul: x and w must share one of "
                        f"{sorted(map(str, _DTYPES))}, got {x.dtype}, {w.dtype}")
    if tile_groups.dtype != torch.int32:
        raise TypeError(f"grouped_matmul: tile_groups must be int32, got {tile_groups.dtype}")


def _check_devices(x: torch.Tensor, w: torch.Tensor, tile_groups: torch.Tensor) -> None:
    if w.device != x.device or tile_groups.device != x.device:
        raise ValueError(f"grouped_matmul: w is on {w.device}, tile_groups on "
                         f"{tile_groups.device}, x on {x.device}")


def _forward(x, w, tile_groups, block_m, err):
    """The forward on x's device: the plain version on the CPU (after the
    id check), the kernel on a CUDA tensor."""
    if x.device.type == "cpu":
        _check_devices(x, w, tile_groups)
        if tile_groups.numel() and not bool(((tile_groups >= 0)
                                             & (tile_groups < w.shape[0])).all()):
            raise ValueError("grouped_matmul: a tile's group id lies outside [0, G)")
        return grouped_matmul_ref(x, w, tile_groups, block_m=block_m)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul: unsupported device {x.device}")
    _check_devices(x, w, tile_groups)
    if not (x.is_contiguous() and w.is_contiguous() and tile_groups.is_contiguous()):
        raise ValueError("grouped_matmul: x, w and tile_groups must be contiguous")
    if err.device != x.device or err.dtype != torch.int32 or err.numel() != 1:
        raise ValueError("grouped_matmul: err must be one int32 on x's device")
    m, k = x.shape
    g, _, n = w.shape
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    global _ENTRY, launches
    if _ENTRY is None:
        _ENTRY = _LIB.get().acs_grouped_matmul
    rc = _ENTRY(x.data_ptr(), w.data_ptr(), tile_groups.data_ptr(), out.data_ptr(),
                err.data_ptr(), m, k, n, g, block_m, _DTYPES[x.dtype], raw_stream(x.device))
    if rc != 0:
        raise RuntimeError(f"grouped_matmul kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def grouped_matmul_bwd(x, w, tile_groups, dy, *, block_m, need_dx=True, need_dw=True):
    """The backward: ``(dx [M, K], dw [G, K, N])`` in x's and w's dtypes
    from the forward's inputs and the output's gradient ``dy [M, N]``
    (None for one not needed). On the CPU the plain version; on CUDA
    tensors the dx and dw entries, on the current stream, no sync."""
    if x.device.type == "cpu":
        dx, dw = grouped_matmul_bwd_ref(x, w, tile_groups, dy, block_m=block_m)
        return dx if need_dx else None, dw if need_dw else None
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul_bwd: unsupported device {x.device}")
    key = (x.shape, w.shape, tile_groups.shape, x.dtype, w.dtype, tile_groups.dtype, block_m)
    if key not in _CHECKED:
        _check(x, w, tile_groups, block_m)
        _CHECKED.add(key)
    _check_devices(x, w, tile_groups)
    dy = dy.to(x.dtype).contiguous()
    if dy.shape != (x.shape[0], w.shape[2]) or dy.device != x.device:
        raise ValueError(f"grouped_matmul_bwd: dy {tuple(dy.shape)} on {dy.device} does not "
                         f"match the output [{x.shape[0]}, {w.shape[2]}] on {x.device}")
    x, w, tile_groups = x.contiguous(), w.contiguous(), tile_groups.contiguous()
    m, k = x.shape
    g, _, n = w.shape
    lib = _LIB.get()
    stream = raw_stream(x.device)
    global dx_launches, dw_launches
    dx = dw = None
    if need_dx:  # no error flag: the forward flagged the same ids
        dx = torch.empty_like(x)
        path = dx_path(dy, w, dx)
        if path == "fma_f32":
            rc = lib.acs_grouped_matmul_dx(dy.data_ptr(), w.data_ptr(), tile_groups.data_ptr(),
                                           dx.data_ptr(), None, m, k, n, g, block_m, 0, 0, 0,
                                           stream)
        else:
            rc = _dx_wgmma(lib, dy, w, tile_groups, dx, block_m, path, stream)
        if rc != 0:
            raise RuntimeError(f"grouped_matmul dx launch failed ({path} path): CUDA error {rc}")
        dx_launches += 1
        dx_paths[path] += 1
    if need_dw:
        dw = torch.empty_like(w)
        path = dw_path(x, dy, dw)
        if path == "fma_f32":
            order = torch.empty(m // block_m, dtype=torch.int32, device=x.device)
            offs = torch.empty(g + 1, dtype=torch.int32, device=x.device)
            rc = lib.acs_grouped_matmul_dw(x.data_ptr(), dy.data_ptr(), tile_groups.data_ptr(),
                                           order.data_ptr(), offs.data_ptr(), dw.data_ptr(), m,
                                           k, n, g, block_m, 0, 0, stream)
        else:
            rc = _dw_wgmma(lib, x, dy, tile_groups, dw, block_m, path, stream)
        if rc != 0:
            raise RuntimeError(f"grouped_matmul dw launch failed ({path} path): CUDA error {rc}")
        dw_launches += 1
        dw_paths[path] += 1
    return dx, dw


def _padded(t: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """An aligned copy of ``t`` zero-padded to ``shape``."""
    out = t.new_zeros(shape)
    out[tuple(slice(0, d) for d in t.shape)] = t
    return out


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _dx_wgmma(lib, dy, w, tile_groups, dx, block_m, path, stream) -> int:
    """dx on the wgmma kernel over :func:`dx_plan`'s tiles: on dy and w
    themselves, or (``"wgmma_padded"``) on aligned copies, dy zero-padded
    to a multiple of 8 columns and w to multiples of 8 rows and columns,
    into a dx padded likewise (copied out) where K is not a multiple of 8.
    Returns the C entry's code."""
    m, n = dy.shape
    g, k, _ = w.shape
    out = dx
    if path == "wgmma_padded":
        k8, n8 = -(-k // 8) * 8, -(-n // 8) * 8
        dy, w = _padded(dy, (m, n8)), _padded(w, (g, k8, n8))
        if k8 != k:
            out = dx.new_empty((m, k8))
        k, n = k8, n8
    plan = dx_plan(m, k, block_m, _sm_count(dy.device))
    rc = lib.acs_grouped_matmul_dx(dy.data_ptr(), w.data_ptr(), tile_groups.data_ptr(),
                                   out.data_ptr(), None, m, k, n, g, block_m,
                                   _DTYPES[dy.dtype], plan.grid, plan.width, stream)
    if rc == 0 and out is not dx:
        dx.copy_(out[:, :dx.shape[1]])
    return rc


def _dw_wgmma(lib, x, dy, tile_groups, dw, block_m, path, stream) -> int:
    """dw on the wgmma kernel: on x and dy themselves, or (``"wgmma_padded"``)
    on aligned copies padded to multiples of 8 columns, into a padded dw,
    a launch for each run of ``DW_MAX_GROUPS`` groups (tile ids shifted so
    that each run's groups start at 0; the others name no group of the
    run). Returns the first nonzero code of the C entry, else 0."""
    m, k = x.shape
    g, _, n = dw.shape
    out = dw
    if path == "wgmma_padded":
        k8, n8 = -(-k // 8) * 8, -(-n // 8) * 8
        x, dy = _padded(x, (m, k8)), _padded(dy, (m, n8))
        if (k8, n8) != (k, n):
            out = dw.new_empty((g, k8, n8))
        k, n = k8, n8
    n_sm = _sm_count(x.device)
    for g0 in range(0, g, DW_MAX_GROUPS):
        run = min(DW_MAX_GROUPS, g - g0)
        ids = tile_groups if g0 == 0 else tile_groups - g0
        rc = lib.acs_grouped_matmul_dw(x.data_ptr(), dy.data_ptr(), ids.data_ptr(), None, None,
                                       out[g0:g0 + run].data_ptr(), m, k, n, run, block_m,
                                       _DTYPES[x.dtype], dw_grid(run, k, n, n_sm), stream)
        if rc != 0:
            return rc
    if out is not dw:
        dw.copy_(out[:, :dw.shape[1], :dw.shape[2]])
    return 0


# ---------------------------------------------------------------------------
# The torch.library ops: repro_torch::grouped_matmul (the serving call, its
# error flag a mutated argument), ::grouped_matmul_fwd (the same forward with
# a flag of its own as a second output, which autograd differentiates
# through ::grouped_matmul_bwd: dx and dw, each where its input needs it). Each has the plain
# version on the CPU, the kernel on CUDA (the same builds and counters, no
# fallback), a fake implementation (shapes and dtypes: no build, no launch)
# for FakeTensorMode, and a FLOP formula for the flop counter.
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::grouped_matmul", mutates_args=("err",),
                         device_types="cpu")
def _gmm_op(x: torch.Tensor, w: torch.Tensor, tile_groups: torch.Tensor, err: torch.Tensor,
            block_m: int) -> torch.Tensor:
    return _forward(x, w, tile_groups, block_m, err)


@_gmm_op.register_kernel("cuda")
def _gmm_cuda(x, w, tile_groups, err, block_m):
    return _forward(x, w, tile_groups, block_m, err)


@_gmm_op.register_fake
def _gmm_fake(x, w, tile_groups, err, block_m):
    return x.new_empty((x.shape[0], w.shape[2]))


@torch.library.custom_op("repro_torch::grouped_matmul_fwd", mutates_args=(),
                         device_types="cpu")
def _gmm_fwd_op(x: torch.Tensor, w: torch.Tensor, tile_groups: torch.Tensor,
                block_m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    err = torch.zeros(1, dtype=torch.int32, device=x.device)
    return _forward(x, w, tile_groups, block_m, err), err


@_gmm_fwd_op.register_kernel("cuda")
def _gmm_fwd_cuda(x, w, tile_groups, block_m):
    err = torch.zeros(1, dtype=torch.int32, device=x.device)
    return _forward(x, w, tile_groups, block_m, err), err


@_gmm_fwd_op.register_fake
def _gmm_fwd_fake(x, w, tile_groups, block_m):
    return x.new_empty((x.shape[0], w.shape[2])), x.new_empty((1,), dtype=torch.int32)


@torch.library.custom_op("repro_torch::grouped_matmul_bwd", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _gmm_bwd_op(x: torch.Tensor, w: torch.Tensor, tile_groups: torch.Tensor, dy: torch.Tensor,
                block_m: int, need_dx: bool, need_dw: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    dx, dw = grouped_matmul_bwd(x, w, tile_groups, dy, block_m=block_m, need_dx=need_dx,
                                need_dw=need_dw)
    return (x.new_empty(0) if dx is None else dx), (w.new_empty(0) if dw is None else dw)


@_gmm_bwd_op.register_fake
def _gmm_bwd_fake(x, w, tile_groups, dy, block_m, need_dx, need_dw):
    return (torch.empty_like(x) if need_dx else x.new_empty(0),
            torch.empty_like(w) if need_dw else w.new_empty(0))


def _fwd_setup(ctx, inputs, output):
    x, w, tile_groups, block_m = inputs
    ctx.save_for_backward(x, w, tile_groups)
    ctx.block_m = block_m
    ctx.mark_non_differentiable(output[1])


def _fwd_backward(ctx, dy, _derr):
    x, w, tile_groups = ctx.saved_tensors
    need_dx, need_dw = ctx.needs_input_grad[:2]
    dx, dw = torch.ops.repro_torch.grouped_matmul_bwd.default(
        x, w, tile_groups, dy, ctx.block_m, need_dx, need_dw)
    return (dx if need_dx else None), (dw if need_dw else None), None, None


_gmm_fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup)


def _register_flop_formulas() -> None:
    from torch.utils.flop_counter import register_flop_formula

    def product(x_shape, w_shape, *_, out_shape=None, **__):
        # each row against its group's [K, N]: 2 M K N
        return 2 * x_shape[0] * x_shape[1] * w_shape[2]

    def backward(x_shape, w_shape, tiles_shape, dy_shape, block_m, need_dx, need_dw, *_,
                 out_shape=None, **__):
        return product(x_shape, w_shape) * (int(need_dx) + int(need_dw))

    for op in (torch.ops.repro_torch.grouped_matmul, torch.ops.repro_torch.grouped_matmul_fwd):
        register_flop_formula(op)(product)
    register_flop_formula(torch.ops.repro_torch.grouped_matmul_bwd)(backward)


_register_flop_formulas()


def grouped_matmul(
    x: torch.Tensor,            # [M, K] rows grouped, padded per group to block_m
    w: torch.Tensor,            # [G, K, N]
    tile_groups: torch.Tensor,  # [M // block_m] int32 group id per m-tile
    *,
    block_m: int,
    err: Optional[torch.Tensor] = None,  # [1] int32 error flag the caller checks
) -> torch.Tensor:
    """``[M, N]`` in ``x``'s dtype, float32 inside. Launches on the current
    CUDA stream; without ``err`` it then syncs once to check the group
    ids. Differentiable in ``x`` and ``w`` on both devices (the op
    ``grouped_matmul_fwd``, whose flag is or-ed into ``err``)."""
    key = (x.shape, w.shape, tile_groups.shape, x.dtype, w.dtype, tile_groups.dtype, block_m)
    if key not in _CHECKED:
        _check(x, w, tile_groups, block_m)
        _CHECKED.add(key)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        out, flag = torch.ops.repro_torch.grouped_matmul_fwd.default(x, w, tile_groups, block_m)
        if err is None:
            if x.device.type == "cuda":
                raise_on_error(flag)
        else:
            err.bitwise_or_(flag)
        return out
    if err is None:
        if x.device.type == "cuda":
            own = torch.zeros(1, dtype=torch.int32, device=x.device)
            out = torch.ops.repro_torch.grouped_matmul.default(x, w, tile_groups, own, block_m)
            raise_on_error(own)
            return out
        err = torch.zeros(1, dtype=torch.int32, device=x.device)
    return torch.ops.repro_torch.grouped_matmul.default(x, w, tile_groups, err, block_m)
