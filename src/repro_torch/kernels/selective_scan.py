"""Mamba's selective scan on the H100: the recurrence of the falcon-mamba
layers (``models/recurrent.py`` ``apply_mamba``), in prefill (S = prompt
length) and in every decode step (S = 1), once per layer and forward.

For each step ``t`` and channel ``e``, over ``N`` states::

    h    = exp(dt_t[e] * a[e, :]) * h + (dt_t[e] * x_t[e]) * b_t[:]
    y_t  = sum_n h[n] * c_t[n]

The reference has no kernel for it: it runs ``jax.lax.scan`` over that
step (``repro/models/recurrent.py`` ``apply_mamba``). The kernel is the
hand-written CUDA in ``csrc/selective_scan.cu`` (its header says what
bounds it and how it is laid out): parallel in time, up to 16 lanes a
channel each owning 4 consecutive steps of a 64-step chunk, the N states
looped inside the thread two at a time, the lanes' segments joined by a
warp-shuffle scan of ``(decay product, partial state)`` pairs and each
segment replayed from its true start; ``dt``/``x`` time tiles streamed
through a ``cp.async`` ring; 32 warps an SM at falcon-mamba's prefill;
any B, S, E and N from 1 to 16. A row's results do not depend on B or on
the other rows, and a second launch gives the same bits. Its bound at
falcon-mamba's prefill ``[1, 512, 8192]``, N 16, is the SFUs' 67.1 M
exponentials (0.0161 ms on an H100); its ~20 instructions a state and
step issue at about 60 % of the schedulers' peak. On an H100 80GB HBM3
at 700 W (``chip_smoke.py``): the scan alone in float32 0.072 ms of
device there, the fused bf16 entry 0.093-0.097, S = 128 0.025, a decode
launch 0.005 (0.05-0.07 ms single with this wrapper's host path).

Two entries launch it:

* :func:`mamba_scan`, the models' entry: the whole span of a Mamba layer
  from the ``dt_proj`` output to the gated output in ONE launch, as
  Mamba's own published kernel takes its neighbours:
  ``dt = softplus(dt_raw + dt_bias)``, ``a = -exp(A_log)``, the scan,
  ``y = (ys + D * x) * silu(z)`` in the model dtype. It reads ``z``, ``b``
  and ``c`` through their strides in the model dtype, with no copy. Its
  plain version is :func:`~.ref.mamba_scan_ref`, the eager composition op
  for op.
* :func:`selective_scan`, the scan alone in float32 (the same kernel with
  its prologue and epilogue off), held to :func:`~.ref.selective_scan_ref`.

Both are held to their plain versions within 1e-5 (abs and rel) on the
card, not bit for bit: the carry into a lane's segment comes from the
combine, the state loop's decay is ``ex2.approx`` (within 2 ulp of exp),
and y sums its N terms in another order than the plain version's einsum.
On the CPU each wrapper IS its plain version.

Training and the mesh: :func:`mamba_scan` is the ``torch.library`` op
``repro_torch::mamba_scan``, differentiable through ``::mamba_scan_bwd``
(``register_autograd``); :func:`selective_scan`, which no model calls,
is a ``torch.autograd.Function`` (``_SelectiveScanFunction``). Where an
input needs a gradient, the forward is the same launch, also writing the
carry-in state of each 64-step chunk after the first (``[B, ceil(S / 64)
- 1, E, N]`` float32: 14.7 MB a layer at falcon-mamba-7b's training shape;
the op's third output, as ``flash_attention_lse`` returns its lse, empty
without a gradient), and its backward is the entry ``acs_mamba_scan_bwd``
of the same source (``mamba_scan_bwd``, ``selective_scan_bwd``: the
kernel, which recomputes each chunk from its saved state and runs the
adjoint recurrence in reverse, its warps' db and dc summed once a chunk and
the next chunk's tiles landing while one runs, and a reduction across its
blocks (:func:`scan_bwd_grid`, :func:`scan_bwd_workspace`); counted on
``backward_launches``), held to ``ref.mamba_scan_bwd_ref`` /
``ref.selective_scan_bwd_ref`` within 1e-5 of each gradient's largest
entry in float32. The backward returns dense gradients for z, b and c;
autograd's slicing places them in their wider projections. On the CPU the
same routes run the plain forward (chunk by chunk where the states are
kept: the same bits) and the plain backward. Without a gradient the call
writes no states: the serving call, bit for bit. The ops have fake
implementations (shapes and dtypes: no build, no launch), FLOP formulas
and a DTensor sharding rule: each rank scans its own batch rows or its own
channels, b and c replicated and their gradients partial sums.

The wrapper is on the falcon-mamba decode step's path 64 times a step, so
its host path is short: the C entry point is looked up once, the checks
run once per distinct key of shapes, strides, dtypes and devices, and the
key's entry keeps the launch's sizes and strides packed for the C entry, so
a call writes its pointers into one reused array and allocates only its
outputs.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises. The kernel builds at first use (``_nvcc.py``).
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from ._nvcc import CudaLibrary, _find_nvcc, raw_stream
from .ref import mamba_scan_bwd_ref, mamba_scan_ref, selective_scan_bwd_ref, selective_scan_ref

__all__ = ["selective_scan", "mamba_scan", "selective_scan_fwd", "mamba_scan_fwd",
           "selective_scan_bwd", "mamba_scan_bwd", "build",
           "launches", "backward_launches", "reset_launches", "launch_config", "sass_per_step",
           "SOURCE", "MAX_STATE", "BWD_CHUNK", "BWD_CHANNELS", "scan_bwd_grid",
           "scan_bwd_workspace"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "selective_scan.cu"
MAX_STATE = 16
# The backward's chunk (csrc kBwdSteps): the forward under grad saves the
# carry-in state of each chunk of this many steps after the first.
BWD_CHUNK = 64
# The backward kernel's channel tile (csrc kBwdChans): a block owns this
# many channels of one batch row (16 lanes a channel, 512 threads).
BWD_CHANNELS = 32


def scan_bwd_grid(n_batch: int, ch: int) -> List[Tuple[int, int, int]]:
    """The backward kernel's blocks in launch order, ``(batch row, first
    channel, channels)``: block ``i`` takes batch row ``i // tiles`` and
    channel tile ``i % tiles`` of ``BWD_CHANNELS`` channels (the last one
    ragged), ``tiles = ceil(E / BWD_CHANNELS)``."""
    tiles = -(-ch // BWD_CHANNELS)
    return [(bi, t * BWD_CHANNELS, min(BWD_CHANNELS, ch - t * BWD_CHANNELS))
            for bi in range(n_batch) for t in range(tiles)]


def scan_bwd_workspace(n_batch: int, seq: int, ch: int, n: int) -> int:
    """The backward's float32 workspace in floats (what
    ``acs_mamba_scan_bwd_workspace`` returns): each block's db and dc sums
    over its channels (``[B, tiles, S, N]`` each), each batch row's da
    (``[B, E, N]``), dD and d dt_bias (``[B, E]`` each)."""
    blocks = len(scan_bwd_grid(n_batch, ch))
    return 2 * blocks * n * seq + n_batch * ch * n + 2 * n_batch * ch

# Kernel launches since the last reset_launches(): incremented once per
# launch of the CUDA kernel (either entry), and once per call of the
# backward's entry (its kernel and reduction), never by the plain versions.
launches = 0
backward_launches = 0

# acs_mamba_scan's variant codes: the plain float32 scan, and the fused
# layer span by model dtype.
PLAIN = 0
FUSED = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}


def reset_launches() -> None:
    global launches, backward_launches
    launches = backward_launches = 0


# A call's pointers: dt, x, z, b, c, a, dt_bias, d, h0, y, hT, stream, states.
_CALL = ctypes.c_longlong * 13
_SIZES = ctypes.c_longlong * 15  # a key's sizes: variant, B, S, E, N, 10 batch and row strides
# The backward's pointers: dt, x, z, b, c, a, dt_bias, d, h0, states, dy, dhT, ddt, dx, dz,
# dh0, workspace, db, dc, da, dD, d dt_bias, stream.
_BWD_CALL = ctypes.c_longlong * 23


def _bind(lib: ctypes.CDLL) -> None:
    i64p = ctypes.POINTER(ctypes.c_longlong)
    lib.acs_mamba_scan.argtypes = [i64p, i64p]  # call, sizes
    lib.acs_mamba_scan.restype = ctypes.c_int
    lib.acs_mamba_scan_bwd.argtypes = [i64p, i64p]  # call, sizes
    lib.acs_mamba_scan_bwd.restype = ctypes.c_int
    lib.acs_mamba_scan_bwd_workspace.argtypes = [i64p]  # sizes
    lib.acs_mamba_scan_bwd_workspace.restype = ctypes.c_longlong
    lib.acs_mamba_scan_config.argtypes = [i64p, ctypes.POINTER(ctypes.c_int)]
    lib.acs_mamba_scan_config.restype = ctypes.c_int


_LIB = CudaLibrary(SOURCE, _bind)
_ENTRY = None  # the bound C entry point, looked up at the first launch
# key of the inputs that passed the checks -> (sizes array, device): what a
# launch needs beyond the pointers.
_READY: Dict[tuple, tuple] = {}
_LOCAL = threading.local()  # each thread's call array, reused from call to call


def build() -> Tuple[Path, float]:
    """Compile ``csrc/selective_scan.cu`` for ``sm_90a`` (once per source
    and flag set). Returns the library's path and the compile's seconds."""
    return _LIB.build()


def _sizes(variant: int, n: int, dt, x, z, bmat, cmat) -> "ctypes.Array":
    """The C entry's sizes: variant, B, S, E, N, and the batch and row
    strides of dt, x, z, b and c (None for an unused one)."""
    vals = [variant, *dt.shape, n]
    for t in (dt, x, z, bmat, cmat):
        vals += [0, 0] if t is None else [t.stride(0), t.stride(1)]
    return _SIZES(*vals)


def _check_plain(dt, x, bmat, cmat, a, h0) -> None:
    if dt.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"selective_scan: dt and x must be equal [B, S, E] shapes, "
                         f"got {tuple(dt.shape)} and {tuple(x.shape)}")
    n_batch, seq, ch = dt.shape
    if min(n_batch, seq, ch) < 1:
        raise ValueError(f"selective_scan: empty scan {tuple(dt.shape)}")
    if a.dim() != 2 or a.shape[0] != ch:
        raise ValueError(f"selective_scan: a must be [{ch}, N], got {tuple(a.shape)}")
    n = a.shape[1]
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"selective_scan: state size {n} outside 1..{MAX_STATE}")
    for name, t in (("b", bmat), ("c", cmat)):
        if tuple(t.shape) != (n_batch, seq, n):
            raise ValueError(f"selective_scan: {name} must be [{n_batch}, {seq}, {n}], "
                             f"got {tuple(t.shape)}")
    if tuple(h0.shape) != (n_batch, ch, n):
        raise ValueError(f"selective_scan: h0 must be [{n_batch}, {ch}, {n}], "
                         f"got {tuple(h0.shape)}")
    for name, t in (("dt", dt), ("x", x), ("b", bmat), ("c", cmat), ("a", a), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"selective_scan: {name} must be float32, got {t.dtype}")
        if t.device != dt.device:
            raise ValueError(f"selective_scan: {name} is on {t.device}, dt on {dt.device}")
        if not t.is_contiguous():
            raise ValueError(f"selective_scan: {name} must be contiguous")


def _check_fused(dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0) -> None:
    if dt_raw.dim() != 3:
        raise ValueError(f"mamba_scan: dt_raw must be [B, S, E], got {tuple(dt_raw.shape)}")
    n_batch, seq, ch = dt_raw.shape
    if min(n_batch, seq, ch) < 1:
        raise ValueError(f"mamba_scan: empty scan {tuple(dt_raw.shape)}")
    if dt_raw.dtype not in FUSED:
        raise TypeError(f"mamba_scan: dt_raw must be float32, bfloat16 or float16, "
                        f"got {dt_raw.dtype}")
    if a_log.dim() != 2 or a_log.shape[0] != ch:
        raise ValueError(f"mamba_scan: A_log must be [{ch}, N], got {tuple(a_log.shape)}")
    n = a_log.shape[1]
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"mamba_scan: state size {n} outside 1..{MAX_STATE}")
    model = (("x", x), ("z", z), ("b", bmat), ("c", cmat))
    params = (("dt_bias", dt_bias), ("A_log", a_log), ("D", d), ("h0", h0))
    shapes = {"x": (n_batch, seq, ch), "z": (n_batch, seq, ch), "b": (n_batch, seq, n),
              "c": (n_batch, seq, n), "dt_bias": (ch,), "A_log": (ch, n), "D": (ch,),
              "h0": (n_batch, ch, n)}
    for name, t in model + params:
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"mamba_scan: {name} must be {list(shapes[name])}, "
                             f"got {list(t.shape)}")
        if t.device != dt_raw.device:
            raise ValueError(f"mamba_scan: {name} is on {t.device}, dt_raw on "
                             f"{dt_raw.device}")
    for name, t in model:
        if t.dtype != dt_raw.dtype:
            raise TypeError(f"mamba_scan: {name} must be {dt_raw.dtype} as dt_raw, "
                            f"got {t.dtype}")
    for name, t in params:
        if t.dtype != torch.float32:
            raise TypeError(f"mamba_scan: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"mamba_scan: {name} must be contiguous")
    for name, t in (("dt_raw", dt_raw),) + model:
        if t.stride(2) != 1:
            raise ValueError(f"mamba_scan: {name} must be unit-stride along its last "
                             f"dimension, got strides {t.stride()}")


def _launch(ready, call) -> None:
    """Launch with ``call`` (the pointers, written by the caller; the
    stream is written here) and the key's ``ready`` sizes."""
    global _ENTRY, launches
    if _ENTRY is None:
        _ENTRY = _LIB.get().acs_mamba_scan
    sizes, device = ready
    call[11] = raw_stream(device)
    err = _ENTRY(call, sizes)
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA error {err}")
    launches += 1


def _call() -> "ctypes.Array":
    """This thread's call array."""
    call = getattr(_LOCAL, "call", None)
    if call is None:
        call = _LOCAL.call = _CALL()
    return call


def selective_scan(
    dt: torch.Tensor,    # [B, S, E] step sizes
    x: torch.Tensor,     # [B, S, E] inputs
    bmat: torch.Tensor,  # [B, S, N]
    cmat: torch.Tensor,  # [B, S, N]
    a: torch.Tensor,     # [E, N]
    h0: torch.Tensor,    # [B, E, N] initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ys [B, S, E], hT [B, E, N])``, all float32. The checks of shape,
    dtype, device and contiguity hold on every device; a CUDA launch is on
    the current stream, without synchronizing."""
    args = (dt, x, bmat, cmat, a, h0)
    key = ("plain",) + tuple((t.shape, t.dtype, t.device, t.is_contiguous()) for t in args)
    ready = _READY.get(key)
    if ready is None:
        _check_plain(*args)
        ready = _READY[key] = (_sizes(PLAIN, a.shape[1], dt, x, None, bmat, cmat), dt.device)
    if dt.device.type not in ("cpu", "cuda"):
        raise ValueError(f"selective_scan: unsupported device {dt.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _SelectiveScanFunction.apply(ready, *args)
    return _selective_forward(ready, *args)[:2]


def _states(h0: torch.Tensor, seq: int) -> torch.Tensor:
    """The carry-in states the forward saves under grad: ``[B, chunks - 1,
    E, N]`` float32 for the backward's chunks of ``BWD_CHUNK`` steps."""
    n_batch, ch, n = h0.shape
    return torch.empty((n_batch, max(0, -(-seq // BWD_CHUNK) - 1), ch, n), dtype=torch.float32,
                       device=h0.device)


def selective_scan_fwd(dt, x, bmat, cmat, a, h0):
    """The scan as the backward needs it, no autograd: ``(ys, hT,
    states)``, ``states`` the chunk states ``selective_scan_bwd`` takes
    (None on the CPU)."""
    _check_plain(dt, x, bmat, cmat, a, h0)
    ready = (_sizes(PLAIN, a.shape[1], dt, x, None, bmat, cmat), dt.device)
    return _selective_forward(ready, dt, x, bmat, cmat, a, h0, save=True)


def mamba_scan_fwd(dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0):
    """The fused entry as the backward needs it: ``(y, hT, states)``,
    ``states`` the chunk states ``mamba_scan_bwd`` takes (the op with
    ``save_states``)."""
    return torch.ops.repro_torch.mamba_scan.default(dt_raw, dt_bias, x, z, bmat, cmat, a_log,
                                                    d, h0, True)


def _selective_forward(ready, dt, x, bmat, cmat, a, h0, save=False):
    """``(ys, hT, states or None)``: the plain version on the CPU, else the
    kernel, writing the chunk states when ``save``."""
    if not dt.is_cuda:
        return (*selective_scan_ref(dt, x, bmat, cmat, a, h0), None)
    ys = torch.empty_like(dt)
    ht = torch.empty_like(h0)
    states = _states(h0, dt.shape[1]) if save else None
    call = _call()
    call[:11] = (dt.data_ptr(), x.data_ptr(), 0, bmat.data_ptr(), cmat.data_ptr(), a.data_ptr(),
                 0, 0, h0.data_ptr(), ys.data_ptr(), ht.data_ptr())
    call[12] = states.data_ptr() if states is not None and states.numel() else 0
    _launch(ready, call)
    return ys, ht, states


def _fused_ready(dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0) -> tuple:
    """The fused entry's checks, once per distinct key of shapes, strides,
    dtypes and devices, and the key's ``(sizes, device)`` for a launch."""
    key = (dt_raw.shape, dt_raw.stride(), dt_raw.dtype, dt_raw.device,
           x.shape, x.stride(), x.dtype, x.device,
           z.shape, z.stride(), z.dtype, z.device,
           bmat.shape, bmat.stride(), bmat.dtype, bmat.device,
           cmat.shape, cmat.stride(), cmat.dtype, cmat.device,
           dt_bias.shape, dt_bias.stride(), dt_bias.dtype, dt_bias.device,
           a_log.shape, a_log.stride(), a_log.dtype, a_log.device,
           d.shape, d.stride(), d.dtype, d.device,
           h0.shape, h0.stride(), h0.dtype, h0.device)
    ready = _READY.get(key)
    if ready is None:
        _check_fused(dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0)
        ready = _READY[key] = (_sizes(FUSED[dt_raw.dtype], a_log.shape[1], dt_raw, x, z, bmat,
                                      cmat), dt_raw.device)
    return ready


def mamba_scan(
    dt_raw: torch.Tensor,   # [B, S, E] the dt projection's output, model dtype
    dt_bias: torch.Tensor,  # [E] float32
    x: torch.Tensor,        # [B, S, E] the conv + silu output, model dtype
    z: torch.Tensor,        # [B, S, E] the gate branch (a slice of in_proj's output)
    bmat: torch.Tensor,     # [B, S, N] (a slice of x_proj's output)
    cmat: torch.Tensor,     # [B, S, N] (a slice of x_proj's output)
    a_log: torch.Tensor,    # [E, N] float32
    d: torch.Tensor,        # [E] float32 skip weights
    h0: torch.Tensor,       # [B, E, N] float32 initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y [B, S, E] in the model dtype, hT [B, E, N] float32)``: a Mamba
    layer's ``softplus(dt_raw + dt_bias)``, ``-exp(A_log)``, selective scan,
    ``D`` skip and ``silu(z)`` gate in one launch. dt_raw, x, z, b and c
    share the model dtype (float32, bfloat16 or float16) and unit stride
    along their last dimension (any batch and row strides); the rest is
    float32 and contiguous. The checks hold on every device; a CUDA launch
    is on the current stream, without synchronizing. Under grad the op
    also writes the chunk states its backward reads."""
    if dt_raw.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mamba_scan: unsupported device {dt_raw.device}")
    args = (dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0)
    save = torch.is_grad_enabled() and any(t.requires_grad for t in args)
    y, ht, _ = torch.ops.repro_torch.mamba_scan.default(*args, save)
    return y, ht


def _mamba_forward(ready, dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0, save=False):
    """``(y, hT, states or None)``: the plain version on the CPU, else the
    kernel, writing the chunk states when ``save``."""
    if not dt_raw.is_cuda:
        return (*mamba_scan_ref(dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0), None)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    ht = torch.empty_like(h0)
    states = _states(h0, dt_raw.shape[1]) if save else None
    call = _call()
    call[:11] = (dt_raw.data_ptr(), x.data_ptr(), z.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
                 a_log.data_ptr(), dt_bias.data_ptr(), d.data_ptr(), h0.data_ptr(), y.data_ptr(),
                 ht.data_ptr())
    call[12] = states.data_ptr() if states is not None and states.numel() else 0
    _launch(ready, call)
    return y, ht, states


def _backward(ready, fwd, states, dy, dht, out_dtype):
    """Launch the backward entry for the forward's tensors ``fwd`` (dt, x,
    z, b, c, a, dt_bias, d, h0; None where the variant has none):
    ``(ddt, dx, dz, db, dc, da, dD, d dt_bias, dh0)``, None where the variant
    has none."""
    sizes, device = ready
    dt, x, z, bmat, cmat, a, dt_bias, d, h0 = fwd
    fused = sizes[0] != PLAIN
    n_batch, seq, ch = dt.shape
    n = a.shape[1]
    want = tuple(_states(h0, seq).shape)
    if want[1] and (states is None or tuple(states.shape) != want
                    or states.dtype != torch.float32 or not states.is_contiguous()
                    or states.device != device):
        raise ValueError(f"selective_scan backward: the forward's chunk states must be a "
                         f"contiguous float32 {list(want)} on {device}, got "
                         f"{None if states is None else (list(states.shape), states.dtype)}")
    for name, g, shape in (("dy", dy, (n_batch, seq, ch)), ("dhT", dht, (n_batch, ch, n))):
        if g is not None and (tuple(g.shape) != shape or g.device != device):
            raise ValueError(f"selective_scan backward: {name} must be {list(shape)} on "
                             f"{device}, got {list(g.shape)} on {g.device}")
    dy = torch.zeros((n_batch, seq, ch), dtype=out_dtype, device=device) if dy is None \
        else dy.to(out_dtype).contiguous()
    dht = None if dht is None else dht.float().contiguous()
    ddt, dx = (torch.empty((n_batch, seq, ch), dtype=dt.dtype, device=device) for _ in range(2))
    dz = torch.empty_like(ddt) if fused else None
    db, dc = (torch.empty((n_batch, seq, n), dtype=bmat.dtype, device=device) for _ in range(2))
    da = torch.empty((ch, n), dtype=torch.float32, device=device)
    dd, dbias = ((torch.empty(ch, dtype=torch.float32, device=device) for _ in range(2))
                 if fused else (None, None))
    dh0 = torch.empty_like(h0)
    lib = _LIB.get()
    ws = torch.empty(lib.acs_mamba_scan_bwd_workspace(sizes), dtype=torch.float32, device=device)
    ptr = lambda t: 0 if t is None or t.numel() == 0 else t.data_ptr()  # noqa: E731
    call = _BWD_CALL(*(ptr(t) for t in (dt, x, z, bmat, cmat, a, dt_bias, d, h0, states, dy, dht,
                                         ddt, dx, dz, dh0, ws, db, dc, da, dd, dbias)),
                     raw_stream(device))
    err = lib.acs_mamba_scan_bwd(call, sizes)
    if err != 0:
        raise RuntimeError(f"selective_scan backward launch failed: CUDA error {err}")
    global backward_launches
    backward_launches += 1
    return ddt, dx, dz, db, dc, da, dd, dbias, dh0


def selective_scan_bwd(dt, x, bmat, cmat, a, h0, states, dys, dht=None):
    """The scan's backward: ``(ddt, dx, db, dc, da, dh0)`` float32 from the
    forward's inputs, its saved chunk ``states`` (``_states``; None at
    S <= ``BWD_CHUNK``) and the gradients of ys and hT (either may be None).
    The plain version on the CPU; on CUDA tensors the kernel, on the current
    stream, no sync."""
    if not dt.is_cuda:
        zero = torch.zeros_like(dt) if dys is None else dys
        return selective_scan_bwd_ref(dt, x, bmat, cmat, a, h0, zero, dht)
    _check_plain(dt, x, bmat, cmat, a, h0)
    ready = (_sizes(PLAIN, a.shape[1], dt, x, None, bmat, cmat), dt.device)
    ddt, dx, _, db, dc, da, _, _, dh0 = _backward(
        ready, (dt, x, None, bmat, cmat, a, None, None, h0), states, dys, dht, torch.float32)
    return ddt, dx, db, dc, da, dh0


def mamba_scan_bwd(dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0, states, dy, dht=None):
    """The fused entry's backward: the gradients of ``(dt_raw, dt_bias, x,
    z, b, c, A_log, D, h0)``, each in its input's dtype (b's and c's dense),
    from the forward's inputs, its saved chunk ``states`` and the gradients
    of y and hT (either may be None). The plain version on the CPU; on CUDA
    tensors the kernel, on the current stream, no sync."""
    if dy is None:
        dy = torch.zeros_like(x)
    return torch.ops.repro_torch.mamba_scan_bwd.default(dt_raw, dt_bias, x, z, bmat, cmat,
                                                        a_log, d, h0, states, dy, dht)


class _SelectiveScanFunction(torch.autograd.Function):
    """The scan with its inputs and (on the card) its chunk states saved;
    the backward kernel (the plain backward on the CPU) for the gradient."""

    @staticmethod
    def forward(ctx, ready, dt, x, bmat, cmat, a, h0):
        ys, ht, states = _selective_forward(ready, dt, x, bmat, cmat, a, h0, save=True)
        ctx.save_for_backward(dt, x, bmat, cmat, a, h0, states)
        ctx.set_materialize_grads(False)
        return ys, ht

    @staticmethod
    def backward(ctx, dys, dht):
        dt, x, bmat, cmat, a, h0, states = ctx.saved_tensors
        return (None, *selective_scan_bwd(dt, x, bmat, cmat, a, h0, states, dys, dht))


# ---------------------------------------------------------------------------
# The torch.library ops: repro_torch::mamba_scan (the fused entry; with
# save_states it also returns the chunk states, as flash_attention_lse
# returns its lse, and autograd differentiates it through ::mamba_scan_bwd).
# Each has the plain version on the CPU, the kernel on CUDA (the same
# builds and counters, no fallback), a fake implementation (shapes and
# dtypes: no build, no launch), a FLOP formula and a DTensor sharding rule.
# ---------------------------------------------------------------------------

def _no_states(h0: torch.Tensor) -> torch.Tensor:
    n_batch, ch, n = h0.shape
    return h0.new_empty((n_batch, 0, ch, n))


def _mamba_plain(dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0, save_states):
    """The plain version; with ``save_states`` run chunk by chunk of
    ``BWD_CHUNK`` steps (the same bits: each step is the same eager ops),
    keeping the state each chunk after the first starts from."""
    if not save_states:
        return (*mamba_scan_ref(dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0), _no_states(h0))
    ys, states, h = [], [], h0
    for t0 in range(0, dt_raw.shape[1], BWD_CHUNK):
        if t0:
            states.append(h)
        span = slice(t0, t0 + BWD_CHUNK)
        y, h = mamba_scan_ref(dt_raw[:, span], dt_bias, x[:, span], z[:, span], bmat[:, span],
                              cmat[:, span], a_log, d, h)
        ys.append(y)
    return torch.cat(ys, dim=1), h, torch.stack(states, dim=1) if states else _no_states(h0)


_T = torch.Tensor


@torch.library.custom_op("repro_torch::mamba_scan", mutates_args=(), device_types="cpu")
def _mamba_op(dt_raw: _T, dt_bias: _T, x: _T, z: _T, bmat: _T, cmat: _T, a_log: _T, d: _T,
              h0: _T, save_states: bool) -> Tuple[_T, _T, _T]:
    _fused_ready(dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0)
    return _mamba_plain(dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0, save_states)


@_mamba_op.register_kernel("cuda")
def _mamba_cuda(dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0, save_states):
    ready = _fused_ready(dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0)
    y, ht, states = _mamba_forward(ready, dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0,
                                   save=save_states)
    return y, ht, _no_states(h0) if states is None else states


@_mamba_op.register_fake
def _mamba_fake(dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0, save_states):
    _check_fused(dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0)  # sizes may be symbolic
    states = _states(h0, dt_raw.shape[1]) if save_states else _no_states(h0)
    return x.new_empty(x.shape), h0.new_empty(h0.shape), states


@torch.library.custom_op("repro_torch::mamba_scan_bwd", mutates_args=(), device_types="cpu")
def _mamba_bwd_op(dt_raw: _T, dt_bias: _T, x: _T, z: _T, bmat: _T, cmat: _T, a_log: _T, d: _T,
                  h0: _T, states: _T, dy: _T, dht: Optional[_T]
                  ) -> Tuple[_T, _T, _T, _T, _T, _T, _T, _T, _T]:
    _fused_ready(dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0)
    return mamba_scan_bwd_ref(dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0, dy, dht)


@_mamba_bwd_op.register_kernel("cuda")
def _mamba_bwd_cuda(dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0, states, dy, dht):
    ready = _fused_ready(dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0)
    ddt, dx, dz, db, dc, da, dd, dbias, dh0 = _backward(
        ready, (dt_raw, x, z, bmat, cmat, a_log, dt_bias, d, h0), states, dy, dht, x.dtype)
    return ddt, dbias, dx, dz, db, dc, da, dd, dh0


@_mamba_bwd_op.register_fake
def _mamba_bwd_fake(dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0, states, dy, dht):
    _check_fused(dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0)
    return tuple(t.new_empty(t.shape) for t in (dt_raw, dt_bias, x, z, bmat, cmat, a_log, d,
                                                h0))


def _mamba_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:9], output[2])
    ctx.mark_non_differentiable(output[2])
    ctx.set_materialize_grads(False)


def _mamba_backward(ctx, dy, dht, _dstates):
    *fwd, states = ctx.saved_tensors
    if dy is None:
        dy = torch.zeros_like(fwd[2])
    grads = torch.ops.repro_torch.mamba_scan_bwd.default(*fwd, states, dy, dht)
    return (*grads, None)


_mamba_op.register_autograd(_mamba_backward, setup_context=_mamba_setup)


def _register_flop_formulas() -> None:
    from torch.utils.flop_counter import register_flop_formula

    def forward(dt_shape, bias_shape, x_shape, z_shape, b_shape, *_, out_shape=None, **__):
        # a step, channel and state: dt a, decay h, u b and their sum, h c
        # and its sum (6); a step and channel: u = dt x, the skip D x and
        # its sum, the gate's product (4). exp, softplus and silu are not
        # counted.
        n_batch, seq, ch = dt_shape
        return n_batch * seq * ch * (6 * b_shape[2] + 4)

    def backward(dt_shape, bias_shape, x_shape, z_shape, b_shape, *_, out_shape=None, **__):
        # a step, channel and state: the forward's state and readout again
        # (6), the adjoint g = dy c + G, dc, db, g b, q = g decay h, q a,
        # q dt (2 each) and G = decay g (1); a step and channel: u, dy
        # silu(z), dx, ddt, dz, dD and d dt_raw (15)
        n_batch, seq, ch = dt_shape
        return n_batch * seq * ch * (21 * b_shape[2] + 15)

    register_flop_formula(torch.ops.repro_torch.mamba_scan)(forward)
    register_flop_formula(torch.ops.repro_torch.mamba_scan_bwd)(backward)


_register_flop_formulas()


def _register_sharding() -> None:
    """DTensor rules, one mesh axis at a time: every tensor replicated; the
    batch sharded (the per-channel parameters replicated, their gradients
    partial sums over the batch); or the channels sharded: dt_raw, x, z
    and y ``[B, S, E]`` on dim 2, dt_bias, D and A_log on dim 0, h0, hT and
    dh0 ``[B, E, N]`` on dim 1, the chunk states ``[B, C, E, N]`` on dim 2,
    b and c ``[B, S, N]`` replicated, and their gradients, sums over the
    channels, partial sums. Channels sharded on several axes are this rule
    on each."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    r, s0, s1, s2, part = Replicate(), Shard(0), Shard(1), Shard(2), Partial("sum")
    # inputs in schema order: dt_raw, dt_bias, x, z, b, c, A_log, D, h0
    ins = {"rep": [r] * 9, "batch": [s0, r, s0, s0, s0, s0, r, r, s0],
           "chan": [s2, s0, s2, s2, r, r, s0, s0, s1]}
    grads = {"rep": [r] * 9, "batch": [s0, part, s0, s0, s0, s0, part, part, s0],
             "chan": [s2, s0, s2, s2, part, part, s0, s0, s1]}
    # y, hT, states (and the backward's states, dy, dhT)
    outs = {"rep": [r, r, r], "batch": [s0, s0, s0], "chan": [s2, s1, s2]}

    @register_sharding(torch.ops.repro_torch.mamba_scan.default)
    def _forward_rule(*args):
        return [(outs[k], ins[k] + [None]) for k in ins]

    @register_sharding(torch.ops.repro_torch.mamba_scan_bwd.default)
    def _backward_rule(*args):
        dht = args[11]
        return [(grads[k], ins[k] + [outs[k][2], outs[k][0], None if dht is None else outs[k][1]])
                for k in ins]


_register_sharding()


def launch_config(dtype, n_batch: int, seq: int, ch: int, n: int) -> dict:
    """The launch the kernel takes for these sizes (``dtype`` None for the
    plain float32 scan, else the fused entry's model dtype): grid, threads,
    dynamic shared bytes, lanes a channel, steps a lane and a chunk,
    channels a block, blocks and warps an SM (the occupancy calculator's),
    registers a thread. Needs the card (it builds the library)."""
    out = (ctypes.c_int * 9)()
    sizes = _SIZES(PLAIN if dtype is None else FUSED[dtype], n_batch, seq, ch, n)
    err = _LIB.get().acs_mamba_scan_config(sizes, out)
    if err != 0:
        raise RuntimeError(f"acs_mamba_scan_config failed: CUDA error {err}")
    keys = ("grid", "threads", "smem_bytes", "lanes", "steps_a_lane", "steps_a_chunk",
            "channels_a_block", "blocks_an_sm", "registers")
    cfg = dict(zip(keys, out))
    cfg["warps_an_sm"] = cfg["blocks_an_sm"] * cfg["threads"] // 32
    return cfg


def sass_per_step(lib: Path, kernel: str) -> dict:
    """SASS instructions a state and step of one instance of the kernel
    (its mangled name holds ``kernel``), from ``cuobjdump -sass`` of the
    built library: the instructions of the innermost loop that holds the
    state loop's exponentials (its backward branch's span), over the
    MUFU.EX2 instructions in it (one exponential a state and step), with
    the MUFU count and the loop's length."""
    nvcc = _find_nvcc()
    if nvcc is None:
        raise RuntimeError("cuobjdump needs the CUDA toolkit")
    text = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    body = next((f for f in funcs[1:] if kernel in f.split("\n", 1)[0]), None)
    if body is None:
        raise ValueError(f"no function whose name holds {kernel!r} in {lib.name}")
    instr = []  # (address, text)
    for line in body.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            instr.append((int(m.group(1), 16), m.group(2).strip()))
    exps = [addr for addr, op in instr if "MUFU.EX2" in op]
    best = None
    for addr, op in instr:
        m = re.search(r"\bBRA\b[^;]*?(0x[0-9a-f]+)", op)
        if not m:
            continue
        target = int(m.group(1), 16)
        inside = [e for e in exps if target <= e <= addr]
        if target < addr and len(inside) >= 8 and (best is None or addr - target < best[1] - best[0]):
            best = (target, addr, len(inside))
    if best is None:
        raise ValueError(f"no loop with exponentials in {kernel!r}")
    count = sum(1 for addr, _ in instr if best[0] <= addr <= best[1])
    return {"loop_instructions": count, "loop_exponentials": best[2],
            "instructions_a_state_and_step": count / best[2]}
