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

The wrapper is on the falcon-mamba decode step's path 64 times a step, so
its host path is short: the C entry point is looked up once, the checks
run once per distinct key of shapes, strides, dtypes and devices, and the
key's entry keeps the launch's sizes and strides packed for the C entry, so
a call writes its pointers into one reused array and allocates only its
two outputs.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises. The kernel builds at first use (``_nvcc.py``).
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

from ._nvcc import CudaLibrary, _find_nvcc, raw_stream, refuse_grad
from .ref import mamba_scan_ref, selective_scan_ref

__all__ = ["selective_scan", "mamba_scan", "build", "launches", "reset_launches",
           "launch_config", "sass_per_step", "SOURCE", "MAX_STATE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "selective_scan.cu"
MAX_STATE = 16

# Kernel launches since the last reset_launches(): incremented once per
# launch of the CUDA kernel (either entry), never by the plain versions.
launches = 0

# acs_mamba_scan's variant codes: the plain float32 scan, and the fused
# layer span by model dtype.
PLAIN = 0
FUSED = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}


def reset_launches() -> None:
    global launches
    launches = 0


_CALL = ctypes.c_longlong * 12   # a call's pointers: dt, x, z, b, c, a, dt_bias, d, h0, y, hT, stream
_SIZES = ctypes.c_longlong * 15  # a key's sizes: variant, B, S, E, N, 10 batch and row strides


def _bind(lib: ctypes.CDLL) -> None:
    i64p = ctypes.POINTER(ctypes.c_longlong)
    lib.acs_mamba_scan.argtypes = [i64p, i64p]  # call, sizes
    lib.acs_mamba_scan.restype = ctypes.c_int
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
    if not dt.is_cuda:
        if dt.device.type == "cpu":
            return selective_scan_ref(*args)
        raise ValueError(f"selective_scan: unsupported device {dt.device}")
    refuse_grad("selective_scan", *args)
    ys = torch.empty_like(dt)
    ht = torch.empty_like(h0)
    call = _call()
    call[:11] = (dt.data_ptr(), x.data_ptr(), 0, bmat.data_ptr(), cmat.data_ptr(), a.data_ptr(),
                 0, 0, h0.data_ptr(), ys.data_ptr(), ht.data_ptr())
    _launch(ready, call)
    return ys, ht


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
    is on the current stream, without synchronizing."""
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
    if not dt_raw.is_cuda:
        if dt_raw.device.type == "cpu":
            return mamba_scan_ref(dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0)
        raise ValueError(f"mamba_scan: unsupported device {dt_raw.device}")
    refuse_grad("mamba_scan", dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    ht = torch.empty_like(h0)
    call = _call()
    call[:11] = (dt_raw.data_ptr(), x.data_ptr(), z.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
                 a_log.data_ptr(), dt_bias.data_ptr(), d.data_ptr(), h0.data_ptr(), y.data_ptr(),
                 ht.data_ptr())
    _launch(ready, call)
    return y, ht


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
