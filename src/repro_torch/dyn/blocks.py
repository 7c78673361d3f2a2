"""Small-CNN kernel library for the dynamic/static DNN workloads (PyTorch
port of ``repro/dyn/blocks.py``).

Each kernel is an :class:`AcsKernel` over NCHW tensors (batch 1, small
feature maps — the paper's "<200 CTAs" regime, Fig 8). Weights are
read-only buffers: reads never hazard against reads, so weight sharing
does not serialize independent branches.

Convolutions are ``torch.nn.functional.conv2d``, the counterpart of the
reference's ``jax.lax.conv_general_dilated``, which runs outside any Pallas
kernel. XLA's ``"SAME"`` padding is asymmetric under a stride (the extra
row and column go to the high side) and its average ``reduce_window``
divides by ``k*k``, counting the padding; PyTorch's symmetric ``padding=``
is neither, so every conv and pool here pads explicitly to XLA's amounts
(:func:`same_pads`): zeros for convs and the average pool, ``-inf`` for the
max pool.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.buffers import Buffer, BufferPool
from ..core.task import operand_shape
from ..core.wrapper import AcsKernel, TaskStream

__all__ = [
    "conv", "dwconv", "pool_avg", "pool_max", "add2", "add3", "concat2",
    "dense", "gap", "mix_weights", "upsample2", "init_conv", "init_dense", "DynParams",
    "launch_conv", "launch_add", "conv_flops", "same_pads",
    "DYN_KERNELS", "SWITCH_BRANCHES", "register_device_kernels",
]


# -- kernel bodies -----------------------------------------------------------

def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis: ``(low, high)``, the
    total ``max((out - 1) * stride + k - size, 0)`` for ``out =
    ceil(size / stride)``, the low side taking ``total // 2``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0) -> torch.Tensor:
    h_lo, h_hi = same_pads(x.shape[-2], k, stride)
    w_lo, w_hi = same_pads(x.shape[-1], k, stride)
    if h_lo == h_hi == w_lo == w_hi == 0:
        return x
    return F.pad(x, (w_lo, w_hi, h_lo, h_hi), value=value)


def _conv_fn(x, w, stride, relu):
    out = F.conv2d(_pad_same(x, w.shape[-1], stride), w, stride=stride)
    return torch.relu(out) if relu else out


def _dwconv_fn(x, w, stride, relu):
    out = F.conv2d(_pad_same(x, w.shape[-1], stride), w, stride=stride, groups=x.shape[1])
    return torch.relu(out) if relu else out


def _pool_fn(x, kind, k, stride):
    if kind == "avg":  # XLA's window sum over zero padding, / k*k
        return F.avg_pool2d(_pad_same(x, k, stride), k, stride)
    return F.max_pool2d(_pad_same(x, k, stride, value=float("-inf")), k, stride)


def _add2_fn(a, b):
    return a + b


def _add3_fn(a, b, c):
    return a + b + c


def _concat2_fn(a, b):
    return torch.cat([a, b], dim=1)


def _dense_fn(x, w):
    return x @ w


def _gap_fn(x):
    return torch.mean(x, dim=(2, 3))


def _mix_weights_fn(experts, r):
    """CondConv: example-dependent weights = Σ_e σ(r_e) · W_e.
    experts [E, O, I, kh, kw]; r [1, E] -> [O, I, kh, kw]."""
    return torch.einsum("e,eoihw->oihw", torch.sigmoid(r[0]), experts)


def _upsample2_fn(x):
    """Nearest-neighbour 2x upsample (NCHW)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def conv_flops(inputs, outputs, *static):
    ws, os_ = operand_shape(inputs[1]), operand_shape(outputs[0])
    return 2.0 * np.prod(os_, dtype=np.float64) * ws[1] * ws[-2] * ws[-1]


conv = AcsKernel(name="conv", fn=_conv_fn, flops=conv_flops)
dwconv = AcsKernel(name="dwconv", fn=_dwconv_fn, flops=conv_flops)
pool_avg = AcsKernel(name="pool_avg", fn=lambda x, k, s: _pool_fn(x, "avg", k, s))
pool_max = AcsKernel(name="pool_max", fn=lambda x, k, s: _pool_fn(x, "max", k, s))
add2 = AcsKernel(name="add2", fn=_add2_fn)
add3 = AcsKernel(name="add3", fn=_add3_fn)
concat2 = AcsKernel(name="concat2", fn=_concat2_fn)
dense = AcsKernel(name="dense", fn=_dense_fn,
                  flops=lambda i, o, *s: 2.0 * np.prod((i[0].shape[0], i[1].shape[0], i[1].shape[1]),
                                                       dtype=np.float64))
gap = AcsKernel(name="gap", fn=_gap_fn)
mix_weights = AcsKernel(name="mix_weights", fn=_mix_weights_fn)
upsample2 = AcsKernel(name="upsample2", fn=_upsample2_fn)

#: Every kernel the dyn/static DNN builders can emit — the fixed opcode set
#: the device window needs registered ahead of time.
DYN_KERNELS = (conv, dwconv, pool_avg, pool_max, add2, add3, concat2,
               dense, gap, mix_weights, upsample2)

#: The device kernels' branch table: only the row-shape-preserving
#: elementwise kernels qualify. Even these never reach the ready-queue or
#: wave kernel here: both take only padding-free 1-D rows of one shape
#: class (``core/device_dispatch.py`` ``_loop_kernel_parts``,
#: ``_wave_kernel_parts``) and a dyn stream's rows are NCHW maps of many
#: classes. So a dyn epoch runs on the device window's step path (wave and
#: frontier plans) or the loop interpreter, as in the reference.
SWITCH_BRANCHES = {"add2": _add2_fn, "add3": _add3_fn}


def register_device_kernels(registry) -> Dict[str, int]:
    """Register the CNN kernel set with a
    :class:`~repro_torch.core.DeviceOpRegistry` (fn-less: the arena path
    runs each task's own fn). Returns name -> opcode."""
    for name, fn in SWITCH_BRANCHES.items():
        registry.register_switch_branch(name, fn)
    return {k.name: registry.register(k.name) for k in DYN_KERNELS}


def launch_upsample2(stream: TaskStream, pool: BufferPool, x: Buffer) -> Buffer:
    out = pool.alloc((x.shape[0], x.shape[1], x.shape[2] * 2, x.shape[3] * 2), np.float32)
    upsample2.launch(stream, inputs=(x,), outputs=(out,))
    return out


# -- parameter helpers --------------------------------------------------------

@dataclasses.dataclass
class DynParams:
    """Named weight buffers for one network instance. Weights are drawn
    with numpy's ``RandomState`` in the reference's order, so a seed gives
    the reference's arrays."""

    pool: BufferPool
    weights: Dict[str, Buffer] = dataclasses.field(default_factory=dict)

    def conv_w(self, name: str, cout: int, cin: int, k: int, rng) -> Buffer:
        if name not in self.weights:
            self.weights[name] = self.pool.from_array(init_conv(rng, cout, cin, k), name=name)
        return self.weights[name]

    def dense_w(self, name: str, din: int, dout: int, rng) -> Buffer:
        if name not in self.weights:
            self.weights[name] = self.pool.from_array(init_dense(rng, din, dout), name=name)
        return self.weights[name]

    def raw(self, name: str, arr) -> Buffer:
        if name not in self.weights:
            self.weights[name] = self.pool.from_array(np.asarray(arr), name=name)
        return self.weights[name]


def init_conv(rng, cout, cin, k):
    return (rng.randn(cout, cin, k, k) * np.sqrt(2.0 / (cin * k * k))).astype(np.float32)


def init_dense(rng, din, dout):
    return (rng.randn(din, dout) / np.sqrt(din)).astype(np.float32)


# -- launch helpers ------------------------------------------------------------

def launch_conv(stream: TaskStream, pool: BufferPool, x: Buffer, w: Buffer,
                *, stride: int = 1, relu: bool = True, depthwise: bool = False) -> Buffer:
    cout = w.shape[0] if not depthwise else x.shape[1]
    h = -(-x.shape[2] // stride)
    wd = -(-x.shape[3] // stride)
    out = pool.alloc((x.shape[0], cout, h, wd), np.float32)
    kern = dwconv if depthwise else conv
    kern.launch(stream, inputs=(x, w), outputs=(out,), static_args=(stride, relu))
    return out


def launch_pool(stream: TaskStream, pool: BufferPool, x: Buffer, *, kind: str = "avg",
                k: int = 3, stride: int = 1) -> Buffer:
    h = -(-x.shape[2] // stride)
    w = -(-x.shape[3] // stride)
    out = pool.alloc((x.shape[0], x.shape[1], h, w), np.float32)
    (pool_avg if kind == "avg" else pool_max).launch(
        stream, inputs=(x,), outputs=(out,), static_args=(k, stride)
    )
    return out


def launch_add(stream: TaskStream, pool: BufferPool, xs) -> Buffer:
    xs = list(xs)
    if len(xs) == 1:
        return xs[0]
    acc = xs[0]
    i = 1
    while i < len(xs):
        take = xs[i: i + 2]
        out = pool.alloc(tuple(acc.shape), np.float32)
        if len(take) == 2:
            add3.launch(stream, inputs=(acc, take[0], take[1]), outputs=(out,))
            i += 2
        else:
            add2.launch(stream, inputs=(acc, take[0]), outputs=(out,))
            i += 1
        acc = out
    return acc


def launch_concat(stream: TaskStream, pool: BufferPool, a: Buffer, b: Buffer) -> Buffer:
    out = pool.alloc((a.shape[0], a.shape[1] + b.shape[1], a.shape[2], a.shape[3]), np.float32)
    concat2.launch(stream, inputs=(a, b), outputs=(out,))
    return out


def launch_classifier(stream: TaskStream, pool: BufferPool, x: Buffer, params: DynParams,
                      n_classes: int, rng) -> Buffer:
    """Global average pool, then the dense classifier. Its weights are
    drawn from ``rng`` at the first build, as the reference draws them."""
    pooled = pool.alloc((x.shape[0], x.shape[1]), np.float32)
    gap.launch(stream, inputs=(x,), outputs=(pooled,))
    w = params.dense_w("classifier", x.shape[1], n_classes, rng)
    logits = pool.alloc((x.shape[0], n_classes), np.float32)
    dense.launch(stream, inputs=(pooled, w), outputs=(logits,))
    return logits
