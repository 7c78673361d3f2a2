"""CondConv-like mixture-of-experts CNN (paper §V: 4 experts, efficientnet
backbone; PyTorch port of ``repro/dyn/condconv.py``). Convolution weights are computed *at runtime* per example:
w(x) = Σ_e σ(r_e(x)) · W_e. The weight-mixing kernels and the convs that
consume them form runtime RAW dependencies that ACS tracks through the
segment checks — and the router/mix/conv kernels of different blocks are
independent, giving ACS concurrency to harvest.
"""

from __future__ import annotations

import numpy as np

from ..core.buffers import Buffer, BufferPool, DeviceLike
from ..core.wrapper import TaskStream
from .blocks import (
    DynParams,
    dense,
    gap,
    launch_classifier,
    launch_conv,
    mix_weights,
)

N_EXPERTS = 4
N_BLOCKS = 4
CH = 16
IMG = 32
N_CLASSES = 10


def init_condconv(seed: int = 0, device: DeviceLike = "cuda") -> DynParams:
    rng = np.random.RandomState(seed)
    params = DynParams(BufferPool(device))
    params.conv_w("stem", CH, 3, 3, rng)
    for b in range(N_BLOCKS):
        cin = CH
        # expert bank for the block's 3x3 conv: [E, O, I, 3, 3]
        bank = (rng.randn(N_EXPERTS, cin, cin, 3, 3) * np.sqrt(2.0 / (cin * 9))).astype(
            np.float32
        )
        params.raw(f"b{b}_bank", bank)
        params.dense_w(f"b{b}_router", cin, N_EXPERTS, rng)
        params.conv_w(f"b{b}_pw", cin, cin, 1, rng)
    params._rng = rng
    return params


def build_condconv(params: DynParams, stream: TaskStream, x_value) -> Buffer:
    pool = params.pool
    rng = params._rng
    x = pool.from_array(x_value)
    h = launch_conv(stream, pool, x, params.weights["stem"], stride=2)

    for b in range(N_BLOCKS):
        cin = h.shape[1]
        # router: gap -> dense -> routing logits (value-level input dependence)
        feat = pool.alloc((1, cin), np.float32)
        gap.launch(stream, inputs=(h,), outputs=(feat,))
        r = pool.alloc((1, N_EXPERTS), np.float32)
        dense.launch(stream, inputs=(feat, params.weights[f"b{b}_router"]), outputs=(r,))
        # mix expert weights for THIS example (runtime weight buffer)
        mixed = pool.alloc((cin, cin, 3, 3), np.float32)
        mix_weights.launch(
            stream, inputs=(params.weights[f"b{b}_bank"], r), outputs=(mixed,)
        )
        # conv with the example-dependent weights + residual pointwise conv
        hc = launch_conv(stream, pool, h, mixed)
        h = launch_conv(stream, pool, hc, params.weights[f"b{b}_pw"])
    return launch_classifier(stream, pool, h, params, N_CLASSES, rng)


def random_input(rng: np.random.RandomState):
    return rng.randn(1, 3, IMG, IMG).astype(np.float32)
