"""InstaNAS-like instance-aware dynamic CNN (paper §II-C, Fig 6b; I-NAS in §V;
PyTorch port of ``repro/dyn/instanas.py``).

A controller inspects the input and, per stage, activates a subset of
candidate blocks; active block outputs are summed. The computational graph
therefore differs per image — the defining property ACS targets. The
controller here is a cheap deterministic function of input statistics
(regional means), standing in for InstaNAS's learned policy: what matters
for the systems evaluation is that the kernel stream is input-dependent.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..core.buffers import Buffer, BufferPool, DeviceLike
from ..core.wrapper import TaskStream
from .blocks import DynParams, launch_add, launch_classifier, launch_conv

N_STAGES = 4
N_CANDIDATES = 4
CHANNELS = 16
IMG = 32
N_CLASSES = 10


def init_instanas(seed: int = 0, device: DeviceLike = "cuda") -> DynParams:
    rng = np.random.RandomState(seed)
    params = DynParams(BufferPool(device))
    params.conv_w("stem", CHANNELS, 3, 3, rng)
    for s in range(N_STAGES):
        cin = CHANNELS * (2 ** min(s, 2))
        cout = cin
        # candidates: conv3x3, conv5x5, conv1x1, dw3x3+pw1x1
        params.conv_w(f"s{s}_c0", cout, cin, 3, rng)
        params.conv_w(f"s{s}_c1", cout, cin, 5, rng)
        params.conv_w(f"s{s}_c2", cout, cin, 1, rng)
        params.conv_w(f"s{s}_c3dw", cin, 1, 3, rng)
        params.conv_w(f"s{s}_c3pw", cout, cin, 1, rng)
        if s < N_STAGES - 1:
            nxt = CHANNELS * (2 ** min(s + 1, 2))
            params.conv_w(f"s{s}_down", nxt, cout, 3, rng)
    params._rng = rng  # classifier lazily initialized
    return params


def controller(x_value: np.ndarray) -> List[List[bool]]:
    """Per-stage candidate mask from input statistics (≥1 block active)."""
    x = np.asarray(x_value)
    qs = [float(np.mean(x[..., i::4, j::4])) for i in range(2) for j in range(2)]
    masks = []
    for s in range(N_STAGES):
        # hash() of an int tuple is not salted (only str and bytes are), so
        # the masks are the same in every process, and the reference's.
        m = [((abs(hash((s, k))) % 7) / 7.0 + qs[k % 4]) % 1.0 > 0.45 for k in range(N_CANDIDATES)]
        if not any(m):
            m[s % N_CANDIDATES] = True
        masks.append(m)
    return masks


def build_instanas(params: DynParams, stream: TaskStream, x_value) -> Buffer:
    pool = params.pool
    rng = params._rng
    x = pool.from_array(x_value)  # [1, 3, 32, 32]
    h = launch_conv(stream, pool, x, params.weights["stem"], stride=2)  # 16x16
    masks = controller(np.asarray(x_value))
    for s in range(N_STAGES):
        outs = []
        if masks[s][0]:
            outs.append(launch_conv(stream, pool, h, params.weights[f"s{s}_c0"]))
        if masks[s][1]:
            outs.append(launch_conv(stream, pool, h, params.weights[f"s{s}_c1"]))
        if masks[s][2]:
            outs.append(launch_conv(stream, pool, h, params.weights[f"s{s}_c2"]))
        if masks[s][3]:
            d = launch_conv(stream, pool, h, params.weights[f"s{s}_c3dw"], depthwise=True)
            outs.append(launch_conv(stream, pool, d, params.weights[f"s{s}_c3pw"]))
        h = launch_add(stream, pool, outs)
        if s < N_STAGES - 1:
            h = launch_conv(stream, pool, h, params.weights[f"s{s}_down"], stride=2)
    return launch_classifier(stream, pool, h, params, N_CLASSES, rng)


def random_input(rng: np.random.RandomState):
    return rng.randn(1, 3, IMG, IMG).astype(np.float32)
