"""Dynamic Routing-like segmentation net (paper §V: "Dynamic-A 16 layer";
PyTorch port of ``repro/dyn/dynamic_routing.py``).

A grid of cells (layers x scales). Each cell is a small conv; per-input
soft gates decide which inter-cell paths (same-scale / down / up) are
active, so the routed sub-graph — and hence the kernel stream — varies per
image (Fig 6b's multi-path structure).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..core.buffers import Buffer, BufferPool, DeviceLike
from ..core.wrapper import TaskStream
from .blocks import DynParams, launch_add, launch_conv, launch_upsample2

N_LAYERS = 4
N_SCALES = 3
CH = 12
IMG = 32
N_CLASSES = 8


def init_dynamic_routing(seed: int = 0, device: DeviceLike = "cuda") -> DynParams:
    rng = np.random.RandomState(seed)
    params = DynParams(BufferPool(device))
    params.conv_w("stem", CH, 3, 3, rng)
    for l in range(N_LAYERS):
        for s in range(N_SCALES):
            params.conv_w(f"cell{l}_{s}", CH, CH, 3, rng)
            params.conv_w(f"down{l}_{s}", CH, CH, 1, rng)  # stride-2 path
            params.conv_w(f"up{l}_{s}", CH, CH, 1, rng)    # post-upsample 1x1
    params.conv_w("head", N_CLASSES, CH, 1, rng)
    params._rng = rng
    return params


def gates(x_value: np.ndarray) -> Dict[Tuple[int, int, str], bool]:
    """Per-(layer, scale, direction) path gate from input statistics."""
    x = np.asarray(x_value)
    stat = float(np.tanh(np.mean(x)) + np.std(x) % 1.0)
    g = {}
    d_code = {"same": 0, "down": 1, "up": 2}
    for l in range(N_LAYERS):
        for s in range(N_SCALES):
            for d in ("same", "down", "up"):
                # stable arithmetic hash (python's str hash is per-process
                # salted, which would make the gates nondeterministic)
                v = (((l * 31 + s) * 31 + d_code[d]) * 2654435761 % 101) / 101.0
                g[(l, s, d)] = (v + stat) % 1.0 > 0.4
            # ensure at least one VALID outgoing path per cell ("down" needs a
            # coarser scale to exist, "up" a finer one)
            valid_open = g[(l, s, "same")] or (
                g[(l, s, "down")] and s + 1 < N_SCALES
            ) or (g[(l, s, "up")] and s - 1 >= 0)
            if not valid_open:
                g[(l, s, "same")] = True
    return g


def build_dynamic_routing(params: DynParams, stream: TaskStream, x_value) -> Buffer:
    pool = params.pool
    x = pool.from_array(x_value)  # [1, 3, 32, 32]
    stem = launch_conv(stream, pool, x, params.weights["stem"], stride=2)  # 16x16

    # grid[l][s] = activation at layer l, scale s (scale 0 finest: 16x16)
    grid: Dict[int, Buffer] = {0: stem}
    g = gates(np.asarray(x_value))

    for l in range(N_LAYERS):
        nxt: Dict[int, Buffer] = {}
        contrib: Dict[int, list] = {s: [] for s in range(N_SCALES)}
        for s, h in grid.items():
            # same-scale path
            if g[(l, s, "same")]:
                contrib[s].append(launch_conv(stream, pool, h, params.weights[f"cell{l}_{s}"]))
            # downsample path (to coarser scale s+1)
            if s + 1 < N_SCALES and g[(l, s, "down")]:
                d = launch_conv(stream, pool, h, params.weights[f"down{l}_{s}"], stride=2)
                contrib[s + 1].append(d)
            # upsample path (to finer scale s-1)
            if s - 1 >= 0 and g[(l, s, "up")]:
                u = launch_upsample2(stream, pool, h)
                u = launch_conv(stream, pool, u, params.weights[f"up{l}_{s}"])
                contrib[s - 1].append(u)
        for s, outs in contrib.items():
            if outs:
                nxt[s] = launch_add(stream, pool, outs)
        grid = nxt or grid

    # head: merge everything to the finest surviving scale
    finest = min(grid)
    h = grid[finest]
    for s in sorted(grid):
        if s == finest:
            continue
        u = grid[s]
        for _ in range(s - finest):
            u = launch_upsample2(stream, pool, u)
        hsum = launch_add(stream, pool, [h, u])
        h = hsum
    return launch_conv(stream, pool, h, params.weights["head"], relu=False)


def random_input(rng: np.random.RandomState):
    return rng.randn(1, 3, IMG, IMG).astype(np.float32)
