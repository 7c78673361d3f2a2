"""Static NAS-produced CNNs with irregular graphs (paper §V / §VI-C):
NASNet-like, AmoebaNet-like, SqueezeNet, RandomWire (PyTorch port of
``repro/dyn/static_nets.py``). Their graphs are fixed
across inputs (so DAG frameworks amortize construction — Fig 27), but the
many small parallel branches still underutilize a serial stream.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.buffers import Buffer, BufferPool, DeviceLike
from ..core.wrapper import TaskStream
from .blocks import (
    DynParams,
    launch_add,
    launch_classifier,
    launch_concat,
    launch_conv,
    launch_pool,
)

IMG = 32
N_CLASSES = 10
CH = 16


# -- NASNet / AmoebaNet style cells -------------------------------------------
# A cell combines two inputs (h_prev, h) through 5 pairwise ops; op identities
# are fixed per architecture seed (NASNet seed=11, Amoeba seed=23) — standing
# in for the published cell genotypes' irregular branch structure.

_OP_NAMES = ("conv3", "conv5", "conv1", "pool_avg", "pool_max", "identity")


def _init_cellnet(seed: int, arch_seed: int, n_cells: int,
                  device: DeviceLike = "cuda") -> DynParams:
    rng = np.random.RandomState(seed)
    arch = np.random.RandomState(arch_seed)
    params = DynParams(BufferPool(device))
    params.conv_w("stem", CH, 3, 3, rng)
    genotype = []
    for c in range(n_cells):
        combos = []
        for k in range(5):
            op_a = _OP_NAMES[arch.randint(len(_OP_NAMES))]
            op_b = _OP_NAMES[arch.randint(len(_OP_NAMES))]
            src_a = arch.randint(2 + k)  # 0=h_prev, 1=h, 2+. = earlier combos
            src_b = arch.randint(2 + k)
            combos.append((op_a, src_a, op_b, src_b))
        genotype.append(combos)
        for k, (op_a, _, op_b, _) in enumerate(combos):
            for tag, op in (("a", op_a), ("b", op_b)):
                if op == "conv3":
                    params.conv_w(f"c{c}_k{k}{tag}", CH, CH, 3, rng)
                elif op == "conv5":
                    params.conv_w(f"c{c}_k{k}{tag}", CH, CH, 5, rng)
                elif op == "conv1":
                    params.conv_w(f"c{c}_k{k}{tag}", CH, CH, 1, rng)
        params.conv_w(f"c{c}_squeeze", CH, 5 * CH, 1, rng)
    params._genotype = genotype
    params._rng = rng
    return params


def _apply_op(stream, pool, params, name, op, x):
    if op in ("conv3", "conv5", "conv1"):
        return launch_conv(stream, pool, x, params.weights[name])
    if op == "pool_avg":
        return launch_pool(stream, pool, x, kind="avg")
    if op == "pool_max":
        return launch_pool(stream, pool, x, kind="max")
    return x  # identity


def _build_cellnet(params: DynParams, stream: TaskStream, x_value) -> Buffer:
    pool = params.pool
    x = pool.from_array(x_value)
    h = launch_conv(stream, pool, x, params.weights["stem"], stride=2)
    h_prev = h
    for c, combos in enumerate(params._genotype):
        states: List[Buffer] = [h_prev, h]
        outs = []
        for k, (op_a, src_a, op_b, src_b) in enumerate(combos):
            a = _apply_op(stream, pool, params, f"c{c}_k{k}a", op_a, states[src_a])
            b = _apply_op(stream, pool, params, f"c{c}_k{k}b", op_b, states[src_b])
            s = launch_add(stream, pool, [a, b])
            states.append(s)
            outs.append(s)
        cat = outs[0]
        for o in outs[1:]:
            cat = launch_concat(stream, pool, cat, o)
        h_prev, h = h, launch_conv(stream, pool, cat, params.weights[f"c{c}_squeeze"])
    return launch_classifier(stream, pool, h, params, N_CLASSES, params._rng)


def init_nasnet(seed: int = 0, device: DeviceLike = "cuda") -> DynParams:
    return _init_cellnet(seed, arch_seed=11, n_cells=3, device=device)


def build_nasnet(params, stream, x_value):
    return _build_cellnet(params, stream, x_value)


def init_amoebanet(seed: int = 0, device: DeviceLike = "cuda") -> DynParams:
    return _init_cellnet(seed, arch_seed=23, n_cells=3, device=device)


def build_amoebanet(params, stream, x_value):
    return _build_cellnet(params, stream, x_value)


# -- SqueezeNet ----------------------------------------------------------------

_FIRE = 4


def init_squeezenet(seed: int = 0, device: DeviceLike = "cuda") -> DynParams:
    rng = np.random.RandomState(seed)
    params = DynParams(BufferPool(device))
    params.conv_w("stem", CH, 3, 3, rng)
    c = CH
    for f in range(_FIRE):
        sq = max(c // 4, 4)
        params.conv_w(f"f{f}_squeeze", sq, c, 1, rng)
        params.conv_w(f"f{f}_e1", c // 2, sq, 1, rng)
        params.conv_w(f"f{f}_e3", c // 2, sq, 3, rng)
    params._rng = rng
    return params


def build_squeezenet(params: DynParams, stream: TaskStream, x_value) -> Buffer:
    pool = params.pool
    x = pool.from_array(x_value)
    h = launch_conv(stream, pool, x, params.weights["stem"], stride=2)
    for f in range(_FIRE):
        sq = launch_conv(stream, pool, h, params.weights[f"f{f}_squeeze"])
        e1 = launch_conv(stream, pool, sq, params.weights[f"f{f}_e1"])  # parallel
        e3 = launch_conv(stream, pool, sq, params.weights[f"f{f}_e3"])  # branches
        h = launch_concat(stream, pool, e1, e3)
        if f == 1:
            h = launch_pool(stream, pool, h, kind="max", stride=2)
    return launch_classifier(stream, pool, h, params, N_CLASSES, params._rng)


# -- RandomWire ----------------------------------------------------------------

_N_NODES = 14


def init_randwire(seed: int = 0, device: DeviceLike = "cuda") -> DynParams:
    rng = np.random.RandomState(seed)
    arch = np.random.RandomState(97)
    params = DynParams(BufferPool(device))
    params.conv_w("stem", CH, 3, 3, rng)
    # Watts-Strogatz-like DAG over _N_NODES nodes: ring + random rewires,
    # edges directed low->high index (acyclic).
    edges = set()
    for i in range(1, _N_NODES):
        edges.add((i - 1, i))
        if i >= 2 and arch.rand() < 0.6:
            edges.add((arch.randint(max(1, i - 4), i), i))
        if arch.rand() < 0.3:
            edges.add((arch.randint(0, i), i))
    params._edges = sorted(edges)
    for n in range(_N_NODES):
        params.conv_w(f"node{n}", CH, CH, 3, rng)
    params._rng = rng
    return params


def build_randwire(params: DynParams, stream: TaskStream, x_value) -> Buffer:
    pool = params.pool
    x = pool.from_array(x_value)
    stem = launch_conv(stream, pool, x, params.weights["stem"], stride=2)
    acts = {0: launch_conv(stream, pool, stem, params.weights["node0"])}
    in_edges = {n: [a for a, b in params._edges if b == n] for n in range(_N_NODES)}
    for n in range(1, _N_NODES):
        srcs = [acts[a] for a in in_edges[n] if a in acts] or [stem]
        agg = launch_add(stream, pool, srcs)
        acts[n] = launch_conv(stream, pool, agg, params.weights[f"node{n}"])
    sinks = [acts[n] for n in range(_N_NODES) if not any(a == n for a, _ in params._edges)]
    out = launch_add(stream, pool, sinks if sinks else [acts[_N_NODES - 1]])
    return launch_classifier(stream, pool, out, params, N_CLASSES, params._rng)
