"""Streams shared by the ``test_torch_*`` modules: each function makes the
SAME task stream in the JAX reference (``side="ref"``) or in the PyTorch
port (``side="port"``, on the CPU), from numpy inputs made from one seed.

Tids differ between the packages (each has its own counter), so results
that name tasks are compared by stream position.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

import repro.core as R
import repro.core.device_dispatch as R_DD
import repro_torch.core as T
import repro_torch.core.device_dispatch as T_DD
from repro.core.task import default_segments as r_default_segments
from repro.kernels.ops import LOOP_BRANCHES as R_BRANCHES
from repro.kernels.ops import register_loop_branches as r_register
from repro_torch.kernels.ops import LOOP_BRANCHES as T_BRANCHES
from repro_torch.kernels.ops import register_loop_branches as t_register
from repro_torch.core.task import default_segments as t_default_segments

SIDES = ("ref", "port")
PKG = {"ref": R, "port": T}
BRANCHES = {"ref": R_BRANCHES, "port": T_BRANCHES}
REGISTER = {"ref": r_register, "port": t_register}
DISPATCH = {"ref": R_DD, "port": T_DD}
DEFAULT_SEGMENTS = {"ref": r_default_segments, "port": t_default_segments}


def pool(side):
    return R.BufferPool() if side == "ref" else T.BufferPool(device="cpu")


def value(side, arr):
    return jnp.asarray(arr) if side == "ref" else arr


def snapshot(bufs) -> np.ndarray:
    return np.stack([np.asarray(b.value) for b in bufs])


def positions(tasks):
    """tid -> stream position."""
    return {t.tid: i for i, t in enumerate(tasks)}


def mixed_tag(side, seed=0, d=4, n_bufs=6, n_tasks=24):
    """Two tagged tenants over shared buffers (the differential matrix's
    mixed-tag stream): cross-tenant RAW/WAR/WAW hazards."""
    pkg, br = PKG[side], BRANCHES[side]
    rng = np.random.RandomState(seed)
    p = pool(side)
    bufs = [p.alloc((d,), np.float32, value=value(side, rng.randn(d).astype(np.float32)))
            for _ in range(n_bufs)]
    kernels = {"axpy": pkg.AcsKernel(name="axpy_mixed", fn=br["axpy"]),
               "mul": pkg.AcsKernel(name="mul_mixed", fn=br["mul"])}
    streams = {"tenantA": pkg.TaskStream(tag="tenantA"),
               "tenantB": pkg.TaskStream(tag="tenantB")}
    tasks = []
    for _ in range(n_tasks):
        tag = "tenantA" if rng.rand() < 0.5 else "tenantB"
        kern = kernels["axpy" if rng.rand() < 0.5 else "mul"]
        ins = (bufs[rng.randint(n_bufs)], bufs[rng.randint(n_bufs)])
        outs = (bufs[rng.randint(n_bufs)],)
        tasks.append(kern.launch(streams[tag], inputs=ins, outputs=outs))
    return bufs, tasks


def chain_universe(side, seed=0, n_chains=6, width=16, depth=4):
    """Per-chain state buffers + one shared read-only weight; each chain
    applies ``depth`` RAW-serialized axpy/mul kernels (the decode-chain
    shape of ``benchmarks/bench_device.py``). Returns (states + [weight],
    tasks)."""
    pkg, br = PKG[side], BRANCHES[side]
    rng = np.random.RandomState(seed)
    p = pool(side)
    states = [p.alloc((width,), np.float32, name=f"chain{i}",
                      value=value(side, rng.randn(width).astype(np.float32)))
              for i in range(n_chains)]
    weight = p.alloc((width,), np.float32, name="weight",
                     value=value(side, rng.randn(width).astype(np.float32)))
    tasks = []
    for s in states:
        for dd in range(depth):
            name = "axpy" if dd % 2 == 0 else "mul"
            ins, outs = (s, weight), (s,)
            r, w = DEFAULT_SEGMENTS[side](ins, outs)
            tasks.append(pkg.Task(opcode=name, fn=br[name], inputs=ins, outputs=outs,
                                  read_segments=r, write_segments=w))
    return states + [weight], tasks


def sim_engine(side, env="cheetah", n_envs=2, group_size=1, seed=0):
    if side == "ref":
        from repro.sim import ENVIRONMENTS, PhysicsEngine

        return PhysicsEngine(ENVIRONMENTS[env], n_envs=n_envs, group_size=group_size,
                             seed=seed)
    from repro_torch.sim import ENVIRONMENTS, PhysicsEngine

    return PhysicsEngine(ENVIRONMENTS[env], n_envs=n_envs, group_size=group_size,
                         seed=seed, device="cpu")


def sim(side, seed=0):
    """One physics step (cheetah, 2 envs, groups of 1): row-view aliasing,
    input-dependent contacts, variable arity. Returns (state buffers,
    tasks)."""
    eng = sim_engine(side, seed=seed)
    stream = PKG[side].TaskStream()
    eng.emit_batch(stream, 1)
    return [g.state for g in eng.groups], stream.tasks


STREAMS = {"sim": sim, "mixed_tag": mixed_tag, "chain": chain_universe}


def run_serial(side, tasks):
    if side == "ref":
        return R.run_serial(tasks)
    return T.run_serial(tasks, device="cpu")


def lower(side, tasks):
    """Lower ``tasks`` as the loop-mode runner does: returns (program,
    registry, arena)."""
    pkg = PKG[side]
    reg = pkg.DeviceOpRegistry(strict=False)
    REGISTER[side](reg)
    arena = pkg.SlabArena()
    arena.add_tasks(tasks)
    return DISPATCH[side].lower_epoch_program(tasks, reg, arena), reg, arena


def cross_shard_joins(side, seed=0, n_chains=4, width=8, rounds=6):
    """``tests/test_mesh_transfers.py``'s stream: ``n_chains`` independent
    two-buffer chains (a mesh's placement spreads them over its shards)
    with neighbour-chain joins on odd rounds, each a cross-shard edge once
    the chains sit on different shards. Returns (buffers, tasks)."""
    pkg, br = PKG[side], BRANCHES[side]
    rng = np.random.RandomState(seed)
    p = pool(side)
    axpy = pkg.AcsKernel(name="axpy_xfer", fn=br["axpy"])
    mul = pkg.AcsKernel(name="mul_xfer", fn=br["mul"])
    chains = [[p.alloc((width,), np.float32, name=f"c{c}b{k}",
                       value=value(side, rng.randn(width).astype(np.float32)))
               for k in range(2)]
              for c in range(n_chains)]
    stream = pkg.TaskStream()
    tasks = []
    for r in range(rounds):
        for c in range(n_chains):
            a, b = chains[c]
            tasks.append(axpy.launch(stream, inputs=(a, b), outputs=(a,)))
            tasks.append(mul.launch(stream, inputs=(a, b), outputs=(b,)))
        if r % 2 == 1:
            for c in range(n_chains):
                other = chains[(c + 1) % n_chains][0]
                a = chains[c][0]
                tasks.append(axpy.launch(stream, inputs=(other, a), outputs=(a,)))
    return [b for ch in chains for b in ch], tasks


def dyn_routing(side, seed=0):
    """The differential matrix's dyn stream: Dynamic Routing on one seeded
    ``[1, 3, 32, 32]`` input, weights from seed 0. Returns ([output],
    tasks)."""
    x = np.random.RandomState(seed).randn(1, 3, 32, 32).astype(np.float32)
    if side == "ref":
        from repro.dyn import WORKLOADS

        init, build, _ = WORKLOADS["dynamic_routing"]
        params = init(0)
    else:
        from repro_torch.dyn import WORKLOADS

        init, build, _ = WORKLOADS["dynamic_routing"]
        params = init(0, device="cpu")
    stream = PKG[side].TaskStream()
    out = build(params, stream, x)
    return [out], stream.tasks
