"""The simulation engine: physics as a stream of small ACS kernels
(PyTorch port of ``repro/sim/engine.py``).

Each step of each environment group emits
  * one ``joint_solve`` kernel per joint           (spring-damper + actuation)
  * one ``contact_pair`` kernel per *active* pair  (INPUT-DEPENDENT: the
    active set comes from a host-side broadphase over the current state —
    this is what makes the computational graph vary per input/state)
  * one ``ground_contact`` kernel per group
  * one ``integrate`` kernel per group             (gather forces, Euler)
  * one ``observe`` kernel per group               (policy features)

Kernels are deliberately small (a group is ``group_size`` envs × ≤14
bodies ≈ hundreds of floats) — the paper's small-kernel property. Groups
use disjoint buffers, so ACS's window recovers cross-group and intra-step
parallelism that the serial stream hides.

The broadphase reads each group's state to the host once per step: that is
the workload's input dependence, kept as it is and counted in
``SimKernelStats.host_reads``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.buffers import Buffer, BufferPool, DeviceLike
from ..core.task import operand_shape
from ..core.wrapper import AcsKernel, TaskStream
from .envs import EnvSpec, initial_state

__all__ = ["PhysicsEngine", "SimKernelStats", "SIM_KERNELS", "register_device_kernels"]

_DT = 0.01
_GRAVITY = -9.81
_KP, _KD = 80.0, 4.0  # joint spring-damper
_KC = 200.0  # contact penalty stiffness
_KG = 400.0  # ground stiffness


# --------------------------------------------------------------------------
# Kernel bodies (pure tensor functions; statics appended by the wrapper)
# --------------------------------------------------------------------------

def _norm3(d):
    return torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def _joint_fn(state, ctrl, j, parent, child, rest, kp, kd):
    """Spring-damper + actuation along the joint axis. [g,B,6] -> [1,g,6]
    (force-on-parent ++ force-on-child)."""
    pos, vel = state[..., :3], state[..., 3:]
    d = pos[:, child] - pos[:, parent]  # [g, 3]
    dist = _norm3(d) + 1e-6
    u = d / dist
    rel_v = vel[:, child] - vel[:, parent]
    f = (kp * (dist - rest) + kd * torch.sum(rel_v * u, dim=-1, keepdim=True)) * u
    f = f + ctrl[:, j : j + 1] * u  # actuation torque proxy along the axis
    return torch.cat([f, -f], dim=-1)[None]  # [1, g, 6]


def _contact_fn(state, a, b, radius, kc):
    """Sphere-sphere penalty. [g,B,6] -> [1,g,6] (force-on-a ++ force-on-b)."""
    pos, vel = state[..., :3], state[..., 3:]
    d = pos[:, b] - pos[:, a]
    dist = _norm3(d) + 1e-6
    u = d / dist
    pen = torch.clamp_min(2.0 * radius - dist, 0.0)
    rel_v = torch.sum((vel[:, b] - vel[:, a]) * u, dim=-1, keepdim=True)
    f = -(kc * pen - 0.1 * kc * pen * rel_v) * u  # push a away from b
    return torch.cat([f, -f], dim=-1)[None]


def _ground_fn(state, radius, kg):
    """Ground-plane penalty + tangential damping. [g,B,6] -> [g,B,3]."""
    pos, vel = state[..., :3], state[..., 3:]
    pen = torch.clamp_min(radius - pos[..., 2:3], 0.0)
    fz = kg * pen - 2.0 * torch.clamp_max(vel[..., 2:3], 0.0) * kg * pen
    in_contact = (pen > 0).to(state.dtype)
    ft = -5.0 * vel[..., :2] * in_contact  # friction proxy
    return torch.cat([ft, fz], dim=-1)


def _integrate_fn(state, jf, gf, *cf_rows_and_statics):
    """Gather all force contributions, semi-implicit Euler step.

    The reference scatter-adds with ``.at[:, idx].add``; indices repeat
    (joints share parent bodies), and a scatter-add on the card
    accumulates with atomics in an order that changes from run to run. So
    contributions are added one column at a time, in index order: the
    same bits under every scheduler."""
    (parents, children, pairs_a, pairs_b, n_cf, mass, dt) = cf_rows_and_statics[-7:]
    cf_rows = cf_rows_and_statics[:-7]
    assert len(cf_rows) == n_cf
    g, b = state.shape[0], state.shape[1]
    force = torch.zeros((g, b, 3), dtype=state.dtype, device=state.device)
    force = force + gf
    # jf: [J, g, 6] -> per-body accumulation
    for k, body in enumerate(parents):
        force[:, body] += jf[k, :, :3]
    for k, body in enumerate(children):
        force[:, body] += jf[k, :, 3:]
    if cf_rows:
        cf = torch.cat(cf_rows, dim=0)  # [C, g, 6]
        for k, body in enumerate(pairs_a):
            force[:, body] += cf[k, :, :3]
        for k, body in enumerate(pairs_b):
            force[:, body] += cf[k, :, 3:]
    gravity = torch.tensor([0.0, 0.0, _GRAVITY], dtype=state.dtype, device=state.device)
    acc = force / mass + gravity
    vel = state[..., 3:] + dt * acc
    pos = state[..., :3] + dt * vel
    return torch.cat([pos, vel], dim=-1)


def _observe_fn(state):
    """Policy features: per-env flatten of (pos - torso, vel). [g,B,6] -> [g,B*6]."""
    torso = state[:, :1, :3]
    rel = torch.cat([state[..., :3] - torso, state[..., 3:]], dim=-1)
    return rel.reshape(state.shape[0], -1)


_JOINT = AcsKernel(name="joint_solve", fn=_joint_fn)
_CONTACT = AcsKernel(name="contact_pair", fn=_contact_fn)
_GROUND = AcsKernel(name="ground_contact", fn=_ground_fn)
_INTEGRATE = AcsKernel(name="integrate", fn=_integrate_fn)
_OBSERVE = AcsKernel(name="observe", fn=_observe_fn)

#: Every kernel a PhysicsEngine stream can emit — the fixed opcode set the
#: device window needs registered ahead of time.
SIM_KERNELS = (_JOINT, _CONTACT, _GROUND, _INTEGRATE, _OBSERVE)

#: Branch table for the device ready-queue kernel: empty on purpose. Every
#: sim kernel either changes the row geometry (observe flattens [g,B,6] ->
#: [g,B*6]) or spans several shape classes per stream, so none meets the
#: single-class, shape-preserving eligibility of ``kernels/ready_queue.py``.
#: Sim epochs run through the ready-queue interpreter instead.
SWITCH_BRANCHES: Dict[str, object] = {}


def register_device_kernels(registry) -> Dict[str, int]:
    """Register the simulation kernel set with a
    :class:`~repro_torch.core.device_dispatch.DeviceOpRegistry` (fn-less:
    the interpreter runs each task's wrapper-resolved callable). Returns
    name -> opcode."""
    for name, fn in SWITCH_BRANCHES.items():
        registry.register_switch_branch(name, fn)
    return {k.name: registry.register(k.name) for k in SIM_KERNELS}


class SimKernelStats:
    """Per-stream kernel census (reproduces the paper's Figs 3-5 metrics)."""

    def __init__(self) -> None:
        self.kernels = 0
        self.steps = 0
        self.elements: List[int] = []  # per-kernel output element counts
        self.active_contacts: List[int] = []
        self.candidate_contacts = 0
        # Device -> host reads the engine made (broadphase state, policy
        # observations): the workload's input dependence, one per group per
        # step for the broadphase.
        self.host_reads = 0

    @property
    def kernels_per_step(self) -> float:
        return self.kernels / max(self.steps, 1)

    def cta_histogram(self, threads_per_cta: int = 256) -> Dict[int, int]:
        """Kernel-size distribution in CTAs (elements/threads ceil) — Fig 5."""
        hist: Dict[int, int] = {}
        for e in self.elements:
            ctas = max(1, -(-e // threads_per_cta))
            hist[ctas] = hist.get(ctas, 0) + 1
        return hist

    def as_dict(self) -> Dict[str, float]:
        return {
            "kernels": self.kernels,
            "steps": self.steps,
            "kernels_per_step": self.kernels_per_step,
            "mean_kernel_elems": float(np.mean(self.elements)) if self.elements else 0.0,
            "mean_active_contacts": float(np.mean(self.active_contacts))
            if self.active_contacts
            else 0.0,
            "host_reads": self.host_reads,
        }


@dataclasses.dataclass
class _Group:
    state: Buffer
    jf: Buffer
    gf: Buffer
    cf: Buffer
    obs: Buffer


class PhysicsEngine:
    """One environment family, ``n_envs`` instances in groups of
    ``group_size`` (disjoint buffer sets => schedulable in parallel), with
    every buffer on ``device``."""

    def __init__(
        self,
        spec: EnvSpec,
        n_envs: int = 64,
        group_size: int = 8,
        seed: int = 0,
        dt: float = _DT,
        broadphase_margin: float = 0.25,
        device: DeviceLike = "cuda",
    ):
        assert n_envs % group_size == 0
        self.spec = spec
        self.n_envs = n_envs
        self.group_size = group_size
        self.dt = dt
        self.margin = broadphase_margin
        self.pool = BufferPool(device)
        self.device = self.pool.device
        self.rng = np.random.RandomState(seed)
        self.candidates = spec.contact_candidates()
        self.stats = SimKernelStats()
        self._step_index = 0

        g, b, j, c = group_size, spec.n_bodies, spec.n_joints, len(self.candidates)
        full = initial_state(spec, n_envs, seed)
        zeros = lambda shape: np.zeros(shape, np.float32)
        self.groups: List[_Group] = []
        for gi in range(n_envs // group_size):
            sl = full[gi * g : (gi + 1) * g]
            self.groups.append(
                _Group(
                    state=self.pool.alloc((g, b, 6), np.float32, f"state{gi}", sl),
                    jf=self.pool.alloc((max(j, 1), g, 6), np.float32, f"jf{gi}",
                                       zeros((max(j, 1), g, 6))),
                    gf=self.pool.alloc((g, b, 3), np.float32, f"gf{gi}", zeros((g, b, 3))),
                    cf=self.pool.alloc((max(c, 1), g, 6), np.float32, f"cf{gi}",
                                       zeros((max(c, 1), g, 6))),
                    obs=self.pool.alloc((g, b * 6), np.float32, f"obs{gi}",
                                        zeros((g, b * 6))),
                )
            )

    def _to_host(self, value: torch.Tensor) -> np.ndarray:
        self.stats.host_reads += 1
        return value.cpu().numpy()

    # -- broadphase (host side; the source of input-dependence) ------------
    def _active_pairs(self, group: _Group) -> List[int]:
        pos = self._to_host(group.state.value)[..., :3]  # [g, B, 3]
        thresh = 2.0 * self.spec.radius + self.margin
        act = []
        for ci, (a, b) in enumerate(self.candidates):
            d = np.linalg.norm(pos[:, b] - pos[:, a], axis=-1)
            if np.any(d < thresh):
                act.append(ci)
        return act

    # -- emission -----------------------------------------------------------
    def emit_step(self, stream: TaskStream, policy: Optional[Callable] = None) -> None:
        """Launch one simulation step's kernels for every group, exactly as
        an application would: per-group, program order, single stream."""
        spec, g = self.spec, self.group_size
        for gi, grp in enumerate(self.groups):
            # fresh ctrl buffer per (group, step): host-produced actions
            if policy is not None:
                actions = np.asarray(policy(self._to_host(grp.obs.value)), np.float32)
            else:
                actions = self.rng.uniform(-1, 1, size=(g, spec.n_joints)).astype(np.float32)
            ctrl = self.pool.alloc(
                (g, spec.n_joints), np.float32,
                f"ctrl{gi}_s{self._step_index}", actions,
            )

            for j, (p, c) in enumerate(spec.joints):
                # reads full state + this joint's control column;
                # writes its OWN jf row -> joints are mutually independent.
                _JOINT.launch(
                    stream,
                    inputs=(grp.state, ctrl),
                    outputs=(grp.jf.row_view(j, 1),),
                    static_args=(j, p, c, 0.35, _KP, _KD),
                )

            active = self._active_pairs(grp)
            self.stats.active_contacts.append(len(active))
            for ci in active:
                a, b = self.candidates[ci]
                _CONTACT.launch(
                    stream,
                    inputs=(grp.state,),
                    outputs=(grp.cf.row_view(ci, 1),),
                    static_args=(a, b, spec.radius, _KC),
                )

            _GROUND.launch(
                stream, inputs=(grp.state,), outputs=(grp.gf,),
                static_args=(spec.radius, _KG),
            )

            parents = tuple(p for p, _ in spec.joints)
            children = tuple(c for _, c in spec.joints)
            pa = tuple(self.candidates[ci][0] for ci in active)
            pb = tuple(self.candidates[ci][1] for ci in active)
            _INTEGRATE.launch(
                stream,
                inputs=(grp.state, grp.jf, grp.gf) + tuple(grp.cf.row_view(ci, 1) for ci in active),
                outputs=(grp.state,),
                static_args=(parents, children, pa, pb, len(active), spec.mass, self.dt),
            )
            _OBSERVE.launch(stream, inputs=(grp.state,), outputs=(grp.obs,))

        self.stats.kernels = len(stream.tasks)
        self.stats.steps += 1
        self.stats.candidate_contacts = len(self.candidates)
        self._step_index += 1

    def emit_batch(self, stream: TaskStream, n_steps: int,
                   policy: Optional[Callable] = None) -> None:
        for _ in range(n_steps):
            self.emit_step(stream, policy)

    def record_kernel_sizes(self, stream: TaskStream) -> None:
        for t in stream.tasks:
            elems = sum(int(np.prod(operand_shape(o))) for o in t.outputs)
            self.stats.elements.append(elems)

    def buffers(self) -> Tuple[Buffer, ...]:
        """All live allocations (states, force accumulators, controls) in
        allocation order — what the device runner's slab arena packs."""
        return self.pool.buffers()

    def state_snapshot(self) -> np.ndarray:
        return np.concatenate([g.state.value.cpu().numpy() for g in self.groups], axis=0)
