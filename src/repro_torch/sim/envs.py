"""Environment specs mirroring the paper's Brax/MuJoCo evaluation set
(§V: ant, grasp, humanoid, cheetah, walker2d).

Each spec is an articulated rigid-body tree: bodies are point masses with a
collision radius; joints are stiff spring-damper constraints between parent
and child (penalty formulation — standard for differentiable engines like
Brax's spring dynamics). Actuators inject per-joint control torques
(as forces along the joint axis) from the RL policy.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

__all__ = ["EnvSpec", "ENVIRONMENTS", "make_env"]


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    name: str
    n_bodies: int
    joints: Tuple[Tuple[int, int], ...]  # (parent, child) body indices
    actuated: Tuple[int, ...]  # joint indices with actuators
    radius: float = 0.12  # collision radius (uniform; spheres)
    mass: float = 1.0

    @property
    def n_joints(self) -> int:
        return len(self.joints)

    def contact_candidates(self) -> List[Tuple[int, int]]:
        """All body pairs not directly connected by a joint (broad set);
        the runtime broadphase narrows this per-state (input-dependence)."""
        connected = {tuple(sorted(j)) for j in self.joints}
        out = []
        for a in range(self.n_bodies):
            for b in range(a + 1, self.n_bodies):
                if (a, b) not in connected:
                    out.append((a, b))
        return out


def _chain(n: int) -> Tuple[Tuple[int, int], ...]:
    return tuple((i, i + 1) for i in range(n - 1))


def _star_legs(n_legs: int, per_leg: int) -> Tuple[Tuple[int, int], ...]:
    """Torso = body 0; each leg is a chain hanging off the torso."""
    joints = []
    body = 1
    for _ in range(n_legs):
        parent = 0
        for _ in range(per_leg):
            joints.append((parent, body))
            parent = body
            body += 1
    return tuple(joints)


def _ant() -> EnvSpec:
    # torso + 4 legs x 2 segments = 9 bodies, 8 joints (paper's ant: 4 legs
    # each with a knee joint).
    joints = _star_legs(4, 2)
    return EnvSpec("ant", 9, joints, actuated=tuple(range(8)))


def _cheetah() -> EnvSpec:
    # planar half-cheetah: torso + back thigh/shin/foot + front thigh/shin/foot.
    joints = _star_legs(2, 3)
    return EnvSpec("cheetah", 7, joints, actuated=tuple(range(6)))


def _walker2d() -> EnvSpec:
    joints = _star_legs(2, 3)
    return EnvSpec("walker2d", 7, joints, actuated=tuple(range(6)))


def _humanoid() -> EnvSpec:
    # torso(0), head(1), two arms x 2, two legs x 3, pelvis(..) ~ 13 bodies.
    joints = [(0, 1)]  # neck
    body = 2
    for _ in range(2):  # arms: upper, lower
        parent = 0
        for _ in range(2):
            joints.append((parent, body))
            parent = body
            body += 1
    for _ in range(2):  # legs: thigh, shin, foot
        parent = 0
        for _ in range(3):
            joints.append((parent, body))
            parent = body
            body += 1
    return EnvSpec("humanoid", body, tuple(joints), actuated=tuple(range(len(joints))))


def _grasp() -> EnvSpec:
    # palm(0) + 4 fingers x 3 segments + free object = 14 bodies; the object
    # (body 13) is unjointed -> its interactions are pure contacts, making
    # the active-contact set strongly state-dependent (the paper's point).
    joints = _star_legs(4, 3)
    return EnvSpec("grasp", 14, joints, actuated=tuple(range(12)))


ENVIRONMENTS = {
    "ant": _ant(),
    "grasp": _grasp(),
    "humanoid": _humanoid(),
    "cheetah": _cheetah(),
    "walker2d": _walker2d(),
}


def make_env(name: str) -> EnvSpec:
    return ENVIRONMENTS[name]


def initial_state(spec: EnvSpec, n_envs: int, seed: int = 0) -> np.ndarray:
    """[n_envs, n_bodies, 6] (pos xyz, vel xyz). Bodies start in a loose
    cluster above the ground plane with per-env jitter — each instance is a
    different scenario (paper §II-B: 'each thread simulates a different
    scenario')."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-0.5, 0.5, size=(n_envs, spec.n_bodies, 3)).astype(np.float32)
    pos[..., 2] += 1.0  # above ground
    vel = 0.1 * rng.randn(n_envs, spec.n_bodies, 3).astype(np.float32)
    return np.concatenate([pos, vel], axis=-1)
