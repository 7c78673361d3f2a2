"""The port's physics stream against the reference: the same initial
states, the same input-dependent broadphase contact sets step by step, and
states that agree after a few steps."""

import dataclasses

import numpy as np
import pytest

import _torch_streams as S
from repro.sim import ENVIRONMENTS as R_ENVS
from repro.sim.envs import initial_state as r_initial_state
from repro_torch.sim import ENVIRONMENTS as T_ENVS
from repro_torch.sim.envs import initial_state as t_initial_state

STEPS = 3
SEED = 0
# Float32 physics through XLA and through eager PyTorch: norms, divisions
# and the force sums round at other places, and three Euler steps compound
# the difference.
RTOL = ATOL = 1e-5


@pytest.mark.parametrize("env", sorted(R_ENVS))
def test_initial_state_identical(env):
    assert dataclasses.asdict(T_ENVS[env]) == dataclasses.asdict(R_ENVS[env])
    assert T_ENVS[env].contact_candidates() == R_ENVS[env].contact_candidates()
    want = r_initial_state(R_ENVS[env], 4, SEED)
    got = t_initial_state(T_ENVS[env], 4, SEED)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _contact_rows(tasks):
    """The broadphase's active pairs, as the contact rows the stream writes."""
    return [t.outputs[0].row_start for t in tasks if t.opcode == "contact_pair"]


@pytest.mark.parametrize("env", ["cheetah", "grasp"])
def test_contacts_and_states_follow_reference(env):
    engines = {side: S.sim_engine(side, env=env, n_envs=2, group_size=1, seed=SEED)
               for side in S.SIDES}
    for step in range(STEPS):
        pairs = {}
        for side, eng in engines.items():
            stream = S.PKG[side].TaskStream()
            eng.emit_step(stream)
            pairs[side] = _contact_rows(stream.tasks)
            S.run_serial(side, stream.tasks)
        assert pairs["port"] == pairs["ref"], f"broadphase contact sets differ at step {step}"
        np.testing.assert_allclose(engines["port"].state_snapshot(),
                                   engines["ref"].state_snapshot(), rtol=RTOL, atol=ATOL)
    port = engines["port"]
    # One broadphase read of each group's state per step.
    assert port.stats.host_reads == STEPS * len(port.groups)
    assert port.stats.active_contacts == engines["ref"].stats.active_contacts
    assert np.isfinite(port.state_snapshot()).all()
