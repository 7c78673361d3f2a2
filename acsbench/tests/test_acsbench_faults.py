"""A whole train-cell run on the CPU at a tiny size (the harness's look
for a card skipped, everything else as on the card: set-up, the first
steps, the window, the reference, the comparison against the cell's own
limits) comes out correct, and comes out not correct with the timed path
broken underneath it in each way a one-chip train cell can break:

* a step that returns its state unchanged (AdamW's update skipped);
* half of the batch left out, the mean taken over the rest.

(No exchange between chips runs on one chip, and a train step produces
no token or answer to alter.) Also the control: the reference computed
with float8 products fails at least one of the cell's limits."""

import pytest

from _acsbench_cells import tiny_cell
from acsbench import compare
from acsbench.kinds import train


def _half_batch(original):
    def loss_and_grads(params, cfg, inputs, labels, **kwargs):
        half = inputs.shape[0] // 2
        return original(params, cfg, inputs[:half], labels[:half], **kwargs)
    return loss_and_grads


def _unchanged(params, grads, state, lr, **kwargs):
    return params, state


CELLS = ["granite-moe.train", "minicpm.train"]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    result = train.run(tiny_cell(name, seed=2 ** 35 + 1))
    assert result.attempted >= 1 and result.failed == 0
    assert result.correct, result.compared


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(name, fault, monkeypatch):
    from repro_torch.launch import steps

    if fault == "state_unchanged":
        monkeypatch.setattr(steps, "adamw_update", _unchanged)
    else:
        monkeypatch.setattr(steps, "loss_and_grads", _half_batch(steps.loss_and_grads))
    result = train.run(tiny_cell(name, seed=2 ** 35 + 2, batch=4))
    assert not result.correct, result.compared


@pytest.mark.parametrize("name", CELLS)
def test_the_float8_control_is_not_correct(name):
    cell = tiny_cell(name, seed=2 ** 35 + 3, batch=4, seq=32, dtype="bfloat16")
    prog = train.Program(cell)
    spec, leaves, opt = prog.spec, prog.leaves, prog.opt
    first = [(prog.inputs[i], prog.labels[i]) for i in range(cell.traffic["check_steps"])]
    ref = train.reference_readings(spec, leaves, cell.seed, cell.device, first, opt)
    fp8 = train.reference_readings(spec, leaves, cell.seed, cell.device, first, opt, "fp8")
    found = compare.gaps(fp8, ref)
    assert not compare.verdict(found, cell.config["limits"]), found
