"""The benchmark's plain reference (``acsbench/reference``) against the
port at a tiny size on the CPU, in float32: the same seeded weights and
batch give the same loss, every weight's gradient, and after one train
step (the clip and AdamW) the same master weights, m and v. The step
runs at the schedule's peak learning rate (its warm-up cut to one step),
so that the update is many float32 ulps of the weights.

Tolerances: float32 throughout on both sides; the port's kernels' plain
versions and the reference sum in other orders (attention's softmax, the
MoE combine, the products over D = 64), so values agree to a few float32
ulps of each tensor's scale: 1e-5 relative and 1e-6 of the tensor's
largest magnitude. AdamW's step ``m / (sqrt(v) + eps)`` turns a gradient
near ``eps`` (1e-8) into anything from 0 to 1, so where the clipped
gradient is under 100 eps the master weight is held only to within the
learning rate of the reference's; elsewhere as above."""

import pytest
import torch

from _acsbench_cells import tiny_cell
from acsbench.kinds.train import Program, _named
from acsbench.reference.model import adamw_step, train_step


def _close(got, want, what):
    scale = float(want.abs().max()) or 1.0
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-5, atol=1e-6 * scale,
                               msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("name", ["granite-moe.train", "minicpm.train"])
def test_reference_step_matches_the_port(name):
    from repro_torch.models import loss_and_grads

    cell = tiny_cell(name, seed=2 ** 33 + 11)
    batch_tokens = cell.traffic["optimizer"]["global_batch_tokens"]
    cell = tiny_cell(name, seed=2 ** 33 + 11, optimizer={"warmup_tokens": batch_tokens})
    prog = Program(cell)
    assert prog.opt.lr_at(1) == prog.opt.peak_lr
    ids, labels = prog.inputs[0], prog.labels[0]
    params = {n: t.detach().float().clone() for n, t in
              ((r, _named(prog.model.param_tree())[p]) for r, p in prog.names.items())}

    loss, grads = loss_and_grads(prog.model, prog.bundle.cfg, ids, labels)
    ref_loss, ref_grads = train_step(prog.spec, params, ids, labels)
    assert abs(float(loss) - ref_loss) <= 1e-5 * abs(ref_loss)
    named = _named(grads)
    assert set(ref_grads) == set(prog.names)
    for r, p in prog.names.items():
        _close(named[p], ref_grads[r], f"gradient of {r}")

    prog.step()  # one train step on batch 0: the clip and AdamW, in place
    m = {n: torch.zeros_like(t) for n, t in params.items()}
    v = {n: torch.zeros_like(t) for n, t in params.items()}
    adamw_step(prog.opt, params, ref_grads, m, v, 1)
    state = {k: _named(prog.opt_state[k]) for k in ("master", "m", "v")}
    for r, p in prog.names.items():
        steady = m[r].abs() / (1 - prog.opt.b1) >= 100 * prog.opt.eps
        _close(state["master"][p][steady], params[r][steady], f"master of {r}")
        assert (state["master"][p] - params[r]).abs().max() <= 2 * prog.opt.lr_at(1)
        _close(state["m"][p], m[r], f"m of {r}")
        _close(state["v"][p], v[r], f"v of {r}")


def test_steps_follow_the_warm_up():
    """Each step of the program runs at the learning rate the traffic's
    schedule gives the job's step of that number: a linear warm-up over
    ``warmup_tokens`` at ``global_batch_tokens`` a step."""
    prog = Program(tiny_cell("minicpm.train", seed=2 ** 33 + 12))
    o = prog.cell.traffic["optimizer"]
    for k in (1, 2, 3):
        prog.step()
        want = o["peak_lr"] * k * o["global_batch_tokens"] / o["warmup_tokens"]
        assert prog.bundle.lr == pytest.approx(want, rel=1e-12)
    assert prog.opt.lr_at(10 ** 9) == o["peak_lr"]
