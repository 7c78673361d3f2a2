"""The port's examples (``examples/torch_*.py``) against the reference's
(``examples/*.py``) on the CPU, in one process.

Each reference example is loaded from its file with ``importlib``, run
with ``sys.argv`` patched, and its printed numbers read from ``capsys``;
the port's ``main(argv)`` returns its numbers. The reference runs each
wave of its wave scheduler as one compiled program, one dispatch a wave;
the port runs a wave as one call per signature group (a convolution's
group one call a task on the CPU, ``core/executors.py``), so where the
reference prints a wave scheduler's dispatches the port's waves are held
to them. Every other scheduler dispatches the same calls in both. The
reference's frontier asks JAX whether a group has landed, which on the CPU
depends on timing; its probe is pinned to "landed", as the port's CPU
executor is (``tests/test_torch_frontier.py``).

Tolerances: counts, wave widths (as printed, one decimal), request ids,
tokens and drains exactly; physics rewards within 1e-4 relative (the
reference's from its own state snapshots, at full precision); an image's
class wherever the reference's two largest logits differ by more than
1e-4. Without a card each example's default ``--device cuda`` raises the
port's error instead of running on the CPU.
"""

import dataclasses
import importlib.util
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import models as RM
from repro.configs import ARCHS as R_ARCHS
from repro.core import executors as R_EXEC
from repro_torch.core import SCHEDULER_NAMES
from repro_torch.dyn import params_from_numpy as dyn_params_from_numpy
from repro_torch.models import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "physics_rl", "dynamic_dnn_inference", "serve_continuous")
REWARD_RTOL = 1e-4
LOGIT_MARGIN = 1e-4


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_example_{name}", ROOT / "examples" /
                                                  f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _landed(monkeypatch):
    monkeypatch.setattr(R_EXEC, "_is_ready", lambda arr: True)


def _run_reference(mod, argv, capsys, monkeypatch, fn=None):
    monkeypatch.setattr(sys, "argv", [f"{mod.__name__}.py", *argv])
    capsys.readouterr()
    (fn or mod.main)()
    return capsys.readouterr().out


def test_quickstart_matches_the_reference(capsys, monkeypatch):
    text = _run_reference(_load("quickstart"), [], capsys, monkeypatch)
    ref = dict(re.findall(r"^(.+?)\s+: (\S+)$", text, re.M))
    got = _load("torch_quickstart").main(["--device", "cpu"])
    assert got["kernels"] == int(ref["kernels launched"])
    assert got["serial_dispatches"] == int(ref["serial dispatches"])
    assert got["acs_waves"] == int(ref["ACS dispatches"])  # one a wave there
    assert got["acs_waves"] <= got["acs_dispatches"] <= got["kernels"]
    assert f"{got['mean_wave_width']:.1f}" == ref["ACS mean wave width"]
    assert got["max_wave_width"] == int(ref["max wave width"])
    assert got["identical"] and ref["results identical"] == "True"
    assert np.array_equal(got["serial_state"], got["acs_state"])


_STEP = re.compile(r"^step (\d+): kernels=(\d+) dispatches=(\d+) wave_width=(\S+) "
                   r"reward=\S+(?: syncs=(\d+) inflight=(\d+))?$", re.M)


@pytest.mark.parametrize("scheduler", SCHEDULER_NAMES)
def test_physics_rl_matches_the_reference(scheduler, capsys, monkeypatch):
    ref_mod = _load("physics_rl")
    snapshots = []

    class Recording(ref_mod.PhysicsEngine):
        def state_snapshot(self):
            snapshots.append(super().state_snapshot())
            return snapshots[-1]

    monkeypatch.setattr(ref_mod, "PhysicsEngine", Recording)
    text = _run_reference(ref_mod, ["cheetah", "2", scheduler], capsys, monkeypatch)
    rows = _STEP.findall(text)
    assert len(rows) == 2 and "states finite: True" in text
    got = _load("torch_physics_rl").main(["cheetah", "2", scheduler, "--device", "cpu"])
    assert got["finite"] and len(got["steps"]) == 2
    waves = 0
    for (_, kernels, dispatches, width, syncs, inflight), snap, mine in zip(
            rows, snapshots, got["steps"]):
        waves += mine["waves"]
        assert mine["kernels"] == int(kernels)
        # the wave scheduler's reference dispatches are its waves so far
        assert (waves if scheduler == "wave" else mine["dispatches"]) == int(dispatches)
        assert f"{mine['wave_width']:.1f}" == width
        want = float(-np.linalg.norm(snap[..., :3], axis=-1).mean())
        assert mine["reward"] == pytest.approx(want, rel=REWARD_RTOL)
        if syncs:
            assert (mine["syncs"], mine["inflight"]) == (int(syncs), int(inflight))
        else:
            assert "syncs" not in mine


_IMAGE = re.compile(r"^image (\d+): +(\d+) blocks active, +(\d+) kernels -> +(\d+) dispatches, "
                    r"class=(\d+)", re.M)


def test_dynamic_dnn_inference_matches_the_reference(capsys, monkeypatch):
    from repro.core import TaskStream, run_serial
    from repro.dyn import WORKLOADS

    ref_mod = _load("dynamic_dnn_inference")
    text = _run_reference(ref_mod, ["3"], capsys, monkeypatch)
    rows = _IMAGE.findall(text)
    assert len(rows) == 3
    # The reference's weights (its classifier is drawn at the first build)
    # and its logits for the same three images, run serially.
    init_fn, build_fn, _ = WORKLOADS["instanas"]
    params = init_fn(seed=0)
    rng = np.random.RandomState(0)
    logits = []
    for i in range(3):
        x = rng.randn(1, 3, 32, 32).astype(np.float32) * (1 + 0.5 * i)
        stream = TaskStream()
        out = build_fn(params, stream, x)
        run_serial(stream.tasks)
        logits.append(np.asarray(out.value).reshape(-1))
    arrays = {k: np.asarray(b.value) for k, b in params.weights.items()}
    port = _load("torch_dynamic_dnn_inference")
    got = port.classify(dyn_params_from_numpy("instanas", arrays, device="cpu"), 3, "cpu")
    assert got["compiles"] == 0  # eager PyTorch builds no program
    for (_, active, kernels, dispatches, cls), want, mine in zip(rows, logits, got["images"]):
        assert (mine["active"], mine["kernels"], mine["waves"]) == (
            int(active), int(kernels), int(dispatches))
        assert mine["waves"] <= mine["dispatches"] <= mine["kernels"]
        top2 = np.sort(want)[-2:]
        if top2[1] - top2[0] > LOGIT_MARGIN:
            assert mine["class"] == int(cls) == int(np.argmax(want))


def _served(text, kind):
    submitted = [int(r) for r in re.findall(rf"^\[{kind} \S+ \d+\] submitted request (\d+)",
                                            text, re.M)]
    finished = [(int(r), [int(t) for t in toks.split(",") if t.strip()])
                for r, toks in re.findall(rf"^\[{kind} \S+ \d+\] finished request (\d+): "
                                          r"tokens \[([^\]]*)\]", text, re.M)]
    return submitted, finished


def test_serve_continuous_matches_the_reference(capsys, monkeypatch):
    ref_mod = _load("serve_continuous")
    rcfg = dataclasses.replace(R_ARCHS["h2o-danube-3-4b"].reduced(), n_layers=2, d_model=64,
                               d_ff=128, vocab=512, dtype="float32")
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(0), tp_size=1)
    port = _load("torch_serve_continuous")
    cfg = dataclasses.replace(port.ARCHS["h2o-danube-3-4b"].reduced(), n_layers=2, d_model=64,
                              d_ff=128, vocab=512, dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    for kind, ref_fn, fn in (("batch", ref_mod.run_batch, port.run_batch),
                             ("session", ref_mod.run_session, port.run_session)):
        text = _run_reference(ref_mod, [], capsys, monkeypatch,
                              lambda f=ref_fn: f(rcfg, rparams, np.random.RandomState(0)))
        submitted, finished = _served(text, kind)
        got = fn(cfg, params, np.random.RandomState(0), "cpu")
        base_r, base_p = submitted[0], got["requests"][0]["rid"]
        assert [r["rid"] - base_p for r in got["requests"]] == [r - base_r for r in submitted]
        tokens = {r["rid"] - base_p: r["tokens"] for r in got["requests"]}
        assert {r - base_r: toks for r, toks in finished} == tokens
        assert all(len(t) == 6 for t in tokens.values())
        if kind == "batch":  # the batch server's drains are in program order
            assert [r - base_p for r in got["finished"]] == [r - base_r for r, _ in finished]
            drains, multi = re.search(r"in (\d+) drains; (\d+) drains co-scheduled",
                                      text).groups()
            assert (got["drains"], got["co_scheduled"]) == (int(drains), int(multi))
        else:
            assert sorted(got["finished"]) == sorted(r["rid"] for r in got["requests"])


@pytest.mark.parametrize("name", EXAMPLES)
def test_default_device_raises_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load(f"torch_{name}").main([])
