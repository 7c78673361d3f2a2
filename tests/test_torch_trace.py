"""The port's spans and counters (``repro_torch.trace``) on a tiny
granite-shaped MoE model's train step (two layers, four experts, top 2,
remat on), on the CPU.

Off, a span keeps nothing and adds no operator: a profiled step holds the
operators of the same step with the spans stubbed out, and only the
``repro_torch.`` ranges besides. On, every span of the step fires with its
parent (the recompute's blocks under ``train.backward``), step ids advance
once a step, and ``collect`` reads the counters back once and clears."""

from __future__ import annotations

import collections
import contextlib
import importlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.configs import ARCHS
from repro_torch.launch.steps import StepBundle
from repro_torch.models import init_params
from repro_torch.optim import adamw_init

CFG = ARCHS["granite-moe-3b-a800m"].reduced()
B, S = 2, 16

SPANS = ("train.step", "train.forward", "train.backward", "optim.clip", "optim.adamw",
         "block.mixer", "block.ffn", "moe.route", "moe.experts", "moe.combine")


@pytest.fixture(autouse=True)
def off_after():
    yield
    trace.disable()
    trace.collect()


def _trainer(seed: int = 0):
    params = init_params(CFG, seed, device="cpu", tp_size=1).requires_grad_(True)
    opt = adamw_init(params.param_tree())
    bundle = StepBundle(CFG, lr=1e-3)
    gen = torch.Generator().manual_seed(seed)
    batches = [(torch.randint(0, CFG.vocab, (B, S), generator=gen, dtype=torch.int32),
                torch.randint(0, CFG.vocab, (B, S), generator=gen, dtype=torch.int32))
               for _ in range(3)]

    def step(i: int):
        _, _, out = bundle.train_step(params, opt, *batches[i])
        return float(out["loss"])

    return step


def _ops(prof) -> collections.Counter:
    return collections.Counter(e.name for e in prof.events()
                               if not e.name.startswith(trace.PREFIX))


def test_off_adds_no_operator_and_keeps_nothing(monkeypatch):
    assert not trace.enabled()
    assert trace.span("train.forward") is trace.span("block.ffn")  # the shared null context
    step = _trainer()
    step(0)  # caches filled outside the profiled step
    with profile(activities=[ProfilerActivity.CPU]) as traced:
        loss_spans = step(1)
    names = {e.name for e in traced.events()}
    assert {trace.PREFIX + n for n in SPANS} <= names  # the ranges a profiler sees
    kept = trace.collect()
    assert (kept["steps"], kept["spans"], kept["counters"]) == (0, [], {})
    assert not any(kept["launches"].values())

    monkeypatch.setattr(trace, "span", lambda name: contextlib.nullcontext())
    step = _trainer()
    step(0)
    with profile(activities=[ProfilerActivity.CPU]) as stubbed:
        loss_stubbed = step(1)
    assert not any(e.name.startswith(trace.PREFIX) for e in stubbed.events())
    assert _ops(traced) == _ops(stubbed)
    assert loss_spans == loss_stubbed


def test_on_every_span_fires_with_its_parent():
    step = _trainer()
    trace.enable()
    losses = [step(0), step(1)]
    got = trace.collect()
    trace.disable()
    assert got["steps"] == 2 and all(x == x for x in losses)
    spans = got["spans"]
    by_id = {s["id"]: s for s in spans}
    parent = lambda s: by_id[s["parent"]]["name"] if s["parent"] is not None else None  # noqa: E731
    assert {s["name"] for s in spans} == set(SPANS)
    assert all(s["device_ms"] is None and s["host_ms"] >= 0 for s in spans)  # no CUDA here

    steps = [s for s in spans if s["name"] == "train.step"]
    assert [s["step"] for s in steps] == [1, 2] and all(parent(s) is None for s in steps)
    want = {"train.forward": "train.step", "train.backward": "train.step",
            "optim.clip": "train.step", "optim.adamw": "train.step",
            "block.ffn": {"train.forward", "train.backward"},
            "block.mixer": {"train.forward", "train.backward"},
            "moe.route": "block.ffn", "moe.experts": "block.ffn", "moe.combine": "block.ffn"}
    for s in spans:
        if s["name"] in want:
            ok = want[s["name"]]
            assert parent(s) in (ok if isinstance(ok, set) else {ok}), (s, parent(s))
        assert s["step"] == by_id[s["parent"]]["step"] if s["parent"] is not None else True

    for k in (1, 2):
        mine = [s for s in spans if s["step"] == k]
        per = collections.Counter((s["name"], parent(s)) for s in mine)
        for name in ("train.forward", "train.backward", "optim.clip", "optim.adamw"):
            assert per[(name, "train.step")] == 1
        # each layer's blocks run in the forward, and again in the recompute
        assert per[("block.mixer", "train.forward")] == CFG.n_layers
        assert per[("block.mixer", "train.backward")] == CFG.n_layers
        assert per[("block.ffn", "train.backward")] == CFG.n_layers
        assert per[("moe.route", "block.ffn")] == 2 * CFG.n_layers
    assert got["counters"]["moe.capacity_rows"] > 0


def test_step_ids_advance_once_a_step_and_collect_clears():
    step = _trainer()
    trace.enable()
    step(0)
    first = trace.collect()
    step(1)
    step(2)
    second = trace.collect()
    assert first["steps"] == 1 and second["steps"] == 2
    assert {s["step"] for s in first["spans"]} == {1}
    assert {s["step"] for s in second["spans"]} == {2, 3}
    assert not set(s["id"] for s in first["spans"]) & set(s["id"] for s in second["spans"])
    assert trace.collect() == {"steps": 0, "spans": [], "counters": {}, "launches": {
        k: 0 for k in second["launches"]}}


def test_collect_reads_the_counters_once_and_clears(monkeypatch):
    gm = importlib.import_module("repro_torch.kernels.grouped_matmul")
    trace.count("ignored", 5)  # off: nothing
    trace.enable()
    trace.count("rows", torch.tensor(3))
    trace.count("rows", torch.tensor(4))
    trace.count("per_expert", torch.tensor([1, 0, 2]))
    trace.count("per_expert", torch.tensor([1, 1, 1]))
    trace.count("share", torch.tensor(0.25))
    trace.count("capacity", 10)
    trace.count("capacity", 6)
    monkeypatch.setattr(gm, "launches", gm.launches + 3)
    monkeypatch.setattr(gm, "dx_paths", dict(gm.dx_paths, wgmma=gm.dx_paths["wgmma"] + 2))
    reads = []
    tolist = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist", lambda t: reads.append(t.shape) or tolist(t))
    got = trace.collect()
    assert len(reads) == 1  # one transfer for every device counter
    assert got["counters"] == {"rows": 7, "per_expert": [2, 1, 3], "share": 0.25,
                               "capacity": 16}
    assert got["launches"]["grouped_matmul.launches"] == 3
    assert got["launches"]["grouped_matmul.dx_paths.wgmma"] == 2
    assert got["launches"]["flash_attention.launches"] == 0
    assert trace.collect()["counters"] == {}
    trace.disable()
    trace.count("rows", torch.tensor(1))
    assert trace.collect()["counters"] == {}
