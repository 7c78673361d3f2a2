"""The benchmark's readings of the program's own spans and counters
(``acsbench/spans.py``) and the seven readers on them: each reader gives
its value on a run with its readings and None on a run without them (a
program without ``repro_torch.trace``, or a model without a MoE layer);
the idle split of a made-up trace with nested program ranges adds up, with
the idle outside any span, to the stretch's idle; and ``inside_steps``
keeps a tiny program's spans and counters on the CPU."""

import types

import pytest
import torch

from _acsbench_cells import tiny_cell
from acsbench import harness, spans
from acsbench.devtrace import Profile
from acsbench.kinds import train

P = spans.PREFIX


def _profile():
    """Two steps of 1.0 s; device busy in [0.1, 0.2], [0.35, 0.5], [0.55,
    0.6], [0.9, 0.95] and [1.3, 1.4]. Host ranges: the forward (a block and
    a MoE routing inside it), the backward (a recompute's block on another
    thread), the clip and AdamW; the second step's forward only, and a gap
    inside that step after it."""
    kernels = [("k", 0.1, 0.2), ("k", 0.35, 0.5), ("k", 0.55, 0.6), ("k", 0.9, 0.95),
               ("k", 1.3, 1.4)]
    host = [("acsbench.step", 0.0, 1.0, 0), ("acsbench.step", 1.0, 2.0, 0),
            (P + "train.step", 0.05, 0.95, 1),
            (P + "train.forward", 0.05, 0.3, 2), (P + "block.ffn", 0.15, 0.28, 3),
            (P + "moe.route", 0.2, 0.25, 4), ("aten::sort", 0.21, 0.24, 5),
            (P + "train.backward", 0.3, 0.6, 2), (P + "block.mixer", 0.45, 0.55, 0),
            (P + "optim.clip", 0.6, 0.7, 2), (P + "optim.adamw", 0.75, 0.9, 2),
            (P + "train.step", 1.05, 1.5, 1), (P + "train.forward", 1.05, 1.2, 2)]
    return Profile(kernels=kernels, ops=[], host=host, stretch=(0.0, 2.0), steps=2)


def _inside(device_ms=True):
    rows = [("train.step", 800.0), ("train.forward", 200.0), ("train.backward", 450.0),
            ("optim.clip", 40.0), ("optim.adamw", 190.0)]
    spans_ = [{"name": n, "id": i, "parent": None, "step": k, "host_ms": 1.0,
               "device_ms": ms + k if device_ms else None}
              for k in (1, 2) for i, (n, ms) in enumerate(rows)]
    counters = {"moe.kept_rows": 300, "moe.capacity_rows": 400, "moe.assignments": 320,
                "moe.expert_rows": [100, 200, 0, 0]}
    return spans.Inside(steps=2, spans=spans_, counters=counters, launches={})


def test_idle_split_adds_up_to_the_stretch_idle():
    p = _profile()
    split = spans.idle_split(p)
    busy = 0.1 + 0.15 + 0.05 + 0.05 + 0.1
    assert split["total"] == pytest.approx(2.0 - busy)
    parts = [split[k] for k in spans.PHASES + ("train.step", "outside")]
    assert sum(parts) == pytest.approx(split["total"])
    # gaps: [0, .1) outside; [.2, .35) forward (the MoE routing inside it);
    # [.5, .55) backward (a recompute's block beside it); [.6, .9) clip;
    # [.95, 1.3) outside; [1.4, 2.0) inside the second step, after its forward
    assert split["train.forward"] == pytest.approx(0.15)
    assert split["train.backward"] == pytest.approx(0.05)
    assert split["optim.clip"] == pytest.approx(0.30)
    assert split["optim.adamw"] == 0.0 and split["train.step"] == pytest.approx(0.6)
    assert split["outside"] == pytest.approx(0.1 + 0.35)
    named = spans.named_gaps(p, top=3)
    assert [g[:3] for g in named] == [["train.step", P + "train.step", None],
                                      ["outside", None, None],
                                      ["optim.clip", P + "optim.clip", None]]
    assert spans.phase_at(p.host, 0.22) == "train.forward"
    assert [h[0] for h in spans._open_at(p.host, 0.22) if h[0].startswith("aten")] == [
        "aten::sort"]


def test_each_reader_gives_its_value_and_none_without_its_readings():
    p, inside = _profile(), _inside()
    run = types.SimpleNamespace(profile=p, inside=inside)
    want = {"fwd_ms": 201.5, "bwd_ms": 451.5, "clip_ms": 41.5, "adamw_ms": 191.5,
            "fwd_idle_ms": 75.0, "bwd_idle_ms": 25.0, "moe_rows_useful_pct": 75.0}
    for name in spans.READERS:
        assert harness.per_layer(name, run) == pytest.approx(want[name]), name
    bare = types.SimpleNamespace(profile=None)  # no profile, no program readings
    old = types.SimpleNamespace(                # a program without the spans
        profile=Profile(kernels=p.kernels, ops=[], host=[h for h in p.host
                                                         if not h[0].startswith(P)],
                        stretch=p.stretch, steps=2), inside=None)
    dense = types.SimpleNamespace(profile=p, inside=spans.Inside(2, inside.spans, {}, {}))
    cpu = types.SimpleNamespace(profile=p, inside=_inside(device_ms=False))
    for name in spans.READERS:
        assert harness.per_layer(name, bare) is None, name
        assert harness.per_layer(name, old) is None, name
    assert harness.per_layer("moe_rows_useful_pct", dense) is None
    assert harness.per_layer("fwd_ms", dense) == pytest.approx(201.5)
    assert harness.per_layer("fwd_ms", cpu) is None
    assert spans.span_ms(cpu.inside, "train.forward", "host_ms") == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["granite-moe.train", "minicpm.train"])
def test_inside_steps_keeps_a_tiny_programs_spans_and_counters(name):
    prog = train.Program(tiny_cell(name, seed=2 ** 33 + 5))
    inside = spans.inside_steps(lambda i: float(prog.step()["loss"]), 2)
    assert inside.steps == 2
    names = {s["name"] for s in inside.spans}
    assert set(spans.PHASES) | {"train.step", "block.mixer", "block.ffn"} <= names
    assert spans.span_ms(inside, "train.forward") is None  # no CUDA events on the CPU
    assert spans.span_ms(inside, "train.forward", "host_ms") > 0
    useful = spans.useful_rows_pct(inside)
    if name.startswith("granite"):
        c = inside.counters
        assert 0 < c["moe.kept_rows"] <= c["moe.capacity_rows"] and 0 < useful <= 100
        assert sum(c["moe.expert_rows"]) == c["moe.kept_rows"]
        assert {"moe.route", "moe.experts", "moe.combine"} <= names
    else:
        assert useful is None and not names & {"moe.route", "moe.experts", "moe.combine"}
    from repro_torch import trace

    assert not trace.enabled()
    assert torch.is_grad_enabled()
