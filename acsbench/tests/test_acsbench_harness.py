"""The harness finds what a later change adds as new files, by the names
``BENCHMARK.json`` gives: a configuration (the file its entry names), a
traffic mix (``traffic/<name>.json``), a per-layer metric's reader
(``metrics/<name>.py``) and a count (``counts/<name>.py``), with no edit
to a file that is there; and a metric that lists its cells is reported
only in them."""

import json
import shutil
import types
from pathlib import Path

import pytest

from acsbench import harness

BENCH = Path(__file__).resolve().parents[1]


@pytest.fixture
def tree(tmp_path):
    """A copy of the benchmark's data in a checkout of its own, plus a new
    configuration, traffic mix, metric and count."""
    base = tmp_path / "acsbench"
    for folder in ("configs", "traffic", "metrics", "counts"):
        shutil.copytree(BENCH / folder, base / folder)
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    config = json.loads((BENCH / "configs" / "minicpm-2b.json").read_text())
    config.update(name="minicpm-2b-deep", num_hidden_layers=52)
    (base / "configs" / "minicpm-2b-deep.json").write_text(json.dumps(config))
    traffic = json.loads((BENCH / "traffic" / "train.b4s512.json").read_text())
    traffic.update(batch=1, seq=4096)
    (base / "traffic" / "train.b1s4096.json").write_text(json.dumps(traffic))
    (base / "counts" / "twice.py").write_text("def of(x):\n    return 2 * x\n")
    (base / "metrics" / "steps_seen.py").write_text(
        "from acsbench import harness\n\n\ndef read(run):\n"
        "    return float(run.steps) if run.steps else None\n")
    bench["configs"].append({"name": "minicpm-2b-deep", "source": "https://example.org/a",
                             "file": "acsbench/configs/minicpm-2b-deep.json", "reduced": [],
                             "why": "deeper"})
    bench["workloads"].append({"name": "minicpm-deep.train.seq4k", "config": "minicpm-2b-deep",
                               "traffic": "train.b1s4096", "chips": 4, "why": "long"})
    bench["end_to_end"].append({"name": "serve_tokens_per_s", "unit": "tokens/s",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["minicpm-deep.train.seq4k"]})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "device",
                               "moves": "train_tokens_per_s",
                               "workloads": ["minicpm-deep.train.seq4k"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path, base


def test_new_files_are_found_by_name(tree):
    root, base = tree
    bench = harness.load_benchmark(root)
    found = harness.find_cell(bench, "minicpm-deep.train.seq4k", root, base)
    assert found["config"]["num_hidden_layers"] == 52
    assert (found["traffic"]["batch"], found["traffic"]["seq"]) == (1, 4096)
    assert found["cell"]["chips"] == 4
    assert harness.module("counts", "twice", base).of(21) == 42
    run = types.SimpleNamespace(steps=17)
    assert harness.module("metrics", "steps_seen", base).read(run) == 17.0
    assert harness.module("metrics", "steps_seen", base).read(
        types.SimpleNamespace(steps=0)) is None


def test_metrics_of_a_cell(tree):
    root, _ = tree
    bench = harness.load_benchmark(root)
    new = {m["name"] for m in harness.metrics_of(bench, "minicpm-deep.train.seq4k", "per_layer")}
    old = {m["name"] for m in harness.metrics_of(bench, "minicpm.train", "per_layer")}
    assert "steps_seen" in new and "steps_seen" not in old
    assert "gmm_roofline" not in new and "gmm_roofline" not in old
    e2e = {m["name"] for m in harness.metrics_of(bench, "minicpm-deep.train.seq4k", "end_to_end")}
    assert {"serve_tokens_per_s", "setup_s", "train_tokens_per_s"} <= e2e


def test_every_committed_metric_and_cell_has_its_files():
    bench = harness.load_benchmark()
    for m in bench["per_layer"]:
        assert callable(harness.module("metrics", m["name"]).read), m["name"]
    for w in bench["workloads"]:
        found = harness.find_cell(bench, w["name"])
        kind = harness.module("kinds", found["traffic"]["kind"])
        assert callable(kind.run)
        assert harness.metrics_of(bench, w["name"], "per_layer")


def test_unknown_names_are_refused():
    bench = harness.load_benchmark()
    with pytest.raises(KeyError):
        harness.find_cell(bench, "no-such.cell")
    with pytest.raises(FileNotFoundError):
        harness.module("metrics", "no_such_metric")


STUB_KIND = '''
import dataclasses, types


@dataclasses.dataclass
class Cell:
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    log: object = None


def run(cell):
    return types.SimpleNamespace(
        end_to_end={"serve_tokens_per_s": 123.5}, attempted=9, failed=0, correct=True,
        compared={"token_gap": (0.25, 1.0)}, checks={"served": 9}, memory_peak_bytes=1,
        setup_end=0.0, run=types.SimpleNamespace(steps=9, window_s=2.0), busy_s=1.5)
'''


def test_report_takes_a_kind_whose_metrics_are_its_own(tree):
    """A cell of a new kind (a stub here) that gives only an end-to-end
    metric the first cells do not report is reported without an edit: the
    metrics it does not give are left out, and its checks and compared
    numbers are its own."""
    root, base = tree
    (base / "kinds").mkdir()
    (base / "kinds" / "stub.py").write_text(STUB_KIND)
    (base / "traffic" / "serve.stub.json").write_text(json.dumps({"kind": "stub"}))
    bench = harness.load_benchmark(root)
    bench["workloads"].append({"name": "minicpm.serve", "config": "minicpm-2b",
                               "traffic": "serve.stub", "chips": 1, "why": "a stub"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("serve_tokens_per_s", "steps_seen"):
            m["workloads"].append("minicpm.serve")
    found = harness.find_cell(bench, "minicpm.serve", root, base)
    kind = harness.module("kinds", found["traffic"]["kind"], base)
    result = kind.run(kind.Cell(config=found["config"], traffic=found["traffic"], seed=1,
                                seconds=1.0, trace=False, device=None))

    line = harness.report(bench, "minicpm.serve", result, False, 4.25, {}, base=base)
    assert line["metrics"] == {"serve_tokens_per_s": {"value": 123.5, "unit": "tokens/s"},
                               "setup_s": {"value": 4.25, "unit": "s"}}
    assert line["checks"] == {"served": 9} and list(line)[-1] == "compared"
    assert line["compared"] == {"token_gap": {"value": 0.25, "limit": 1.0}}
    assert harness.compared_lines(result) == ["token_gap 0.25 limit 1.0"]

    traced = harness.report(bench, "minicpm.serve", result, True, 4.25, {}, base=base)
    assert traced["metrics"]["steps_seen"] == {"value": 9.0, "unit": "steps"}
    assert traced["device"] == {"busy_s": 1.5, "window_s": 2.0}
