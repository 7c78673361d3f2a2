"""What the benchmark finds by name: a cell in ``BENCHMARK.json``, its
configuration file (the path the entry names), its traffic file
(``traffic/<name>.json``), the driver of the traffic's ``kind``
(``kinds/<kind>.py``), each per-layer metric's reader
(``metrics/<name>.py``) and each count (``counts/<name>.py``). A later
cell, mix, metric or count is a new file and an entry, and no edit here.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

__all__ = ["ROOT", "load_benchmark", "find_cell", "metrics_of", "module", "counts",
           "per_layer", "op_share", "report", "compared_lines"]


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench: dict, name: str, root: Path = ROOT, base: Path = HERE) -> Dict[str, Any]:
    """The workload named ``name`` with its configuration (the file its
    entry names, under ``root``) and traffic (``base/traffic``) objects."""
    cells = [w for w in bench["workloads"] if w["name"] == name]
    if len(cells) != 1:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[0]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(root / entry["file"]) as f:
        config = json.load(f)
    with open(base / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return {"cell": cell, "config": config, "traffic": traffic}


def metrics_of(bench: dict, cell: str, group: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports: those
    without a ``workloads`` list, and those whose list names it."""
    return [m for m in bench[group] if cell in m.get("workloads", [cell])]


def module(folder: str, name: str, base: Path = HERE) -> ModuleType:
    """``<folder>/<name>.py`` under the benchmark (``base``), imported once."""
    key = f"acsbench.{folder}.{name}"
    if base != HERE:
        key = f"{key}@{base}"
    if key not in sys.modules:
        path = base / folder / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no {folder[:-1]} named {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def counts(name: str) -> ModuleType:
    return module("counts", name)


def per_layer(name: str, run: Any, base: Path = HERE) -> Optional[float]:
    """A per-layer metric's value in a traced run, or None."""
    return module("metrics", name, base).read(run)


ELEM_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def op_share(run: Any, names, bound_s) -> Optional[float]:
    """The percentage of the device time the profiled calls of operators
    ``names`` took that their least time (``bound_s(op, shapes, scalars,
    elem)``) is; None where the profile holds no such call or no time."""
    if getattr(run, "profile", None) is None:
        return None
    ops = run.profile.ops_named(names)
    took = sum(op.device_s for op in ops)
    if not ops or took <= 0:
        return None
    elem = ELEM_BYTES[run.spec.dtype]
    least = sum(bound_s(op.name, op.shapes, op.scalars, elem) for op in ops)
    return 100.0 * least / took


def report(bench: dict, workload: str, result: Any, trace: bool, setup_s: float,
           device_info: dict, log: Callable[[str], None] = lambda msg: None,
           base: Path = HERE) -> dict:
    """The result's line of a run of any kind (``kinds/__init__.py``): the
    cell's end-to-end metrics (``trace`` False) or its per-layer metrics,
    the device (a traced run's busy and window seconds with it), with
    ``trace`` the breakdown of the profiled steps, the kind's own checks,
    and last the numbers compared beside their limits. A metric the kind's
    run did not give, or whose reader finds nothing, is left out."""
    metrics = {}
    group = "per_layer" if trace else "end_to_end"
    values = dict(result.end_to_end, setup_s=setup_s)
    for m in metrics_of(bench, workload, group):
        value = per_layer(m["name"], result.run, base) if trace else values.get(m["name"])
        if value is None or not math.isfinite(value):
            log(f"{m['name']}: nothing to read")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": result.correct, "attempted": result.attempted, "failed": result.failed,
           "metrics": metrics, "device": device_info}
    if trace and result.busy_s is not None:
        device_info.update(busy_s=result.busy_s, window_s=result.run.window_s)
    profile = getattr(result.run, "profile", None)
    if trace and profile is not None:
        from acsbench.devtrace import breakdown

        out["breakdown"] = breakdown(profile)
    out["checks"] = result.checks
    out["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in result.compared.items()}
    return out


def compared_lines(result: Any) -> List[str]:
    """One line a compared number: its name, its value and its limit."""
    return [f"{k} {v!r} limit {lim!r}" for k, (v, lim) in result.compared.items()]
