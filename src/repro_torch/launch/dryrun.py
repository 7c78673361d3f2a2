"""Production-mesh dry run (PyTorch port of ``repro/launch/dryrun.py``):
for each (arch x shape x mesh) cell, trace one rank's step over the
production mesh of H100s, 16 x 16 = 256 cards or 2 x 16 x 16 = 512, in a
fake world of that many ranks in this one process (``mesh.fake_world``),
with fake tensors: no card, no allocation, no kernel build or launch. The
record holds what one card computes (FLOPs), moves (collectives by kind,
link and mesh axis) and holds (argument, output and peak bytes, and
whether the peak fits the card), to ``results/torch_dryrun.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm-2b --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] [--skip-done]

The trace's fake tensors are CUDA tensors where PyTorch has a card, else
CPU tensors standing in for the card's (the counts are the same).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from ..configs import ARCHS, SHAPES, cells, get_config
from .mesh import fake_world, make_production_mesh
from .roofline import collective_bytes
from .steps import StepBundle

__all__ = ["CARD_MEMORY_BYTES", "CARD", "run_cell", "save", "main", "trace_device", "RESULTS"]

RESULTS = Path(__file__).resolve().parents[3] / "results" / "torch_dryrun.json"

# The card's memory as torch.cuda.get_device_properties(0).total_memory reports
# it on an H100 80GB HBM3 (SXM) at a 700 W power limit (chip_smoke.py's
# dry-run phase logs it).
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
CARD_MEMORY_BYTES = 85_017_493_504


def trace_device() -> str:
    """The device type of the trace's fake tensors: the card's where this
    PyTorch has one, else the CPU's."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape: str, multi_pod: bool, *, verbose: bool = True) -> Dict[str, Any]:
    """One cell's record: trace the arch's step for ``shape`` over the
    production mesh in a fake world of 256 (or 512) ranks."""
    n = 512 if multi_pod else 256
    with fake_world(n):
        mesh = make_production_mesh(multi_pod=multi_pod, device=trace_device())
        bundle = StepBundle(get_config(arch), mesh)
        t = bundle.trace(shape, SHAPES)
    coll = collective_bytes(t["records"])
    record = {
        "arch": arch,
        "shape": shape,
        "mesh": _mesh_name(multi_pod),
        "n_devices": n,
        "trace_s": round(t["trace_s"], 2),
        "flops_per_device": t["flops"],
        "bytes_per_device": t["bytes"],
        "collectives": coll,
        "memory": {
            "argument_bytes": t["argument_bytes"],
            "output_bytes": t["output_bytes"],
            "peak_bytes": t["peak_bytes"],
        },
        "peak_bytes": t["peak_bytes"],
        "fits": t["peak_bytes"] <= CARD_MEMORY_BYTES,
        "card_memory_bytes": CARD_MEMORY_BYTES,
        "policy": {k: getattr(t["policy"], k) for k in (
            "dp", "tp_size", "dp_size", "shard_heads", "shard_kv_heads", "shard_experts",
            "seq_shard_attn", "batch_shardable")},
    }
    if verbose:
        print(json.dumps(record, indent=2, default=str))
    return record


def save(record: Dict[str, Any], path: Path = RESULTS) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    data = json.loads(path.read_text()) if path.exists() else {}
    data[f'{record["arch"]}|{record["shape"]}|{record["mesh"]}'] = record
    path.write_text(json.dumps(data, indent=1, sort_keys=True, default=str))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    args = ap.parse_args(argv)

    done = set()
    if args.skip_done and RESULTS.exists():
        done = set(json.loads(RESULTS.read_text()))

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    todo = []
    archs = sorted(ARCHS) if args.all or not args.arch else [args.arch]
    for arch in archs:
        shapes = cells(get_config(arch)) if args.all or not args.shape else [args.shape]
        for shape in shapes:
            for mp in meshes:
                if f"{arch}|{shape}|{_mesh_name(mp)}" not in done:
                    todo.append((arch, shape, mp))

    failures = []
    for arch, shape, mp in todo:
        tag = f'{arch} x {shape} x {"multi" if mp else "single"}'
        print(f"=== {tag}", flush=True)
        try:
            t0 = time.time()
            record = run_cell(arch, shape, mp, verbose=False)
            save(record)
            print(f"    ok: trace {record['trace_s']}s ({time.time() - t0:.1f}s in all), "
                  f"flops/dev {record['flops_per_device']:.3e}, "
                  f"coll {record['collectives']['total_bytes']:.3e} B, "
                  f"peak {record['peak_bytes'] / 2**30:.2f} GiB "
                  f"({'fits' if record['fits'] else 'does NOT fit'})", flush=True)
        except Exception as e:  # noqa: BLE001 - report and continue
            failures.append((tag, repr(e)))
            print(f"    FAIL: {e!r}", flush=True)
    if failures:
        print(f"{len(failures)} FAILURES:")
        for tag, err in failures:
            print(" ", tag, err[:200])
        return 1
    print(f"dry-run complete: {len(todo)} cells")
    return 0


if __name__ == "__main__":
    sys.exit(main())
