"""Roofline driver (PyTorch port of ``repro/launch/roofline_run.py``): per
(arch x shape) on the 16 x 16 production mesh of H100s, the three
roofline terms (``launch/roofline.py``) from a trace of one rank's whole
step, with the reference's 1-stage and 2-stage traces beside it, plus the
useful FLOPs 6 N D (N_active for MoE) per device, to
``results/torch_roofline.json``. Like the dry run it needs no card.

``model_flops_per_device`` is also how ``chip_smoke.py`` reads a measured
step's model FLOP utilization against ``roofline.PEAK_FLOPS``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline_run --arch X --shape Y
  PYTHONPATH=src python -m repro_torch.launch.roofline_run --all [--skip-done]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..configs import ARCHS, SHAPES, cells, get_config

__all__ = ["model_flops_per_device", "run_cell", "save", "main", "RESULTS"]

RESULTS = Path(__file__).resolve().parents[3] / "results" / "torch_roofline.json"


def model_flops_per_device(cfg, shape_name: str, n_devices: int,
                           shapes: Dict[str, Tuple[int, int, str]] = SHAPES) -> float:
    """6*N*D useful-FLOPs accounting (N_active for MoE), per device, for a
    cell of ``shapes`` ((seq, batch, kind) by name; the assigned grid by
    default)."""
    seq, batch, kind = shapes[shape_name]
    n = cfg.n_active_params if cfg.moe is not None else cfg.n_params
    if kind == "train":
        tokens = seq * batch          # fwd+bwd: 6 N D
        factor = 6.0
    elif kind == "prefill":
        tokens = seq * batch          # fwd only: 2 N D
        factor = 2.0
    else:  # decode: one token per sequence
        tokens = batch
        factor = 2.0
    return factor * n * tokens / n_devices


def run_cell(arch: str, shape: str, verbose: bool = True):
    """One cell's record on the single-pod mesh, in a fake world of 256."""
    from .dryrun import trace_device
    from .mesh import fake_world, make_production_mesh
    from .roofline import analyze, roofline_terms

    cfg = get_config(arch)
    t0 = time.time()
    with fake_world(256):
        mesh = make_production_mesh(multi_pod=False, device=trace_device())
        total, m1, m2 = analyze(cfg, mesh, shape, SHAPES)
    mf = model_flops_per_device(cfg, shape, 256)
    terms = roofline_terms(total["flops"], total["bytes"], total["wire"], model_flops=mf,
                           wire_by_link={"nvlink": total["wire_nvlink"],
                                         "network": total["wire_network"]})
    record = {
        "arch": arch,
        "shape": shape,
        "analysis_s": round(time.time() - t0, 1),
        **terms.as_dict(),
        "wire_by_link": {"nvlink": total["wire_nvlink"], "network": total["wire_network"]},
        "one_stage": m1,
        "two_stage": m2,
    }
    if verbose:
        print(json.dumps(record, indent=2))
    return record


def save(record, path: Path = RESULTS):
    path.parent.mkdir(parents=True, exist_ok=True)
    data = json.loads(path.read_text()) if path.exists() else {}
    data[f'{record["arch"]}|{record["shape"]}'] = record
    path.write_text(json.dumps(data, indent=1, sort_keys=True))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    args = ap.parse_args(argv)

    done = set(json.loads(RESULTS.read_text())) if (
        args.skip_done and RESULTS.exists()) else set()

    archs = sorted(ARCHS) if args.all or not args.arch else [args.arch]
    failures = []
    for arch in archs:
        shapes = cells(get_config(arch)) if args.all or not args.shape else [args.shape]
        for shape in shapes:
            if f"{arch}|{shape}" in done:
                continue
            print(f"=== {arch} x {shape}", flush=True)
            try:
                rec = run_cell(arch, shape, verbose=False)
                save(rec)
                print(f"    dominant={rec['dominant']} "
                      f"compute={rec['compute_s']:.4f}s "
                      f"memory={rec['memory_s']:.4f}s "
                      f"collective={rec['collective_s']:.4f}s "
                      f"useful={rec['useful_flops_fraction']}", flush=True)
            except Exception as e:  # noqa: BLE001
                failures.append((arch, shape, repr(e)))
                print(f"    FAIL {e!r}", flush=True)
    if failures:
        print(f"{len(failures)} failures")
        for f in failures:
            print(" ", f[0], f[1], f[2][:160])
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
