"""Hill-climbing driver (PyTorch port of ``repro/launch/hillclimb.py``):
apply named optimization steps to a cell, re-derive its roofline terms on
the 16 x 16 mesh of H100s after each (``roofline.analyze``: one rank's
whole step traced in a fake world of 256, no card), and append each step's
hypothesis and terms to ``results/torch_perf_iterations.json``.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell minicpm-2b/train_4k
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --all

The plans are the reference's three; the hypotheses name the mechanism
each step acts on, and the record holds the port's own before and
after.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import List, Optional

from ..configs import SHAPES, get_config
from ..models.transformer import remat_policy
from .roofline import analyze, roofline_terms
from .roofline_run import model_flops_per_device

__all__ = ["PLANS", "measure", "run_cell", "main", "RESULTS"]

RESULTS = Path(__file__).resolve().parents[3] / "results" / "torch_perf_iterations.json"


def _pad_heads(cfg, n):
    return dataclasses.replace(cfg, pad_heads_to=n)


def _bf16_combine(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, combine_dtype="bfloat16"))


def _capacity(cfg, f):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=f))


def _grouped_dispatch(cfg, g):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch_groups=g))


# Each step: (name, hypothesis, config transform, remat policy)
PLANS = {
    "minicpm-2b/train_4k": [
        ("pad_heads_48",
         "36 heads don't divide TP=16, so attention is sequence-sharded: k and v are "
         "gathered across 'model' every layer (forward, backward and recompute), and the "
         "q/k/v/o projections run replicated on every 'model' rank. Padding heads to 48 "
         "(zero heads, numerics-exact) shards attention 16-way: predicted collective term "
         "down (the gathers go, the Megatron all-reduces stay), useful-FLOPs fraction up "
         "(the replicated projections go).",
         lambda c: _pad_heads(c, 48), "nothing"),
        ("remat_dots",
         "The per-stage recompute redoes every stage's forward in the backward, its "
         "collectives included. Saving the products' outputs skips the recompute of the "
         "GEMMs and their all-reduces: predicted collective term down by about a third, "
         "compute term down, peak memory up.",
         lambda c: c, "dots"),
    ],
    "granite-moe-3b-a800m/train_4k": [
        ("pad_heads_32",
         "24 heads vs TP=16: the same sequence-sharded fallback as minicpm, with the "
         "attention projections replicated over 'model'. Pad to 32: predicted collective "
         "term down, useful-FLOPs fraction up.",
         lambda c: _pad_heads(c, 32), "nothing"),
        ("bf16_combine",
         "The MoE output combine (each rank's experts' share, summed over 'model') is the "
         "layer's all-reduce and rides in float32. A bfloat16 wire format halves those "
         "bytes: predicted collective term down by the MoE combine's half.",
         _bf16_combine, "nothing"),
        ("remat_dots",
         "As for minicpm: skip the backward's recompute of the expert GEMMs and their "
         "combines; predicted collective term down by about a third.",
         lambda c: c, "dots"),
        ("grouped_dispatch_16",
         "With one global dispatch group, every rank routes the whole batch: the tokens are "
         "gathered over the data axis and the combine's all-reduce carries 16x the rank's "
         "own tokens. Routing within 16 batch-aligned groups (= the data ranks) keeps "
         "dispatch, experts and combine on each rank's own tokens: predicted collective "
         "term down to a fraction.",
         lambda c: _grouped_dispatch(c, 16), "dots"),
    ],
    "deepseek-v2-236b/train_4k": [
        ("bf16_combine",
         "The expert combine's all-reduce over 'model' ([tokens, 5120] for each of 59 MoE "
         "layers, forward, backward and recompute) rides in float32; bfloat16 halves it: "
         "predicted collective term down by about the combine's half.",
         _bf16_combine, "nothing"),
        ("remat_dots",
         "The recompute redoes the forward's gathers and all-reduces in the backward. Saving "
         "the products' outputs skips the GEMMs' recompute: predicted compute term down, "
         "peak memory up.",
         lambda c: c, "dots"),
        ("capacity_1.0",
         "A capacity factor of 1.25 inflates every expert GEMM and its gather and combine "
         "rows by 25 %. 1.0 cuts MoE compute and combine bytes by a fifth, at the cost of "
         "more dropped assignments.",
         lambda c: _capacity(c, 1.0), "dots"),
        ("grouped_dispatch_16",
         "As for granite: one global dispatch group makes every rank route the whole batch. "
         "16 batch-aligned groups keep the MoE block on each rank's own tokens: predicted "
         "collective term down to a fraction, and the step's memory within the card.",
         lambda c: _grouped_dispatch(c, 16), "dots"),
    ],
}


def measure(cfg, shape, policy_name):
    """The cell's roofline terms on the single-pod mesh under the remat
    policy ``policy_name``."""
    from .dryrun import trace_device
    from .mesh import fake_world, make_production_mesh

    with fake_world(256), remat_policy(policy_name):
        mesh = make_production_mesh(multi_pod=False, device=trace_device())
        total, _, _ = analyze(cfg, mesh, shape, SHAPES, unrolled=False)
    mf = model_flops_per_device(cfg, shape, 256)
    return roofline_terms(total["flops"], total["bytes"], total["wire"], model_flops=mf,
                          wire_by_link={"nvlink": total["wire_nvlink"],
                                        "network": total["wire_network"]})


def run_cell(cell: str):
    """Baseline, then each step of ``PLANS[cell]`` cumulatively; a step
    already in the results file is skipped."""
    arch, shape = cell.split("/")
    base_cfg = get_config(arch)
    path = RESULTS

    data = json.loads(path.read_text()) if path.exists() else {}
    log = data.get(cell, [])
    done = {e["step"] for e in log}

    def write():
        data[cell] = log
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(data, indent=1))

    if "baseline" not in done:
        t0 = time.time()
        t = measure(base_cfg, shape, "nothing")
        log.append({"step": "baseline", "hypothesis": "(the reference's configuration)",
                    "analysis_s": round(time.time() - t0, 1), **t.as_dict()})
        print(f"[{cell}] baseline: {t.as_dict()}", flush=True)
        write()

    cfg = base_cfg
    for name, hypothesis, transform, pol in PLANS[cell]:
        cfg = transform(cfg)
        if name in done:
            continue
        t0 = time.time()
        t = measure(cfg, shape, pol)
        log.append({"step": name, "hypothesis": hypothesis,
                    "analysis_s": round(time.time() - t0, 1), **t.as_dict()})
        print(f"[{cell}] {name}: dominant={t.dominant} "
              f"c={t.compute_s:.3f} m={t.memory_s:.3f} x={t.collective_s:.3f} "
              f"useful={t.useful_flops_fraction:.3f}", flush=True)
        write()
    write()
    return log


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default=None)
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)
    for cell in (list(PLANS) if args.all or not args.cell else [args.cell]):
        run_cell(cell)
    return 0


if __name__ == "__main__":
    sys.exit(main())
