"""Training launcher (PyTorch port of ``repro/launch/train.py``): a config,
the resumable data pipeline, ``StepBundle.train_step`` and checkpoints, on
one card (or the CPU).

    python -m repro_torch.launch.train --arch minicpm-2b --steps 10 [--smoke] [--device cuda]

``--smoke`` takes the arch's reduced config (a CPU run end to end). The
reference's TPU meshes (``--multi-pod``) and sharded params are not
ported. A run resumes from the last checkpoint under ``--ckpt``.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..data import DataCursor, TokenPipeline
from ..models import init_params
from ..models.convert import (load_params_, opt_state_from_numpy, opt_state_to_numpy,
                              params_to_numpy)
from ..optim import adamw_init
from .steps import StepBundle


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU end to end)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default="results/ckpt_launch_train")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    device = torch.device(args.device)
    bundle = StepBundle(cfg, lr=args.lr)
    params = init_params(cfg, 0, device=device, tp_size=1).requires_grad_(True)
    opt = adamw_init(params.param_tree())

    ckpt = CheckpointManager(Path(args.ckpt))
    pipeline = TokenPipeline(cfg.vocab, args.seq, args.batch, seed=0)
    state = lambda: {"params": params_to_numpy(params), "opt": opt_state_to_numpy(opt)}  # noqa: E731
    restored = ckpt.restore_latest(state())
    start = 0
    if restored is not None:
        tree, extras = restored
        load_params_(params, tree["params"])
        opt = opt_state_from_numpy(tree["opt"], cfg, device=device)
        pipeline.seek(DataCursor.from_dict(extras["cursor"]))
        start = int(extras["step"]) + 1
        print(f"resumed at step {start}")

    for step in range(start, args.steps):
        inputs, labels = (torch.from_numpy(a).to(device) for a in pipeline.next_batch())
        t0 = time.perf_counter()
        params, opt, m = bundle.train_step(params, opt, inputs, labels)
        loss, gnorm = float(m["loss"]), float(m["gnorm"])
        dt = (time.perf_counter() - t0) * 1e3
        print(f"step {step}: loss {loss:.4f} gnorm {gnorm:.2f} {dt:.0f}ms", flush=True)
    ckpt.save(args.steps - 1, state(), extras={"cursor": pipeline.cursor.as_dict()})
    print("done; checkpoint saved")


if __name__ == "__main__":
    main()
