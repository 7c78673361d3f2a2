"""End-to-end training on the PyTorch port (port of
``examples/train_lm.py``): train a ~30M-parameter member of the minicpm
family with the full substrate — resumable data pipeline, AdamW + cosine
schedule, atomic checkpoints, straggler watchdog. Interrupt it and re-run:
it resumes from the last checkpoint with an identical loss trajectory.

    PYTHONPATH=src python examples/torch_train_lm.py [steps] [--device cuda|cpu] [--ckpt DIR]
"""

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("steps", type=int, nargs="?", default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default="results/ckpt_torch_train_lm")
    args = ap.parse_args(argv)

    # a small member of the minicpm (llama-like) family
    cfg = dataclasses.replace(
        ARCHS["minicpm-2b"],
        name="minicpm-100m",
        n_layers=8,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        head_dim=64,
        d_ff=1536,
        vocab=8192,
        dtype="float32",
    )
    print(f"arch={cfg.name} params={cfg.n_params / 1e6:.1f}M device={args.device}")

    tcfg = TrainerConfig(seq_len=128, batch=8, lr=3e-4, warmup=20,
                         total_steps=args.steps, checkpoint_every=50)
    trainer = Trainer(cfg, tcfg, Path(args.ckpt), device=args.device)
    if trainer.start_step:
        print(f"resumed from checkpoint at step {trainer.start_step}")
    metrics = trainer.run()
    for m in metrics[:: max(len(metrics) // 10, 1)]:
        print(f"step {m['step']:4d} loss {m['loss']:.4f} "
              f"gnorm {m['gnorm']:.2f} {m['dt'] * 1e3:.0f}ms")
    print(f"final loss {metrics[-1]['loss']:.4f} "
          f"(start {metrics[0]['loss']:.4f}); "
          f"stragglers observed: {trainer.straggler_steps}")


if __name__ == "__main__":
    main()
