"""Dynamic-DNN inference through ACS on the PyTorch port (port of
``examples/dynamic_dnn_inference.py``, paper §VI-B): classify a stream of
images with an InstaNAS-like instance-aware CNN whose architecture, and
therefore kernel stream, changes per image. The per-input graphs defeat
ahead-of-time DAG frameworks; ACS schedules each one at runtime.

    PYTHONPATH=src python examples/torch_dynamic_dnn_inference.py [n_images] [--device cuda|cpu]

The reference runs each wave as one compiled program and counts their
compiles (a signature cache absorbs the per-input graph variation). Eager
PyTorch compiles nothing (the executor's ``compiles`` stays 0) and runs a
wave as one call per signature group, a convolution's or contraction's
group one call a task, so an image's dispatches here are the port's and
its row also holds its waves.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.core import TaskStream, WaveScheduler  # noqa: E402
from repro_torch.dyn import WORKLOADS  # noqa: E402
from repro_torch.dyn.instanas import controller  # noqa: E402


def classify(params, n_images, device):
    """``n_images`` seeded images through InstaNAS with ``params`` (the
    port's ``DynParams``) on one ``WaveScheduler(window_size=32)``. Returns
    one row an image and the executor's compile count."""
    sched = WaveScheduler(window_size=32, device=device)
    rng = np.random.RandomState(0)
    _, build_fn, _ = WORKLOADS["instanas"]

    rows, prev_dispatches = [], 0
    for i in range(n_images):
        x = rng.randn(1, 3, 32, 32).astype(np.float32) * (1 + 0.5 * i)
        active = sum(sum(m) for m in controller(x))
        stream = TaskStream()
        out = build_fn(params, stream, x)
        t0 = time.perf_counter()
        report = sched.run(stream.tasks)
        dt = (time.perf_counter() - t0) * 1e3
        dispatches = report.exec_stats["dispatches"] - prev_dispatches
        prev_dispatches = report.exec_stats["dispatches"]
        logits = out.value.detach().cpu().numpy().reshape(-1)
        pred = int(np.argmax(logits))
        print(f"image {i}: {active:2d} blocks active, "
              f"{len(stream.tasks):3d} kernels -> "
              f"{dispatches:3d} dispatches, "
              f"class={pred}, {dt:.0f}ms")
        rows.append({"active": active, "kernels": len(stream.tasks), "dispatches": dispatches,
                     "waves": len(report.waves), "class": pred, "logits": logits})

    compiles = sched.executor.stats.compiles
    print(f"\nwave-program compiles across all inputs: {compiles} "
          f"(eager PyTorch: no signature cache to fill)")
    return {"images": rows, "compiles": compiles}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("n_images", type=int, nargs="?", default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    init_fn, _, _ = WORKLOADS["instanas"]
    return classify(init_fn(seed=0, device=args.device), args.n_images, args.device)


if __name__ == "__main__":
    main()
