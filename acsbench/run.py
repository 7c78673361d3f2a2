"""Run one cell of the port's benchmark once, on the card this process
sees, and print its result as the last line of standard output:

    python3 acsbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (the benchmark's spans around the step's calls, CUDA
events, and a few steps under ``torch.profiler``). Both check that what the
timed path produced is correct against the plain reference and print each
number compared beside its limit, last on standard error and last in the
result. With no card, too few cards, a checkout without the program, or
JAX loaded in this process, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Importable from the checkout's root; the program from src/. The script's
# own folder is not put first, so that its modules shadow nothing.
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

# Build and kernel caches at fixed paths inside the checkout.
CACHE = ROOT / "acsbench" / "cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
os.environ["USE_FLAX"] = "0"
# One process loads the card; its host threads are the step's (the caller
# and autograd's): no CPU thread pool beside them.
os.environ.setdefault("OMP_NUM_THREADS", "1")

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(f"[acsbench {time.perf_counter() - T0:8.2f} s] {msg}", file=sys.stderr, flush=True)


def loaded_forbidden() -> list:
    """Modules of JAX or of the JAX package in this process, by whole
    top-level name."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "unknown"
    out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    args = ap.parse_args(argv)

    from acsbench import harness

    bench = harness.load_benchmark()
    found = harness.find_cell(bench, args.workload)
    cell = found["cell"]
    try:
        import repro_torch  # noqa: F401  the program under test
    except ImportError as exc:
        log(f"the program is not in this checkout: {exc}")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"this host has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = power_limit()  # the card's name and power limit
    log(f"{args.workload} seed {args.seed} trace {args.trace} on {card}; "
        f"torch {torch.__version__} CUDA {torch.version.cuda}")

    driver = harness.module("kinds", found["traffic"]["kind"])
    built = sorted((ROOT / "src" / "repro_torch" / "kernels" / "_build").glob("*.so"))
    result = driver.run(driver.Cell(config=found["config"], traffic=found["traffic"],
                                    seed=args.seed, seconds=args.seconds,
                                    trace=bool(args.trace), device=device, log=log))
    setup_s = result.setup_end - T0
    now_built = sorted((ROOT / "src" / "repro_torch" / "kernels" / "_build").glob("*.so"))
    log(f"set-up {setup_s:.3f} s (kernel libraries built in this run: "
        f"{len(set(now_built) - set(built))})")

    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": cell["chips"], "memory_peak_bytes": result.memory_peak_bytes,
                   "power": card}
    out = harness.report(bench, args.workload, result, bool(args.trace), setup_s,
                         device_info, log)
    bad = loaded_forbidden()
    if bad:
        log(f"refusing to report: {bad} loaded in this process")
        return 4
    for line in harness.compared_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
