"""The readings a train cell's limits are set from, on the card, in one
process (set-up is paid once):

    python3 acsbench/calibrate.py --workload <name> --seeds 1,2,... \\
        --control-seeds 1,2,3 --out <file.jsonl>

For each seed: the program's first steps against the plain reference (the
lower readings). For each control seed besides: the control, the reference
computed with float8 products (``reference.model``'s ``precision="fp8"``),
against the reference; and the fault of half the batch left out, the mean
taken over the rest (the reference in the program's place, on the first
half of each batch's rows), against the reference. A step that returns its
state unchanged reads 1 on ``change_gap`` (and on ``grad_gap``) by the
comparison's measure and needs no run. Each reading is a JSON line in
``--out``; the last line on standard output sums them up per number: the
lower reading (the largest sound gap) and the smallest the control and
the fault read.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def readings(cell, control: bool, log=lambda m: None) -> list:
    """The readings of one seed: ``[(what, gaps against the reference, the
    readings themselves)]``, the reference's own first."""
    from acsbench import compare
    from acsbench.kinds.train import Program, reference_readings

    prog = Program(cell)
    got = prog.first_steps()
    spec, leaves, opt = prog.spec, prog.leaves, prog.opt
    first = prog.free()
    del prog

    def reference(batches, precision="fp32"):
        return reference_readings(spec, leaves, cell.seed, cell.device, batches, opt, precision)

    ref = reference(first)
    out = [("reference", None, ref), ("program", compare.gaps(got, ref), got)]
    log(f"seed {cell.seed}: program {out[-1][1]}")
    if control:
        fp8 = reference(first, "fp8")
        out.append(("control_fp8", compare.gaps(fp8, ref), fp8))
        log(f"seed {cell.seed}: control {out[-1][1]}")
        hb = reference([(i[: i.shape[0] // 2], t[: t.shape[0] // 2]) for i, t in first])
        out.append(("fault_half_batch", compare.gaps(hb, ref), hb))
        log(f"seed {cell.seed}: half batch {out[-1][1]}")
    return out


def summary(rows: list) -> dict:
    """Per number: the lower reading and the least the control and each
    fault read."""
    out = {}
    for what in sorted({r["what"] for r in rows if r["gaps"]}):
        got = [r for r in rows if r["what"] == what]
        pick = max if what == "program" else min
        keys = [k for k, v in got[0]["gaps"].items() if isinstance(v, float)]
        out[what] = {k: pick(r["gaps"][k] for r in got) for k in keys}
        out[what]["seeds"] = len(got)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import torch

    from acsbench import harness
    from acsbench.kinds.train import Cell

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    found = harness.find_cell(harness.load_benchmark(), args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    rows = []

    def log(msg):
        print(f"[calibrate {time.perf_counter() - T0:8.1f} s] {msg}", file=sys.stderr, flush=True)

    with open(out_path, "a") as f:
        for seed in seeds:
            cell = Cell(config=found["config"], traffic=found["traffic"], seed=seed, seconds=0,
                        trace=False, device=torch.device("cuda", 0), log=log)
            for what, gaps, raw in readings(cell, seed in control, log):
                row = {"workload": args.workload, "seed": seed, "what": what, "gaps": gaps,
                       "readings": raw}
                rows.append(row)
                f.write(json.dumps(row) + "\n")
                f.flush()
    print(json.dumps({"workload": args.workload, "summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
