"""Quickstart on the PyTorch port (port of ``examples/quickstart.py``):
ACS in 60 seconds.

Build an irregular, input-dependent task stream (a tiny physics step),
run it serially (the single-stream baseline) and through the ACS window,
and watch its kernels run in a handful of waves while results stay
identical: in the port bit-equal to the serial run, on the CPU and on the
card.
The reference runs each wave as one compiled program (one dispatch a
wave); eager PyTorch runs a wave as one call per signature group, so the
port prints its waves beside its dispatches.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda|cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.core import TaskStream, WaveScheduler, run_serial  # noqa: E402
from repro_torch.sim import PhysicsEngine, make_env  # noqa: E402


def build(seed, device):
    eng = PhysicsEngine(make_env("ant"), n_envs=16, group_size=4, seed=seed, device=device)
    stream = TaskStream()
    eng.emit_step(stream)
    return eng, stream


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. serial baseline: one dispatch per kernel, program order
    eng_a, stream_a = build(7, args.device)
    serial = run_serial(stream_a.tasks, device=args.device)

    # 2. ACS: windowed out-of-order scheduling -> fused waves
    eng_b, stream_b = build(7, args.device)
    acs = WaveScheduler(window_size=32, device=args.device).run(stream_b.tasks)

    a, b = eng_a.state_snapshot(), eng_b.state_snapshot()
    identical = bool(np.array_equal(a, b))
    if not identical:
        raise AssertionError(f"ACS states differ from serial by {np.abs(a - b).max()}")
    out = {
        "kernels": len(stream_a.tasks),
        "serial_dispatches": serial.exec_stats["dispatches"],
        "acs_dispatches": acs.exec_stats["dispatches"],
        "acs_waves": len(acs.waves),
        "mean_wave_width": acs.mean_wave_width,
        "max_wave_width": acs.exec_stats["max_wave_width"],
        "identical": identical,
        "serial_state": a,
        "acs_state": b,
    }
    print(f"kernels launched      : {out['kernels']}")
    print(f"serial dispatches     : {out['serial_dispatches']}")
    print(f"ACS dispatches        : {out['acs_dispatches']}")
    print(f"ACS waves             : {out['acs_waves']}")
    print(f"ACS mean wave width   : {out['mean_wave_width']:.1f}")
    print(f"max wave width        : {out['max_wave_width']}")
    print(f"results identical     : {identical}")
    return out


if __name__ == "__main__":
    main()
