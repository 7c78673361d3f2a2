"""End-to-end deep-RL data generation through ACS on the PyTorch port (port
of ``examples/physics_rl.py``, the paper's headline workload): run
Brax-style physics environments with a linear policy, collecting a batch
of (obs, action, reward-proxy) trajectories, the simulation stream
scheduled by the ACS window, as in §VI-A.

    PYTHONPATH=src python examples/torch_physics_rl.py [env] [steps] [scheduler] [--device cuda|cpu]

``scheduler`` is one of ``repro_torch.core.SCHEDULER_NAMES`` (serial |
wave | threaded | frontier | device; default wave). ``device`` is the
ACS-HW analogue: the whole step's stream planned as ONE device-window
epoch. Neither device kernel takes a physics stream: the engine's branch
table for the ready-queue kernel is empty on purpose
(``repro_torch/sim/engine.py``, ``SWITCH_BRANCHES``), because every sim
kernel changes its row geometry or spans several shape classes, and the
wave kernel refuses such a stream for the same reason. So the epoch runs
on the host: its plan's steps in plan mode ``wave`` (the default), the
ready-queue interpreter in plan mode ``loop``. Each RL step emits a
fresh, input-dependent kernel graph: the frontier scheduler's home turf.
A scheduler's dispatches count from its first step on, as in the
reference, whose wave scheduler runs a wave as one compiled program; the
port's runs a wave as one call per signature group, and each step's row
also holds its waves.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.core import TaskStream, make_scheduler  # noqa: E402
from repro_torch.sim import PhysicsEngine, make_env  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("env", nargs="?", default="cheetah")
    ap.add_argument("steps", type=int, nargs="?", default=5)
    ap.add_argument("scheduler", nargs="?", default="wave")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        run = make_scheduler(args.scheduler, device=args.device)
    except ValueError as exc:  # an unknown name: make_scheduler lists SCHEDULER_NAMES
        raise SystemExit(str(exc))

    eng = PhysicsEngine(make_env(args.env), n_envs=16, group_size=4, seed=0, device=args.device)
    rng = np.random.RandomState(0)

    obs_dim = eng.spec.n_bodies * 6
    w_policy = rng.randn(obs_dim, eng.spec.n_joints).astype(np.float32) * 0.1

    def policy(obs):  # linear policy over engine observations
        return np.tanh(obs @ w_policy)

    steps = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        stream = TaskStream()
        eng.emit_step(stream, policy=policy)
        report = run(stream.tasks)
        snap = eng.state_snapshot()
        reward = float(-np.linalg.norm(snap[..., :3], axis=-1).mean())  # stay near origin
        stats = report.exec_stats
        row = {"kernels": len(stream.tasks), "dispatches": stats["dispatches"],
               "waves": len(report.waves), "wave_width": report.mean_wave_width,
               "reward": reward}
        extra = ""
        if report.groups:  # frontier: show the async profile
            row.update(syncs=stats["blocking_syncs"], inflight=report.max_inflight_groups())
            extra = f" syncs={row['syncs']} inflight={row['inflight']}"
        print(f"step {step}: kernels={row['kernels']} dispatches={row['dispatches']} "
              f"wave_width={row['wave_width']:.1f} reward={reward:.3f}{extra}")
        steps.append(row)
    wall = time.perf_counter() - t0
    state = eng.state_snapshot()
    finite = bool(np.all(np.isfinite(state)))
    print(f"\n{args.env} [{args.scheduler}]: {args.steps} steps, {wall:.2f}s wall, "
          f"states finite: {finite}")
    return {"env": args.env, "scheduler": args.scheduler, "steps": steps, "wall": wall,
            "finite": finite, "state": state}


if __name__ == "__main__":
    main()
