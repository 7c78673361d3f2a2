"""Continuous-batching serving on the PyTorch port (port of
``examples/serve_continuous.py``): continuous batching through the ACS
window (DESIGN §4, §10). Requests arrive over time; each owns a KV-cache
slot; the ACS dependency window co-schedules new prefills with the
in-flight decode (disjoint slots => independent), while each request's own
prefill -> decode chain stays serialized by its RAW hazards.

Runs both servers on the same staggered arrivals: the live SessionServer
(admission emits prefills into the open window while the previous decode
group is still in flight) and the per-step batch-drain baseline. On the
card every prefill runs flash attention's forward kernel.

    PYTHONPATH=src python examples/torch_serve_continuous.py [--device cuda|cpu]
"""

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.runtime import ContinuousBatchingServer, SessionServer  # noqa: E402


ARRIVALS = {0: 2, 2: 1, 4: 2, 6: 1}  # iteration -> new requests


def _requests(submitted):
    return [{"rid": r.rid, "prompt": r.prompt, "tokens": list(r.generated)} for r in submitted]


def run_batch(cfg, params, rng, device="cuda"):
    server = ContinuousBatchingServer(cfg, params, max_slots=3, max_len=48, device=device)
    submitted, finished = [], []
    for it in range(40):
        for _ in range(ARRIVALS.get(it, 0)):
            req = server.submit(rng.randint(0, cfg.vocab, rng.randint(4, 9)),
                                max_new=6)
            submitted.append(req)
            print(f"[batch iter {it}] submitted request {req.rid}")
        for r in server.step():
            finished.append(r.rid)
            print(f"[batch iter {it}] finished request {r.rid}: tokens {r.generated}")
        if not server.queue and not server.active and it > 8:
            break
    waves = server.report_log
    multi = sum(1 for e in waves if e.get("tasks_this_run", 0) > 1
                and e.get("waves_this_run", 0) < e.get("tasks_this_run", 0))
    print(f"batch: served {len(finished)} requests in {len(waves)} drains; "
          f"{multi} drains co-scheduled independent work in one wave\n")
    return {"requests": _requests(submitted), "finished": finished, "drains": len(waves),
            "co_scheduled": multi}


def run_session(cfg, params, rng, device="cuda"):
    server = SessionServer(cfg, params, max_slots=3, max_len=48,
                           scheduler="frontier", device=device)
    submitted, finished = [], []
    for it in range(120):
        for _ in range(ARRIVALS.get(it, 0)):
            req = server.submit(rng.randint(0, cfg.vocab, rng.randint(4, 9)),
                                max_new=6)
            submitted.append(req)
            print(f"[session pump {it}] submitted request {req.rid} "
                  f"(queue depth {req.queue_depth})")
        done = server.pump()
        for r in done:
            finished.append(r.rid)
            print(f"[session pump {it}] finished request {r.rid}: tokens {r.generated}")
        if not server.queue and not server.active and it > 8:
            break
        if not done:
            server.session.drive()  # block only when nothing retired this pump
    report = server.close()
    retired = dict(sorted(server.session.retired_by_tag.items()))
    print(f"session: served {len(finished)} requests; "
          f"{report.max_inflight_groups()} groups overlapped in flight; "
          f"retired by stream tag: {retired}")
    return {"requests": _requests(submitted), "finished": finished,
            "inflight": report.max_inflight_groups(), "retired_by_tag": retired}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(
        ARCHS["h2o-danube-3-4b"].reduced(),
        n_layers=2, d_model=64, d_ff=128, vocab=512,
    )
    params = init_params(cfg, 0, device=args.device, tp_size=1)
    return {"cfg": cfg, "params": params,
            "batch": run_batch(cfg, params, np.random.RandomState(0), args.device),
            "session": run_session(cfg, params, np.random.RandomState(0), args.device)}


if __name__ == "__main__":
    main()
