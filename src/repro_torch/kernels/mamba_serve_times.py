"""Falcon-mamba-7b's serving path on the card (or another served arch's),
for comparing two trees.

    python -m repro_torch.kernels.mamba_serve_times <label>     # PYTHONPATH=src
    python -m repro_torch.kernels.mamba_serve_times <label> granite-moe-3b-a800m gmm_tc_kernel

Run from the root of a tree: it takes that tree's ``chip_smoke.py`` for
the prompts, the greedy loop and the server runs, so the same file copied
into a parent tree unpacked under ``.archive/`` times the parent; run
parent, change, change, parent in one call to compare on one host.

On falcon-mamba-7b whole (64 Mamba layers, bf16 weights from seed 0), or
the arch named second, over chip_smoke's 8 seeded prompts (128-512
tokens, 16 new tokens each):

* the CUDA kernels one greedy decode step launches (``torch.profiler``,
  memory copies and sets left out; the step after a 200-token prefill),
  with the name, count and mean device time in that step of the kernel
  whose name holds the third argument (the selective scan's,
  ``scan_kernel``, by default);
* the greedy loop's median prefill and decode step (host clock, each
  ending in the token's host read), over the 8 prompts;
* the wall of each of the four servers over the 8 requests
  (``SessionServer`` wave, device and frontier, ``ContinuousBatchingServer``),
  and whether their tokens equal the greedy loop's.

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys


def main(label: str, arch: str = "falcon-mamba-7b", kernel: str = "scan_kernel") -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from repro_torch.configs import ARCHS
    from repro_torch.models import decode_step, init_cache, init_params, prefill
    from repro_torch.runtime import ContinuousBatchingServer, SessionServer

    if not torch.cuda.is_available():
        print("mamba_serve_times: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cfg = ARCHS[arch]
    params = init_params(cfg, cs.SERVE_SEED, device=device)
    prompts = cs.serve_prompts(cfg.vocab)

    # The kernels of one decode step, after a warm one.
    cache = init_cache(cfg, 1, cs.SERVE_MAX_LEN, device=device)
    tok = torch.as_tensor(prompts[0][None, :200], device=device)
    _, cache = prefill(params, cfg, tok, cache)
    step_tok = tok[:, -1:]
    _, cache = decode_step(params, cfg, step_tok, cache,
                           torch.full((), 200, dtype=torch.int32, device=device))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        decode_step(params, cfg, step_tok, cache,
                    torch.full((), 201, dtype=torch.int32, device=device))
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    scan = [e for e in kernels if kernel in e.name]
    del cache

    greedy, prefill_s, decode_s = [], [], []
    for p in prompts:
        toks, t_pre, t_dec, finite = cs.greedy(cfg, params, p, device)
        greedy.append(toks)
        prefill_s.append(t_pre)
        decode_s.extend(t_dec)
        if not finite:
            raise RuntimeError("mamba_serve_times: non-finite logits")
    walls, same = {}, True
    for name, cls, kw in (("SessionServer(wave)", SessionServer, {"scheduler": "wave"}),
                          ("SessionServer(device)", SessionServer, {"scheduler": "device"}),
                          ("SessionServer(frontier)", SessionServer, {"scheduler": "frontier"}),
                          ("ContinuousBatchingServer", ContinuousBatchingServer, {})):
        toks, wall, _, _ = cs.serve_once(cfg, params, cls, prompts, device, **kw)
        walls[name] = wall * 1e3
        same = same and toks == greedy
    result = {
        "label": label, "card": card, "arch": arch,
        "decode_step_cuda_kernels": len(kernels),
        "decode_step_scan_kernels": len(scan),
        "scan_kernel": scan[0].name[:80] if scan else None,
        "scan_kernel_device_us": (statistics.mean(e.time_range.elapsed_us() for e in scan)
                                  if scan else None),
        "decode_step_ms": statistics.median(decode_s) * 1e3,
        "prefill_ms": statistics.median(prefill_s) * 1e3,
        "server_wall_ms": walls,
        "servers_equal_greedy": same,
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*(sys.argv[1:] or ["tree"])))
