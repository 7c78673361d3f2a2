"""Time the backward kernels that train deepseek-v2 and falcon-mamba-7b on
the card, at their training shapes, through entry points that every
version of the port with these backwards has, so that two trees can be
compared in one run on the card:

    PYTHONPATH=src python -m repro_torch.kernels.bwd_times [label]

* flash attention's backward (``flash_attention_bwd`` on the forward
  kernel's o and lse, bf16, causal) at deepseek-v2's MLA ``[4, 128, 512,
  192]`` with v ``[4, 128, 512, 128]``, minicpm-2b's ``[4, 36, 512, 64]``
  and recurrentgemma-2b's ``[4, 10, 512, 256]`` over one kv head (window
  2048): device time per call (``torch.profiler``, each kernel's mean over
  the launches the trace holds, summed over the call's kernels) with each
  pass's share, 20 calls back to back (per call, median of 5 rounds),
  single calls (CUDA-event median of 20), and cuDNN's backward through
  ``F.scaled_dot_product_attention`` back to back on the same inputs, the
  yardstick;
* the selective scan's backward (``mamba_scan_bwd``, the fused entry as
  the train step calls it: z, b and c strided views, h0 zeros, no hT
  gradient) at falcon-mamba-7b's ``[4, 512, 8192]``, N 16, bf16: device
  time (the kernel and its reduction, and the reduction alone), back to
  back, single, and the forward's device time with and without its chunk
  states.

Prints one JSON object: the label, the card's name and power limit, and
the times in ms. To time another tree, copy this file into its
``src/repro_torch/kernels/`` and run it there (parent, change, change,
parent in one run). Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import importlib
import json
import statistics
import subprocess
import sys

import torch

fa = importlib.import_module("repro_torch.kernels.flash_attention")
ss = importlib.import_module("repro_torch.kernels.selective_scan")

RUNS = 20
# (key, (B, H, Hkv, S, D, Dv), masks)
FLASH_SHAPES = [("mla", (4, 128, 128, 512, 192, 128), {}),
                ("d64", (4, 36, 36, 512, 64, 64), {}),
                ("d256", (4, 10, 1, 512, 256, 256), {"window": 2048})]
SCAN_SHAPE = (4, 512, 8192, 16)


def single_ms(fn, runs=RUNS, warmup=3):
    """CUDA-event median of ``runs`` single calls, each waited for."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def b2b_ms(fn, calls=20, rounds=5):
    """Median over ``rounds`` of the CUDA-event time of ``calls`` calls in
    a row, per call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_ms(fn, parts, runs=RUNS):
    """Per call of ``fn``: {part: mean device ms of the kernels whose name
    holds ``parts[part]``, over the launches the trace holds} (None for a
    part none of whose kernels ran)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = {}
    for part, name in parts.items():
        hits = [a for a in prof.key_averages() if name in a.key]
        count = sum(a.count for a in hits)
        out[part] = (sum(a.self_device_time_total for a in hits) / 1e3 / count
                     if count else None)
    return out


def flash_times(gen, shape, flags):
    import torch.nn.functional as F

    b, h, hkv, s, d, dv = shape
    dev = torch.device("cuda")
    q = torch.randn(b, h, s, d, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(b, hkv, s, dv, generator=gen, device=dev).to(torch.bfloat16)
    do = torch.randn(b, h, s, dv, generator=gen, device=dev).to(torch.bfloat16)
    out, lse = fa.flash_attention_lse(q, k, v, **flags)
    call = lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, **flags)  # noqa: E731
    parts = device_ms(call, {"prologue": "flash_bwd_dot", "dkdv": "flash_bwd_dkdv",
                             "reduce": "flash_bwd_reduce", "dq": "flash_bwd_dq"})
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=hkv != h)
    sdpa = lambda: torch.autograd.grad(o_sdpa, (qs, ks, vs), do, retain_graph=True)  # noqa: E731
    return {"device_ms": sum(v for v in parts.values() if v is not None),
            **{f"device_ms_{k}": v for k, v in parts.items()},
            "b2b_ms": b2b_ms(call), "single_ms": single_ms(call),
            "cudnn_b2b_ms": b2b_ms(sdpa)}


def scan_times(gen):
    b, s, e, n = SCAN_SHAPE
    dev = torch.device("cuda")
    rank = 256
    xz = torch.randn(b, s, 2 * e, generator=gen, device=dev).to(torch.bfloat16)
    proj = torch.randn(b, s, rank + 2 * n, generator=gen, device=dev).to(torch.bfloat16)
    dt_raw = torch.randn(b, s, e, generator=gen, device=dev).to(torch.bfloat16)
    dt_bias = 0.5 * torch.randn(e, generator=gen, device=dev)
    a_log = (torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev))[None]
             + 0.1 * torch.randn(e, n, generator=gen, device=dev)).contiguous()
    args = (dt_raw, dt_bias, xz[..., :e], xz[..., e:], proj[..., rank: rank + n],
            proj[..., rank + n:], a_log, torch.randn(e, generator=gen, device=dev),
            torch.zeros(b, e, n, device=dev))
    _, _, states = ss.mamba_scan_fwd(*args)
    dy = torch.randn(b, s, e, generator=gen, device=dev).to(torch.bfloat16)
    call = lambda: ss.mamba_scan_bwd(*args, states, dy, None)  # noqa: E731
    parts = device_ms(call, {"kernel": "mamba_scan_bwd_kernel",
                             "reduce": "mamba_scan_bwd_reduce_kernel"})
    fwd = device_ms(lambda: ss.mamba_scan_fwd(*args), {"k": "mamba_scan_kernel"})["k"]
    fwd_plain = device_ms(lambda: ss.mamba_scan(*args), {"k": "mamba_scan_kernel"})["k"]
    return {"device_ms": parts["kernel"] + parts["reduce"], "device_ms_reduce": parts["reduce"],
            "b2b_ms": b2b_ms(call), "single_ms": single_ms(call),
            "forward_with_states_device_ms": fwd, "forward_device_ms": fwd_plain}


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("bwd_times: needs a CUDA device")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(27)
    out = {"label": argv[0] if argv else "", "card": card()}
    for key, shape, flags in FLASH_SHAPES:
        out[f"flash_{key}"] = flash_times(gen, shape, flags)
    out["scan"] = scan_times(gen)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
