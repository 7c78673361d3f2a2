"""The selective-scan kernel beside variants of its own source, on the card.

    python -m repro_torch.kernels.scan_variants      # PYTHONPATH=src, ~1 min

Builds ``csrc/selective_scan.cu`` as it is and two variants of it, each
from a copy with a few lines changed (as ``tile_sweep.py`` builds its tile
variants), and times them in turns in one process:

* ``kernel``: the source as committed (the state loop's decay is
  ``ex2.approx`` of ``dt * (a * log2 e)``);
* ``expf``: the state loop's decay through the CUDA math library's
  ``expf(dt * a)``, torch's exp;
* ``no_state_loop``: the loop over the N states taken out (wrong results:
  the staging, prologue, epilogue and stores alone).

For each: the scan alone in float32 and the fused bf16 entry at
falcon-mamba-7b's prefill ``[1, 512, 8192]``, N 16, the fused entry at
``[1, 128, 8192]`` and at a decode step, each as the device time of one
launch (``torch.profiler``, the mean over 20); whether the scan alone and
the fused entry stay within ``chip_smoke.SCAN_TOL`` of their plain versions
over ``chip_smoke.SCAN_SWEEP`` and ``FUSED_SWEEP`` (worst share of the
tolerance); and the SASS instructions a state and step of both entries'
prefill instance. Prints the card's name and power limit, then one JSON
line. Run from the root of the checkout (it takes ``chip_smoke.py``'s
inputs, sweeps and timers).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

# (old, new) lines of csrc/selective_scan.cu for each variant.
VARIANTS = {
    "kernel": (),
    "expf": (("          s_a[i] = __fmul_rn(a, kLog2e);", "          s_a[i] = a;"),
             ("          da[q][i] = exp2_approx(__fmul_rn(dtv[i], an));",
              "          da[q][i] = expf(__fmul_rn(dtv[i], an));")),
    "no_state_loop": (("    for (; nn + 1 < n; nn += 2) states(std::integral_constant<int, 2>{}, nn);",
                       "    for (; nn + 1 < 0; nn += 2) states(std::integral_constant<int, 2>{}, nn);"),
                      ("    if (nn < n) states(std::integral_constant<int, 1>{}, nn);", "")),
}
# The prefill instances (4 steps a lane, 16 lanes a channel) of both entries.
SASS = {"scan_float32": "mamba_scan_kernelIfLb0ELi4ELi4E",
        "fused_bf16": "mamba_scan_kernelI13__nv_bfloat16Lb1ELi4ELi4E"}


def build_variants():
    """{name: built library path}, each variant's source written beside
    the committed one (so it finds the shared headers) and removed after."""
    from . import _nvcc
    from . import selective_scan as ss

    src = ss.SOURCE.read_text()
    paths = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise ValueError(f"scan_variants: {name}: line not in the source: {old!r}")
            text = text.replace(old, new)
        paths[name] = ss.SOURCE.parent / f"_variant_{name}.cu"
        paths[name].write_text(text)
    try:
        with ThreadPoolExecutor(len(paths)) as pool:
            built = dict(zip(paths, pool.map(lambda p: _nvcc.build(p)[0], paths.values())))
    finally:
        for path in paths.values():
            path.unlink()
    return built


def main() -> int:
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from . import selective_scan as ss
    from .ref import mamba_scan_ref, selective_scan_ref

    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    built = build_variants()
    entries = {}
    for name, path in built.items():
        lib = ctypes.CDLL(str(path))
        ss._bind(lib)
        entries[name] = lib.acs_mamba_scan
    gen = torch.Generator(device=device)
    gen.manual_seed(9)
    cases = {"scan_512_f32": (ss.selective_scan, cs.scan_inputs(gen, 1, 512, 8192, 16, device)),
             "fused_512_bf16": (ss.mamba_scan, cs.fused_inputs(gen, 1, 512, 8192, 16,
                                                               torch.bfloat16, device)),
             "fused_128_bf16": (ss.mamba_scan, cs.fused_inputs(gen, 1, 128, 8192, 16,
                                                               torch.bfloat16, device)),
             "fused_decode_bf16": (ss.mamba_scan, cs.fused_inputs(gen, 1, 1, 8192, 16,
                                                                  torch.bfloat16, device))}
    result = {"card": card}
    for name, entry in entries.items():
        ss._ENTRY = entry
        out = {}
        if name != "no_state_loop":
            worst = 0.0
            for b, s, e, n in cs.SCAN_SWEEP:
                args = cs.scan_inputs(gen, b, s, e, n, device)
                for g, w in zip(ss.selective_scan(*args), selective_scan_ref(*args)):
                    ok, _, share = cs.within_scan_tol(g, w)
                    worst = max(worst, share if ok else float("inf"))
            for dtype in (torch.float32, torch.bfloat16):
                for b, s, e, n in cs.FUSED_SWEEP:
                    args = cs.fused_inputs(gen, b, s, e, n, dtype, device)
                    for g, w in zip(ss.mamba_scan(*args),
                                    mamba_scan_ref(*args, out_dtype=torch.float32)):
                        ok, _, share = cs.within_scan_tol(g, w)
                        worst = max(worst, (share or 0.0) if ok else float("inf"))
            out["worst_share_of_scan_tol"] = worst
            out["sass_a_state_and_step"] = {
                k: ss.sass_per_step(built[name], v)["instructions_a_state_and_step"]
                for k, v in SASS.items()}
        result[name] = out
    for _ in range(2):  # kernel, expf, no_state_loop; twice
        for name, entry in entries.items():
            ss._ENTRY = entry
            for case, (fn, args) in cases.items():
                ms = cs.kernel_device_ms(lambda: fn(*args), "mamba_scan_kernel")[0]
                result[name].setdefault(f"{case}_device_ms", []).append(ms)
    ss._ENTRY = None
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
