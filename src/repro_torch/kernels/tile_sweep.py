"""Time tile-shape variants of the port's two tiled tensor-core kernels on
the card: the grouped GEMM (``csrc/grouped_matmul.cu``) and flash
attention (``csrc/flash_attention.cu``).

    python -m repro_torch.kernels.tile_sweep

Each variant is a copy of the kernel's source with one launch shape or
tile constant replaced, built as the kernel is (``_nvcc.build``, into
``_build/variants/``, all builds started together), checked against the
plain version at each shape and timed 20 launches back to back (median of
7), beside ``torch.bmm`` for the grouped GEMM; a variant the card refuses
to launch (too much shared memory) is reported as refused (``null`` in
the JSON). The shapes are the serving paths': granite-moe-3b-a800m's
expert products at decode (``block_m`` 1) and prefill (``block_m`` 128
and 40), and the prefills of recurrentgemma-2b (D 256), granite (D 64)
and h2o-danube-3-4b (D 120). The first variant of each kernel is the
source as committed. Prints one line per shape and, last, one JSON object
with every time. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

from ._nvcc import BUILD_DIR, build, resources

fa = importlib.import_module(".flash_attention", __package__)
gm = importlib.import_module(".grouped_matmul", __package__)

# The grouped GEMM's three launch shapes <T, BM, BN, BK, WM, WN, STAGES>.
_DECODE = "launch_tc<T, 16, 64, 64, 1, 4, 4>"
_PREFILL = "launch_tc<T, 128, 128, 32, 2, 4, 4>"
GMM_VARIANTS: Dict[str, Dict[str, str]] = {
    "as_committed": {},
    "decode_6_stages": {_DECODE: "launch_tc<T, 16, 64, 64, 1, 4, 6>"},
    "decode_bn128": {_DECODE: "launch_tc<T, 16, 128, 64, 1, 4, 4>"},
    "decode_bk128": {_DECODE: "launch_tc<T, 16, 64, 128, 1, 4, 4>"},
    "decode_bn128_8_warps": {_DECODE: "launch_tc<T, 16, 128, 64, 1, 8, 4>"},
    "prefill_3_stages": {_PREFILL: "launch_tc<T, 128, 128, 32, 2, 4, 3>"},
    "prefill_bk64_3_stages": {_PREFILL: "launch_tc<T, 128, 128, 64, 2, 4, 3>"},
    "prefill_bn64": {_PREFILL: "launch_tc<T, 128, 64, 32, 4, 2, 4>"},
    "prefill_bm64": {_PREFILL: "launch_tc<T, 64, 128, 32, 2, 4, 4>"},
    "prefill_4_warps": {_PREFILL: "launch_tc<T, 128, 128, 32, 2, 2, 4>"},
}
FLASH_VARIANTS: Dict[str, Dict[str, str]] = {
    "as_committed": {},
    "keys_32": {"constexpr int kTcKeys = 64;": "constexpr int kTcKeys = 32;"},
    "keys_128": {"constexpr int kTcKeys = 64;": "constexpr int kTcKeys = 128;"},
    "rows_32": {"constexpr int kTcWarps = 4;": "constexpr int kTcWarps = 2;"},
    "rows_128": {"constexpr int kTcWarps = 4;": "constexpr int kTcWarps = 8;"},
}
# label -> (G, K, N, block_m); label -> (H, Hkv, S, D, window)
GMM_SHAPES = {"decode_gate": (48, 1536, 512, 1), "decode_down": (48, 512, 1536, 1),
              "prefill_gate": (48, 1536, 512, 128), "prefill_down": (48, 512, 1536, 128),
              "prefill_c40": (48, 1536, 512, 40)}
FLASH_SHAPES = {"recurrentgemma": (10, 1, 512, 256, 2048), "granite": (24, 8, 512, 64, None),
                "danube": (32, 8, 512, 120, 4096)}


def _variant_sources(mod, variants: Dict[str, Dict[str, str]]) -> List[Tuple[str, object]]:
    out_dir = BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in mod.SOURCE.parent.glob("*.cuh"):
        (out_dir / header.name).write_text(header.read_text())
    text = mod.SOURCE.read_text()
    sources = []
    for name, subs in variants.items():
        src = text
        for old, new in subs.items():
            if old not in src:
                raise ValueError(f"tile_sweep: {name}: {old!r} not in {mod.SOURCE.name}")
            src = src.replace(old, new)
        path = out_dir / f"{mod.SOURCE.stem}_{name}.cu"
        path.write_text(src)
        sources.append((name, path))
    return sources


def back_to_back_ms(fn: Callable[[], object], launches: int = 20, runs: int = 7) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def _checked_time(call: Callable[[], int], out, want, tol: float,
                  what: str) -> Optional[float]:
    """Back-to-back ms of one variant's launch, after checking it against
    the plain version on an output first filled with NaN; None when the
    card refuses the launch."""
    import torch

    out.fill_(float("nan"))
    rc = call()
    torch.cuda.synchronize()
    if rc != 0:
        return None
    if not bool(((out.float() - want).abs() <= tol * (1 + want.abs())).all()):
        raise RuntimeError(f"tile_sweep: {what} != plain")
    return back_to_back_ms(call)


def _ms(ms: Optional[float]) -> str:
    return "refused" if ms is None else f"{ms:.5f}"


def main() -> int:
    import torch

    from .ref import attention_ref, grouped_matmul_ref

    if not torch.cuda.is_available():
        print("tile_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    jobs = [(gm, name, path) for name, path in _variant_sources(gm, GMM_VARIANTS)]
    jobs += [(fa, name, path) for name, path in _variant_sources(fa, FLASH_VARIANTS)]
    with ThreadPoolExecutor(8) as pool:
        built = list(pool.map(lambda j: build(j[2], j[0]._LIB.flags), jobs))
    libs = {}
    for (mod, name, _), (path, secs) in zip(jobs, built):
        lib = ctypes.CDLL(str(path))
        mod._bind(lib)
        libs[(mod.__name__, name)] = lib
        regs = "; ".join(line for line in resources(path) if "bfloat16" in line)
        print(f"build {mod.SOURCE.stem} {name} {secs:.1f} s: {regs}", flush=True)

    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    result = {"device": torch.cuda.get_device_name(0), "grouped_matmul": {}, "flash": {}}
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    for label, (g, k, n, cap) in GMM_SHAPES.items():
        w = torch.randn(g, k, n, generator=gen, device=dev).to(torch.bfloat16)
        x = torch.randn(g * cap, k, generator=gen, device=dev).to(torch.bfloat16)
        tiles = torch.arange(g, dtype=torch.int32, device=dev)
        out = torch.empty(g * cap, n, dtype=torch.bfloat16, device=dev)
        want = grouped_matmul_ref(x, w, tiles, block_m=cap).float()
        x3 = x.view(g, cap, k)
        row = {"torch.bmm": back_to_back_ms(lambda: torch.bmm(x3, w))}
        for name in GMM_VARIANTS:
            f = libs[(gm.__name__, name)].acs_grouped_matmul
            call = lambda: f(x.data_ptr(), w.data_ptr(), tiles.data_ptr(),  # noqa: E731
                             out.data_ptr(), err.data_ptr(), g * cap, k, n, g, cap, 1, stream)
            row[name] = _checked_time(call, out, want, 8e-3, f"grouped GEMM {name} at {label}")
        result["grouped_matmul"][label] = row
        print(f"grouped_matmul {label} G {g} K {k} N {n} block_m {cap}: "
              + ", ".join(f"{key} {_ms(ms)}" for key, ms in row.items()), flush=True)
    for label, (h, hkv, s, d, window) in FLASH_SHAPES.items():
        q = torch.randn(1, h, s, d, generator=gen, device=dev).to(torch.bfloat16)
        k_, v = (torch.randn(1, hkv, s, d, generator=gen, device=dev).to(torch.bfloat16)
                 for _ in range(2))
        o = torch.empty_like(q)
        want = attention_ref(q, k_, v, window=window).float()
        row = {}
        for name in FLASH_VARIANTS:
            f = libs[(fa.__name__, name)].acs_flash_attention
            call = lambda: f(q.data_ptr(), k_.data_ptr(), v.data_ptr(),  # noqa: E731
                             o.data_ptr(), 1, h, hkv, s, s, d, 1, d ** -0.5, 1,
                             int(window is not None), window or 0, 0, 0.0, 0, 0, stream)
            row[name] = _checked_time(call, o, want, 2e-2, f"flash {name} at {label}")
        result["flash"][label] = row
        print(f"flash {label} [1, {h}, {s}, {d}] over {hkv} kv heads: "
              + ", ".join(f"{key} {_ms(ms)}" for key, ms in row.items()), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
