"""Where one block of flash's wgmma backward spends its time, on the card.

Builds a copy of ``csrc/flash_attention_bwd_wgmma.cu`` with ``%globaltimer``
stamps (nanoseconds) that thread 0 of consumer warpgroup 0 of one block
writes at each step of the key-tile pass (an item: its tiles landed, S^T
and dP^T done, the elementwise step done, the dK / dV products done) and
of the query-tile pass (a key tile: landed, S and dP done, dS done, dQ's
product done), runs the backward at a training shape and prints each
step's phases in microseconds, one JSON line a pass. The copy lands in
``_build/trace/`` beside the other builds; an anchor the source no longer
has stops the tool rather than timing the wrong thing.

    python -m repro_torch.kernels.bwd_trace [--dim 64|256] [--block B]

(``PYTHONPATH=src``, on a machine with the card; ~1 min with the build.)
D 64 is minicpm-2b's training shape ``[4, 36, 512, 64]`` causal, D 256
recurrentgemma-2b's ``[4, 10, 512, 256]`` over one kv head.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import shutil

import torch

from . import _nvcc

fa = importlib.import_module("repro_torch.kernels.flash_attention")

_STEPS = 64  # steps a pass records
_MARKS = 4   # stamps a step
# (anchor in the source, pass, mark): the stamp goes right after the
# anchor. Pass 0 is the key-tile pass (both designs), 1 the query-tile pass.
_ANCHORS = [
    ("      mbar_wait(&sm.full[s], (i / S::kStages) & 1);\n", 0, 0),
    ("    mbar_wait(&sm.full[s], (i / S::kStages) & 1);\n"
     "    const int row0 = p.q_offset + (qt_begin + (it_lo + i) % n_q) * kWgRows;\n", 0, 0),
    ("      fence_regs(st);\n      fence_regs(dpt);\n", 0, 1),
    ("    fence_regs(st);\n    fence_regs(dpt);\n", 0, 1),
    ("    mbar_wait(&full[s], (i / S::kStages) & 1);\n", 1, 0),
    ("    fence_regs(sa);\n    fence_regs(dp);\n", 1, 1),
]
# (anchor, pass, mark): the stamp goes right before the anchor.
_BEFORE = [
    ("      wgmma_fence();\n#pragma unroll\n"
     "      for (int kk = 0; kk < kWgRows / 16; ++kk) {  // dV", 0, 2),
    ("    named_sync(1, 256);  // both warpgroups are past", 0, 2),
    ("      if (tid == 0) mbar_arrive(&sm.empty[s]);\n", 0, 3),
    ("    fence_regs(acc);\n    if (tid == 0) mbar_arrive(&sm.empty[s]);\n", 0, 3),
    ("    wgmma_fence();\n#pragma unroll\n    for (int kk = 0; kk < BN / 16; ++kk) {  // dQ", 1, 2),
    ("    if (tid == 0) mbar_arrive(&empty[s]);\n", 1, 3),
]


def _stamp(pass_, mark, indent):
    return (f"{indent}if (blockIdx.x == ACS_TRACE_BLOCK && threadIdx.x == 0) "
            f"g_trace[({pass_} * {_STEPS} + min(i, {_STEPS - 1})) * {_MARKS} + {mark}] = "
            f"acs_now();\n")


def stamped_text() -> str:
    """The backward's source with the stamps, the timer and the stamps'
    reader added; raises where an anchor is missing."""
    src = fa.BACKWARD_WGMMA_SOURCE.read_text()
    head = ("__device__ unsigned long long g_trace[2 * %d * %d];\n"
            "__device__ __forceinline__ unsigned long long acs_now() {\n"
            "  unsigned long long t;\n"
            "  asm volatile(\"mov.u64 %%0, %%%%globaltimer;\" : \"=l\"(t));\n"
            "  return t;\n}\n" % (_STEPS, _MARKS))
    anchor = "\nnamespace {\n"
    if anchor not in src:
        raise RuntimeError("bwd_trace: the source's namespace anchor moved")
    src = src.replace(anchor, "\n" + head + anchor[1:], 1)
    for text, pass_, mark in _ANCHORS:
        if text not in src:
            raise RuntimeError(f"bwd_trace: anchor not found: {text.strip()[:60]}")
        indent = text[:len(text) - len(text.lstrip())]
        src = src.replace(text, text + _stamp(pass_, mark, indent))
    for text, pass_, mark in _BEFORE:
        if text not in src:
            raise RuntimeError(f"bwd_trace: anchor not found: {text.strip()[:60]}")
        indent = text[:len(text) - len(text.lstrip())]
        src = src.replace(text, _stamp(pass_, mark, indent) + text)
    return src + ("\nextern \"C\" int acs_trace_read(void* host) {\n"
                  "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_trace, "
                  "sizeof(g_trace)));\n}\n")


def traced_source(block: int):
    """Write the stamped copy of the backward's source; returns its path
    and the build flags (the trace block a define)."""
    src = stamped_text()
    out = _nvcc.BUILD_DIR / "trace"
    out.mkdir(parents=True, exist_ok=True)
    for header in fa.BACKWARD_WGMMA_SOURCE.parent.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    path = out / fa.BACKWARD_WGMMA_SOURCE.name
    path.write_text(src)
    return path, (*fa._BACKWARD_FLAGS, f"-DACS_TRACE_BLOCK={block}")


def trace(dim: int = 64, block: int = 0) -> list:
    """Run the stamped backward at ``dim``'s training shape (three calls;
    the last one's stamps are read) and return one dict a pass: the
    block's steps, each as microseconds from its first stamp."""
    path, flags = traced_source(block)

    def bind(lib):
        fa._bind_backward_wgmma(lib)
        lib.acs_trace_read.argtypes = [ctypes.c_void_p]
        lib.acs_trace_read.restype = ctypes.c_int

    lib = _nvcc.CudaLibrary(path, bind, flags)
    saved = fa._BACKWARD_WGMMA_LIB, fa._BACKWARD_WGMMA_ENTRY
    fa._BACKWARD_WGMMA_LIB, fa._BACKWARD_WGMMA_ENTRY = lib, None
    try:
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        b, h, hkv, s = {64: (4, 36, 36, 512), 256: (4, 10, 1, 512)}[dim]
        q, do = (torch.randn(b, h, s, dim, generator=gen, device=dev).to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn(b, hkv, s, dim, generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        out, lse = fa.flash_attention_lse(q, k, v)
        for _ in range(3):
            fa.flash_attention_bwd(q, k, v, out, lse, do)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (2 * _STEPS * _MARKS))()
        if lib.get().acs_trace_read(ctypes.addressof(buf)):
            raise RuntimeError("bwd_trace: reading the stamps failed")
    finally:
        fa._BACKWARD_WGMMA_LIB, fa._BACKWARD_WGMMA_ENTRY = saved
    rows = []
    names = (("landed", "s_dp", "elementwise", "dk_dv"), ("landed", "s_dp", "ds", "dq"))
    for pass_, label in ((0, "key-tile pass"), (1, "query-tile pass")):
        stamps = [list(buf[(pass_ * _STEPS + i) * _MARKS:(pass_ * _STEPS + i + 1) * _MARKS])
                  for i in range(_STEPS)]
        stamps = [st for st in stamps if all(st)]
        steps = [{names[pass_][m]: (st[m] - st[m - 1]) / 1e3 for m in range(1, _MARKS)}
                 for st in stamps]
        for j, step in enumerate(steps[1:], 1):  # the wait since the last step ended
            step["wait"] = (stamps[j][0] - stamps[j - 1][3]) / 1e3
        rows.append({"pass": label, "dim": dim, "block": block, "steps": steps,
                     "device": torch.cuda.get_device_name(0)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=64, choices=(64, 256))
    ap.add_argument("--block", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bwd_trace: needs a CUDA device")
    for row in trace(args.dim, args.block):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
