"""Where one block of a backward kernel spends its time, on the card.

Flash attention's wgmma backward (``--dim 64|192|256``): builds a copy of
``csrc/flash_attention_bwd_wgmma.cu`` with ``%globaltimer`` stamps
(nanoseconds) that thread 0 of consumer warpgroup 0 of one block writes at
each step of the key-tile pass (an item: its tiles landed, S^T and dP^T
done, the elementwise step done, the dK / dV products done) and of the
query-tile pass (a key tile: landed, S and dP done, dS done, dQ's product
done), runs the backward at a training shape and prints each step's
phases in microseconds, one JSON line a pass. At MLA's widths the passes
are persistent: a block walks many units and its steps run on across
them, and a key-tile step's dK / dV products are issued (not done) at its
last stamp: they complete under the next step's S^T and dP^T.

The selective scan's backward (``--scan``): a copy of
``csrc/selective_scan.cu`` whose thread 0 of one block stamps each chunk
(its start, its tiles landed, the state loop done, the warps' db and dc
summed, its stores done) and adds up, over the chunk's state pairs, the
time of the forward replay, of the adjoint and of the db / dc hand-off
(the per-pair barrier and sum in the first design, the shuffle and the
write to the warps' sums in the present one), at falcon-mamba-7b's training shape
``[4, 512, 8192]``, N 16, bf16; one JSON line.

The copies land in ``_build/trace/`` beside the other builds. Each stamp
follows (or precedes) a line of text of the source; a stamp none of whose
lines the source has stops the tool rather than timing the wrong thing.

    python -m repro_torch.kernels.bwd_trace [--dim 64|192|256] [--scan] [--block B]

(``PYTHONPATH=src``, on a machine with the card; ~1 min with the build.)
D 64 is minicpm-2b's training shape ``[4, 36, 512, 64]`` causal, D 256
recurrentgemma-2b's ``[4, 10, 512, 256]`` over one kv head, 192 deepseek-v2's
MLA ``[4, 128, 512, 192]`` with v at 128. The tool runs on any tree of the
port with these backwards (copy it into the tree's ``src/repro_torch/kernels/``):
its scan stamps find the lines of both designs of the scan's backward (a
barrier a state pair, and one sum a chunk).
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
ss = importlib.import_module("repro_torch.kernels.selective_scan")

_STEPS = 64  # steps (flash) or chunks (scan) a pass records
_MARKS = 4   # flash: stamps a step
_SCAN_MARKS = 5  # scan: stamps a chunk
_SCAN_SUMS = 3   # scan: replay, adjoint and db / dc hand-off times a chunk

# (pass, mark, where, alternatives): the stamp goes right after ("after")
# or before ("before") each alternative line the source has (each at most
# once; at least one). Pass 0 is the key-tile pass (D <= 128's arrangement,
# D 256's, and MLA's persistent one, whose dK / dV products are issued, not
# done, at a step's last stamp), 1 the query-tile pass (a block a unit,
# and MLA's persistent one).
_ANCHORS = [
    (0, 0, "after", ["      mbar_wait(&sm.full[s], (i / S::kStages) & 1);\n",
                     "    mbar_wait(&sm.full[s], (i / S::kStages) & 1);\n"
                     "    const int row0 = p.q_offset + (qt_begin + (it_lo + i) % n_q) * kWgRows;\n",
                     "    mbar_wait(&ring.full[s], (i / kStages) & 1);\n"]),
    (0, 1, "after", ["      fence_regs(st);\n      fence_regs(dpt);\n",
                     "    wgmma_wait<0>();\n    fence_regs(st);\n    fence_regs(dpt);\n",
                     "    wgmma_wait<0>();  // this item's S^T and dP^T\n    fence_regs(st);\n"
                     "    fence_regs(dpt);\n"]),
    (0, 2, "before", ["      wgmma_fence();\n#pragma unroll\n"
                      "      for (int kk = 0; kk < kWgRows / 16; ++kk) {  // dV",
                      "    named_sync(1, 256);  // both warpgroups are past",
                      "    named_sync(1, 256);  // both warpgroups' last products are done"]),
    (0, 3, "before", ["      if (tid == 0) mbar_arrive(&sm.empty[s]);\n",
                      "    fence_regs(acc);\n    if (tid == 0) mbar_arrive(&sm.empty[s]);\n",
                      "    wgmma_commit();\n    held = s;\n"]),
    (1, 0, "after", ["    mbar_wait(&full[s], (i / S::kStages) & 1);\n",
                     "      mbar_wait(&full[s], (i / kSt) & 1);\n"]),
    (1, 1, "after", ["    fence_regs(sa);\n    fence_regs(dp);\n",
                     "      fence_regs(sa);\n      fence_regs(dp);\n"]),
    (1, 2, "before", ["    wgmma_fence();\n#pragma unroll\n"
                      "    for (int kk = 0; kk < BN / 16; ++kk) {  // dQ",
                      "      wgmma_fence();\n#pragma unroll\n"
                      "      for (int kk = 0; kk < BN / 16; ++kk) {  // dQ"]),
    (1, 3, "before", ["    if (tid == 0) mbar_arrive(&empty[s]);\n",
                      "      if (tid == 0) mbar_arrive(&empty[s]);  // the stage's k and v are read\n"]),
]

_TRACED = "(blockIdx.x == ACS_TRACE_BLOCK && threadIdx.x == 0)"
_CHUNK = "(nt - 1 - k)"  # the chunk's place in the backward's walk
# The scan backward's stamps: (text inserted, where, alternatives); the
# first design's lines (a barrier a state pair) first, then the present one's.
_SCAN_ANCHORS = [
    (f"if {_TRACED} g_scan[{_CHUNK} * {_SCAN_MARKS} + 0] = acs_now();", "after",
     ["  for (int k = nt - 1; k >= 0; --k) {\n"]),
    (f"if {_TRACED} g_scan[{_CHUNK} * {_SCAN_MARKS} + 1] = acs_now();", "after",
     ["    cp_async_wait<0>();\n    __syncthreads();\n",
      "    __syncthreads();  // [A]: chunk k is in buffer k & 1, and chunk k + 1's buffer is free\n"]),
    (f"unsigned long long acs_t = {_TRACED} ? acs_now() : 0ull;", "after",
     ["      const int row = cl * n + nn;\n"]),
    (f"if {_TRACED} {{ g_sums[{_CHUNK} * {_SCAN_SUMS} + 0] += acs_now() - acs_t; "
     f"acs_t = acs_now(); }}", "before",
     ["      // The adjoint: each lane's pair from a zero carry, in reverse.\n"]),
    (f"if {_TRACED} {{ g_sums[{_CHUNK} * {_SCAN_SUMS} + 1] += acs_now() - acs_t; "
     f"acs_t = acs_now(); }}", "before",
     ["      // db and dc over the block's channels: the warp's two by a shuffle,\n",
      "      // db and dc over the warp's two channels: lanes 0-15 add their\n"]),
    (f"if {_TRACED} g_sums[{_CHUNK} * {_SCAN_SUMS} + 2] += acs_now() - acs_t;", "before",
     ["      ++pair;\n",
      "    };\n    int nn = 0;\n    for (; nn + 1 < n; nn += 2) states(std::integral_constant<int, 2>{}, nn);\n"
      "    if (nn < n) states(std::integral_constant<int, 1>{}, nn);\n"
      "    __syncthreads();  // [B]"]),
    (f"if {_TRACED} g_scan[{_CHUNK} * {_SCAN_MARKS} + 2] = acs_now();", "before",
     ["    __syncthreads();  // the chunk's db and dc sums are whole\n",
      "    __syncthreads();  // [B]: every warp's db and dc of the chunk are written\n"]),
    (f"if {_TRACED} g_scan[{_CHUNK} * {_SCAN_MARKS} + 3] = acs_now();", "before",
     ["#pragma unroll\n    for (int i = 0; i < kSeg; ++i) {\n      const int t = t_seg + i;\n"
      "      if (!live || t >= rows) continue;\n"]),
    (f"if {_TRACED} g_scan[{_CHUNK} * {_SCAN_MARKS} + 4] = acs_now();", "before",
     ["  }\n\n  __syncthreads();  // s_g holds dh0 and s_da the block's da\n"]),
]

_TIMER = ("__device__ __forceinline__ unsigned long long acs_now() {\n"
          "  unsigned long long t;\n"
          "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
          "  return t;\n}\n")


def _stamp(pass_, mark, indent):
    return (f"{indent}if {_TRACED} "
            f"g_trace[({pass_} * {_STEPS} + min(i, {_STEPS - 1})) * {_MARKS} + {mark}] = "
            f"acs_now();\n")


def _insert(src, text, where, alternatives):
    """``src`` with ``text`` (a line, indented as the anchor, or a function
    of that indent giving the lines) after or before each alternative it
    holds; raises when it holds none, or one more than once."""
    found = 0
    for alt in alternatives:
        count = src.count(alt)
        if count > 1:
            raise RuntimeError(f"bwd_trace: anchor found {count} times: {alt.strip()[:60]}")
        if not count:
            continue
        found += 1
        # the stamp's indent: the anchor's line's (after), or its first line's (before)
        line = alt.rstrip("\n").split("\n")[-1 if where == "after" else 0]
        indent = line[:len(line) - len(line.lstrip())]
        if "}" == line.strip()[:1]:  # a closing brace: the body's indent, one level in
            indent += "  "
        stamp = text(indent) if callable(text) else f"{indent}{text}\n"
        src = src.replace(alt, alt + stamp if where == "after" else stamp + alt)
    if not found:
        raise RuntimeError(f"bwd_trace: anchor not found: {alternatives[0].strip()[:60]}")
    return src


def _with_head(src, head):
    anchor = "\nnamespace {\n"
    if anchor not in src:
        raise RuntimeError("bwd_trace: the source's namespace anchor moved")
    return src.replace(anchor, "\n" + head + anchor[1:], 1)


def stamped_text() -> str:
    """Flash's wgmma backward with the stamps, the timer and the stamps'
    reader added; raises where an anchor is missing."""
    src = _with_head(fa.BACKWARD_WGMMA_SOURCE.read_text(),
                     "__device__ unsigned long long g_trace[2 * %d * %d];\n" % (_STEPS, _MARKS)
                     + _TIMER)
    for pass_, mark, where, alternatives in _ANCHORS:
        src = _insert(src, lambda indent: _stamp(pass_, mark, indent), where, alternatives)
    return src + ("\nextern \"C\" int acs_trace_read(void* host) {\n"
                  "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_trace, "
                  "sizeof(g_trace)));\n}\n")


def scan_stamped_text() -> str:
    """The selective scan's source with the backward's chunk stamps, the
    timer and the stamps' reader added; raises where an anchor is
    missing."""
    src = _with_head(ss.SOURCE.read_text(),
                     "__device__ unsigned long long g_scan[%d * %d];\n"
                     "__device__ unsigned long long g_sums[%d * %d];\n"
                     % (_STEPS, _SCAN_MARKS, _STEPS, _SCAN_SUMS) + _TIMER)
    for text, where, alternatives in _SCAN_ANCHORS:
        src = _insert(src, text, where, alternatives)
    return src + ("\nextern \"C\" int acs_trace_read(void* host) {\n"
                  "  cudaError_t e = cudaMemcpyFromSymbol(host, g_scan, sizeof(g_scan));\n"
                  "  if (e == cudaSuccess)\n"
                  "    e = cudaMemcpyFromSymbol(static_cast<char*>(host) + sizeof(g_scan), "
                  "g_sums, sizeof(g_sums));\n"
                  "  return static_cast<int>(e);\n}\n"
                  "extern \"C\" int acs_trace_clear() {\n"
                  "  static unsigned long long zeros[sizeof(g_sums) / 8];\n"
                  "  return static_cast<int>(cudaMemcpyToSymbol(g_sums, zeros, sizeof(g_sums)));\n"
                  "}\n")


def _traced_copy(source, text, block, flags):
    out = _nvcc.BUILD_DIR / "trace"
    out.mkdir(parents=True, exist_ok=True)
    for header in source.parent.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    path = out / source.name
    path.write_text(text)
    return path, (*flags, f"-DACS_TRACE_BLOCK={block}")


def traced_source(block: int):
    """Write the stamped copy of flash's backward source; returns its path
    and the build flags (the trace block a define)."""
    return _traced_copy(fa.BACKWARD_WGMMA_SOURCE, stamped_text(), block, fa._BACKWARD_FLAGS)


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
        b, h, hkv, s, dv = {64: (4, 36, 36, 512, 64), 192: (4, 128, 128, 512, 128),
                            256: (4, 10, 1, 512, 256)}[dim]
        q = torch.randn(b, h, s, dim, generator=gen, device=dev).to(torch.bfloat16)
        do = torch.randn(b, h, s, dv, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(b, hkv, s, dim, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(b, hkv, s, dv, generator=gen, device=dev).to(torch.bfloat16)
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


def trace_scan(block: int = 0) -> dict:
    """Run the stamped scan backward at falcon-mamba-7b's training shape
    (the stamps cleared before the last of three calls, whose are read):
    per chunk, in the order the block walks them, the microseconds of
    staging (start to tiles landed), the state loop (and in it the replay,
    adjoint and db / dc hand-off, summed over its state pairs), the db / dc
    sums (state loop done to the outputs' start) and the stores."""
    path, flags = _traced_copy(ss.SOURCE, scan_stamped_text(), block, _nvcc.NVCC_FLAGS)

    def bind(lib):
        ss._bind(lib)
        lib.acs_trace_read.argtypes = [ctypes.c_void_p]
        lib.acs_trace_read.restype = ctypes.c_int
        lib.acs_trace_clear.argtypes = []
        lib.acs_trace_clear.restype = ctypes.c_int

    lib = _nvcc.CudaLibrary(path, bind, flags)
    saved = ss._LIB, ss._ENTRY
    ss._LIB, ss._ENTRY = lib, None
    try:
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        b, s, e, n, rank = 4, 512, 8192, 16, 256
        xz = torch.randn(b, s, 2 * e, generator=gen, device=dev).to(torch.bfloat16)
        proj = torch.randn(b, s, rank + 2 * n, generator=gen, device=dev).to(torch.bfloat16)
        a_log = (torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev))[None]
                 + 0.1 * torch.randn(e, n, generator=gen, device=dev)).contiguous()
        args = (torch.randn(b, s, e, generator=gen, device=dev).to(torch.bfloat16),
                0.5 * torch.randn(e, generator=gen, device=dev), xz[..., :e], xz[..., e:],
                proj[..., rank: rank + n], proj[..., rank + n:], a_log,
                torch.randn(e, generator=gen, device=dev), torch.zeros(b, e, n, device=dev))
        _, _, states = ss.mamba_scan_fwd(*args)
        dy = torch.randn(b, s, e, generator=gen, device=dev).to(torch.bfloat16)
        for i in range(3):
            if i == 2:
                torch.cuda.synchronize()
                if lib.get().acs_trace_clear():
                    raise RuntimeError("bwd_trace: clearing the sums failed")
            ss.mamba_scan_bwd(*args, states, dy, None)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (_STEPS * (_SCAN_MARKS + _SCAN_SUMS)))()
        if lib.get().acs_trace_read(ctypes.addressof(buf)):
            raise RuntimeError("bwd_trace: reading the stamps failed")
    finally:
        ss._LIB, ss._ENTRY = saved
    chunks = []
    sums = buf[_STEPS * _SCAN_MARKS:]
    for c in range(_STEPS):
        st = buf[c * _SCAN_MARKS:(c + 1) * _SCAN_MARKS]
        if not all(st):
            continue
        chunks.append({"staging": (st[1] - st[0]) / 1e3, "state_loop": (st[2] - st[1]) / 1e3,
                       "replay": sums[c * _SCAN_SUMS] / 1e3,
                       "adjoint": sums[c * _SCAN_SUMS + 1] / 1e3,
                       "db_dc_handoff": sums[c * _SCAN_SUMS + 2] / 1e3,
                       "db_dc_sums": (st[3] - st[2]) / 1e3, "stores": (st[4] - st[3]) / 1e3})
    total = {key: sum(ch[key] for ch in chunks) for key in (chunks[0] if chunks else {})}
    return {"kernel": "mamba_scan_bwd", "shape": [4, 512, 8192, 16], "block": block,
            "chunks": chunks, "total_us": total, "device": torch.cuda.get_device_name(0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=64, choices=(64, 192, 256))
    ap.add_argument("--scan", action="store_true", help="the selective scan's backward instead")
    ap.add_argument("--block", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bwd_trace: needs a CUDA device")
    if args.scan:
        print(json.dumps(trace_scan(args.block)))
        return 0
    for row in trace(args.dim, args.block):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
