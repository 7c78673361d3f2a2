// ACS-HW wave megakernel: one launch runs a whole wave of small elementwise
// tasks from a descriptor table.
//
// Replaces the TPU kernel
// src/repro/kernels/wave_elementwise.py::wave_elementwise (_wave_kernel), a
// Pallas grid over wave slots whose input index maps read each slot's
// descriptor through scalar prefetch.
//
// What it computes: slot si reads its descriptor (branch, in0, in1, out) from
// desc[si], applies the branch's opcode elementwise to slab rows in0 and in1,
// and writes row si of the [S, D] output. The out column is not used here:
// the wrapper's apply_wave scatters row si to slab row out (unique within a
// wave). Every slot reads the unmodified input slab, so a slot may read the
// row another slot (or itself) writes.
//
// Bound on the H100 (3.35 TB/s; 67 TFLOP/s fp32 outside the tensor cores):
// each slot reads two rows and writes one, 3 * D * 4 bytes, and does 2-3
// flops an element, so the kernel is bound by bytes (32 slots of D = 4096:
// 1.5 MiB, 0.47 us). At the device window's wave widths it is bound by the
// launch itself (a few us), not by either.
//
// Design, simple and right: grid = (S slots, D chunks of 1024 elements),
// 256 threads a block. Every thread reads the slot's four descriptor words
// (one broadcast load), then strides over its chunk of the row, coalesced.
// Blocks are independent: the TPU grid's slot order does not matter here
// because no slot reads another slot's output.
//
// Rounding: each opcode is written with __fmul_rn / __fadd_rn / __fsub_rn
// and the file is built with -fmad=false, as csrc/ready_queue.cu is, so each
// row rounds exactly as PyTorch's eager op-by-op kernels do.
//
// A descriptor whose branch id is outside the branch table, whose opcode is
// unknown, or whose in0, in1 or out row lies outside [0, rows) makes its slot
// write nothing and sets *err to 1; the wrapper raises on it. No load ever
// leaves the slab.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = kThreads * 4;  // row elements per block

// Opcodes: kernels/ops.py LOOP_OPCODES (the same table as ready_queue.cu).
constexpr int OP_AXPY = 0;  // 1.5 * x + y + 1
constexpr int OP_MUL = 1;   // x * y - 0.5

__global__ void __launch_bounds__(kThreads)
wave_kernel(const float* __restrict__ slab, int rows, int d,
            const int* __restrict__ desc,
            const int* __restrict__ branch_ops, int n_branches,
            float* __restrict__ out, int* __restrict__ err) {
  const int si = blockIdx.x;
  const int* slot = desc + 4 * (size_t)si;
  const int b = slot[0];
  const int in0 = slot[1];
  const int in1 = slot[2];
  const int dst = slot[3];
  const int op = (b >= 0 && b < n_branches) ? branch_ops[b] : -1;
  const bool bad = (op != OP_AXPY && op != OP_MUL) || in0 < 0 || in0 >= rows ||
                   in1 < 0 || in1 >= rows || dst < 0 || dst >= rows;
  if (bad) {
    if (threadIdx.x == 0) *err = 1;  // every writer stores the same value
    return;
  }
  const float* x = slab + (size_t)in0 * d;
  const float* y = slab + (size_t)in1 * d;
  float* r = out + (size_t)si * d;
  const int lo = blockIdx.y * kChunk;
  const int hi = min(d, lo + kChunk);
  if (op == OP_AXPY) {
    for (int e = lo + threadIdx.x; e < hi; e += kThreads) {
      r[e] = __fadd_rn(__fadd_rn(__fmul_rn(1.5f, x[e]), y[e]), 1.0f);
    }
  } else {  // OP_MUL
    for (int e = lo + threadIdx.x; e < hi; e += kThreads) {
      r[e] = __fsub_rn(__fmul_rn(x[e], y[e]), 0.5f);
    }
  }
}

}  // namespace

extern "C" int acs_wave_elementwise(const float* slab, int rows, int d,
                                    const int* desc, int s,
                                    const int* branch_ops, int n_branches,
                                    float* out, int* err, void* stream) {
  if (s == 0 || d == 0) return 0;
  const dim3 grid(s, (d + kChunk - 1) / kChunk);
  wave_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      slab, rows, d, desc, branch_ops, n_branches, out, err);
  return static_cast<int>(cudaGetLastError());
}
