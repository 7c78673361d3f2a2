// Device-resident ready-queue epoch executor — the ACS-HW path on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/ready_queue.py::_ready_queue_kernel
// (a Pallas program with grid=(1,) whose fori_loop pops exactly n tasks).
//
// What it computes: one epoch of the window's ready queue. Pop i reads
// t = ring[i] and its task row (branch, in0, in1, in2, out_row), applies the
// branch's opcode elementwise to slab rows and writes the out row, sets
// done[t], then walks dep_tbl[t, 0..m) in column order: each dependent's
// counter is decremented and, on reaching zero, written at ring[tail++]
// (otherwise, and for the sentinel n, at the trash slot ring[n]).
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor cores):
// if every task's rows came from device memory, bytes moved are
// n * (arity + 1) * d * 4 (2048 tasks x 3 rows x 4096 floats = 100.7 MB,
// 30 us). Counting each input read once and each output written once (the
// slab in and out plus the tables), it is far less; chip_smoke.py reports
// that stricter bound. Either way the kernel is latency-bound, not
// bandwidth-bound: the pops are a serial chain.
//
// Design of this first version: simple and right. One persistent block
// (grid = 1, 512 threads) runs the n pops in order, as the Pallas kernel
// does, so tasks are serialised on one SM of the card's 132. Per pop,
// thread 0 stages the task row in shared memory, all threads compute the d
// elements of the out row (strided, coalesced), and thread 0 retires the
// task. The counters and the ring live in the global scratch the wrapper
// allocates; thread 0 alone reads and writes them, and keeps the trash
// slot in a register, so a sentinel edge costs no memory access.
// Spreading ready tasks over the SMs is later work.
//
// Rounding: each opcode is written with __fmul_rn / __fadd_rn / __fsub_rn
// and the file is built with -fmad=false, so every step rounds exactly as
// PyTorch's eager op-by-op kernels do and the slab is bit-equal to the
// serial baseline.
//
// A task id outside [0, n), an unknown opcode or a row outside [0, rows)
// ends the epoch early (the rest of done stays 0), so corrupted tables
// surface as the caller's stall error instead of an out-of-bounds access.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

// Opcodes: kernels/ops.py LOOP_OPCODES.
constexpr int OP_AXPY = 0;  // 1.5 * x + y + 1
constexpr int OP_MUL = 1;   // x * y - 0.5

__global__ void __launch_bounds__(kThreads)
ready_queue_kernel(float* slab, int rows, int d,
                   const int* __restrict__ task_tbl,
                   const int* __restrict__ dep_tbl, int n, int m,
                   const int* __restrict__ branch_ops, int n_branches,
                   int* ring, int* rem, int* done,
                   const int* __restrict__ tail0) {
  __shared__ int s_op, s_in0, s_in1, s_out, s_stop;

  for (int i = threadIdx.x; i < n; i += blockDim.x) done[i] = 0;
  // Only thread 0's copies are used. The trash slot ring[n] is only ever
  // written, and rem[n] never read, so thread 0 keeps the slot's last
  // value in a register and a sentinel edge touches no memory.
  int tail = tail0[0];
  int trash = ring[n];
  int t = 0;
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    if (threadIdx.x == 0) {
      t = ring[i];
      int stop = t < 0 || t >= n;
      if (!stop) {
        const int* task = task_tbl + 5 * (size_t)t;
        int b = task[0];
        stop = b < 0 || b >= n_branches;
        s_op = stop ? -1 : branch_ops[b];
        s_in0 = task[1];
        s_in1 = task[2];
        s_out = task[4];
        // task[3] (in2) is not read: every opcode takes two rows.
        stop = stop || (s_op != OP_AXPY && s_op != OP_MUL) || s_in0 < 0 ||
               s_in0 >= rows || s_in1 < 0 || s_in1 >= rows || s_out < 0 ||
               s_out >= rows;
      }
      s_stop = stop;
    }
    __syncthreads();
    if (s_stop) break;

    const float* x = slab + (size_t)s_in0 * d;
    const float* y = slab + (size_t)s_in1 * d;
    float* out = slab + (size_t)s_out * d;
    const int op = s_op;
    for (int e = threadIdx.x; e < d; e += blockDim.x) {
      const float a = x[e];
      const float b = y[e];
      float r;
      if (op == OP_AXPY) {
        r = __fadd_rn(__fadd_rn(__fmul_rn(1.5f, a), b), 1.0f);
      } else {  // OP_MUL
        r = __fsub_rn(__fmul_rn(a, b), 0.5f);
      }
      out[e] = r;  // out may alias x or y: same thread, same element
    }
    __syncthreads();  // the row is written before any later pop reads it

    if (threadIdx.x == 0) {
      done[t] = 1;
      const int* deps = dep_tbl + (size_t)t * m;
      for (int j = 0; j < m; ++j) {
        const int dep = deps[j];
        if (dep < 0 || dep >= n) {  // the sentinel, or a corrupted edge
          trash = n;
        } else if (--rem[dep] == 0) {
          // tail reaches n only when ring0 and rem0 disagree (a task
          // pushed twice); such a push lands in the trash slot.
          if (tail < n) ring[tail] = dep; else trash = dep;
          ++tail;
        } else {
          trash = dep;
        }
      }
    }
    // No barrier needed here: ring, rem and done are thread 0's alone, and
    // the staged task row is rewritten only after every thread passed the
    // barrier above.
  }
  if (threadIdx.x == 0) ring[n] = trash;
}

}  // namespace

extern "C" int acs_ready_queue(float* slab, int rows, int d,
                               const int* task_tbl, const int* dep_tbl, int n,
                               int m, const int* branch_ops, int n_branches,
                               int* ring, int* rem, int* done,
                               const int* tail0, void* stream) {
  ready_queue_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      slab, rows, d, task_tbl, dep_tbl, n, m, branch_ops, n_branches, ring,
      rem, done, tail0);
  return static_cast<int>(cudaGetLastError());
}
