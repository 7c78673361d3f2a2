// ACS-HW wave megakernel: one launch runs a whole wave of small elementwise
// tasks from a descriptor table (wave_kernel), or every wave of a device
// window's epoch, step after step, in one persistent launch
// (wave_epoch_kernel).
//
// Replaces the TPU kernel
// src/repro/kernels/wave_elementwise.py::wave_elementwise (_wave_kernel), a
// Pallas grid over wave slots whose input index maps read each slot's
// descriptor through scalar prefetch, and, for the epoch, the host loop of
// one such call (plus apply_wave's scatter) per plan step that the
// reference compiles into ONE program (src/repro/core/device_dispatch.py).
//
// What a wave computes: slot si reads its descriptor (branch, in0, in1,
// out) from desc[si], applies the branch's opcode elementwise to slab rows
// in0 and in1, and its result goes to slab row out (unique within a wave).
// Every slot reads the slab as it stood before the wave, so a slot may
// read the row another slot (or itself) writes.
//
// Bound on the H100 (3.35 TB/s; 67 TFLOP/s fp32 outside the tensor cores):
// each slot reads two rows and writes one, 3 * D * 4 bytes, and does 2-3
// flops an element, so a wave is bound by bytes (32 slots of D = 4096:
// 1.5 MiB, 0.47 us). At the device window's wave widths (1-4 slots) one
// launch per wave is bound by the launch and the host round around it,
// not by either: hence the epoch kernel.
//
// wave_kernel (one wave, rows out): grid = (S slots, D chunks of 1024
// elements), 256 threads a block. Every thread reads the slot's four
// descriptor words (one broadcast load), then strides over its chunk of
// the row, coalesced, into row si of the [S, D] output; the wrapper's
// apply_wave scatters the rows.
//
// wave_epoch_kernel (every step of an epoch, in place on the slab):
// * A cooperative launch (cudaLaunchCooperativeKernel): every block is
//   resident, so blocks can wait for each other. The grid is no larger
//   than the co-resident count (occupancy x SMs, queried once per device)
//   nor than the widest step's (slot, chunk) items: the chain universe's
//   steps of 1-4 slots of 4096 take 16 blocks, and a barrier over 16
//   blocks is cheaper than one over 1,000.
// * Each step: phase 1, blocks stride over the step's (slot, chunk) items
//   and write each result into a scratch [S_max, D] buffer; a grid
//   barrier (every slot has read the slab); phase 2, each block copies the
//   items it computed to their out rows; a grid barrier (the step's rows
//   are in the slab for the next step). A step the host marked direct (no
//   slot reads a row another slot of the step writes) writes its out rows
//   in phase 1 and skips phase 2 and one barrier; a slot reading its own
//   out row is direct-safe, since each element is read then written by one
//   thread. The last step needs no closing barrier.
// * The barrier (grid_barrier.cuh, shared with ready_queue.cu) is one
//   global arrival counter, zeroed by the wrapper per launch, that only
//   grows: a block's threads sync, its first thread fences, adds one, and
//   spins until the count reaches the barrier's number times the grid (no
//   reset, no second word: one atomic a block).
// * No block returns early: a bad slot skips its work, and every block
//   reaches every barrier.
// * Slab and scratch are read with ld.global.cg (L2, never the
//   non-coherent read-only path) because one step writes what the next
//   reads inside the launch; only desc, steps and branch_ops take __ldg.
// * Measured on an H100 80GB HBM3 at 700 W: the chain universe's 720-step
//   wave plan (every step direct, 16 blocks) takes 1.98 ms of device time
//   (kernels/scan_epoch_times.py, torch.profiler), 2.75 us a step; staging
//   every step adds 2.3-2.6 us a step (chip_smoke.py phase 7): that is
//   what one more grid barrier over 16 blocks, and the copy, cost. A
//   first barrier on two words (a reset and a generation bump by the last
//   arrival) cost ~0.5 us more a barrier, in another call, and made ptxas
//   spill. 48 registers, no spills.
//
// Rounding: each opcode is written with __fmul_rn / __fadd_rn / __fsub_rn
// and the file is built with -fmad=false, as csrc/ready_queue.cu is, so each
// row rounds exactly as PyTorch's eager op-by-op kernels do.
//
// A descriptor whose branch id is outside the branch table, whose opcode is
// unknown, or whose in0, in1 or out row lies outside [0, rows) makes its slot
// write nothing and sets *err to 1; the wrapper raises on it. No load ever
// leaves the slab. In an epoch the later steps still run, as the host loop
// of single-wave launches did.

#include <cuda_runtime.h>

#include <cstddef>

#include "grid_barrier.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = kThreads * 4;  // row elements per block
constexpr int kMaxDevices = 64;

// Opcodes: kernels/ops.py LOOP_OPCODES (the same table as ready_queue.cu).
constexpr int OP_AXPY = 0;  // 1.5 * x + y + 1
constexpr int OP_MUL = 1;   // x * y - 0.5

struct Slot {
  int op, in0, in1, out;
  bool bad;
};

__device__ __forceinline__ Slot read_slot(const int* __restrict__ desc, int si, int rows,
                                          const int* __restrict__ branch_ops, int n_branches) {
  const int* d = desc + 4 * static_cast<size_t>(si);
  Slot s;
  const int b = __ldg(d);
  s.in0 = __ldg(d + 1);
  s.in1 = __ldg(d + 2);
  s.out = __ldg(d + 3);
  s.op = (b >= 0 && b < n_branches) ? __ldg(branch_ops + b) : -1;
  s.bad = (s.op != OP_AXPY && s.op != OP_MUL) || s.in0 < 0 || s.in0 >= rows || s.in1 < 0 ||
          s.in1 >= rows || s.out < 0 || s.out >= rows;
  return s;
}

__global__ void __launch_bounds__(kThreads)
wave_kernel(const float* __restrict__ slab, int rows, int d,
            const int* __restrict__ desc,
            const int* __restrict__ branch_ops, int n_branches,
            float* __restrict__ out, int* __restrict__ err) {
  const int si = blockIdx.x;
  const Slot s = read_slot(desc, si, rows, branch_ops, n_branches);
  if (s.bad) {
    if (threadIdx.x == 0) *err = 1;  // every writer stores the same value
    return;
  }
  const float* x = slab + (size_t)s.in0 * d;
  const float* y = slab + (size_t)s.in1 * d;
  float* r = out + (size_t)si * d;
  const int lo = blockIdx.y * kChunk;
  const int hi = min(d, lo + kChunk);
  if (s.op == OP_AXPY) {
    for (int e = lo + threadIdx.x; e < hi; e += kThreads) {
      r[e] = __fadd_rn(__fadd_rn(__fmul_rn(1.5f, x[e]), y[e]), 1.0f);
    }
  } else {  // OP_MUL
    for (int e = lo + threadIdx.x; e < hi; e += kThreads) {
      r[e] = __fsub_rn(__fmul_rn(x[e], y[e]), 0.5f);
    }
  }
}

struct EpochParams {
  float* slab;              // [rows, d], updated in place
  int rows, d;
  const int* desc;          // [sum S_i, 4]
  const int* steps;         // [2 * n_steps + 1]: offsets, then a direct flag per step
  int n_steps;
  const int* branch_ops;    // [n_branches]
  int n_branches;
  float* scratch;           // [S_max, d]
  int* err;                 // [1]
  unsigned int* arrivals;   // [1], 0 at launch
  int chunks;               // ceil(d / kChunk)
};

__global__ void __launch_bounds__(kThreads) wave_epoch_kernel(const EpochParams p) {
  unsigned int target = 0;  // the arrival count the next barrier waits for
  for (int k = 0; k < p.n_steps; ++k) {
    const int lo = __ldg(p.steps + k);
    const int n_items = (__ldg(p.steps + k + 1) - lo) * p.chunks;
    const bool direct = __ldg(p.steps + p.n_steps + 1 + k) != 0;
    // Phase 1: each item's result, into its out row (direct) or scratch.
    for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
      const int si = it / p.chunks;
      const int e0 = (it - si * p.chunks) * kChunk;
      const int e1 = min(p.d, e0 + kChunk);
      const Slot s = read_slot(p.desc, lo + si, p.rows, p.branch_ops, p.n_branches);
      if (s.bad) {
        if (threadIdx.x == 0) *p.err = 1;  // every writer stores the same value
        continue;
      }
      const float* x = p.slab + (size_t)s.in0 * p.d;
      const float* y = p.slab + (size_t)s.in1 * p.d;
      float* r = (direct ? p.slab + (size_t)s.out * p.d : p.scratch + (size_t)si * p.d);
      if (s.op == OP_AXPY) {
        for (int e = e0 + threadIdx.x; e < e1; e += kThreads) {
          __stcg(r + e, __fadd_rn(__fadd_rn(__fmul_rn(1.5f, __ldcg(x + e)), __ldcg(y + e)), 1.0f));
        }
      } else {  // OP_MUL
        for (int e = e0 + threadIdx.x; e < e1; e += kThreads) {
          __stcg(r + e, __fsub_rn(__fmul_rn(__ldcg(x + e), __ldcg(y + e)), 0.5f));
        }
      }
    }
    if (direct) {
      if (k + 1 < p.n_steps) grid_barrier(p.arrivals, target += gridDim.x);
      continue;
    }
    grid_barrier(p.arrivals, target += gridDim.x);  // every slot has read the slab
    // Phase 2: the same items, by the same blocks and threads, scratch ->
    // out row (each thread copies exactly the elements it wrote).
    for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
      const int si = it / p.chunks;
      const int e0 = (it - si * p.chunks) * kChunk;
      const int e1 = min(p.d, e0 + kChunk);
      const Slot s = read_slot(p.desc, lo + si, p.rows, p.branch_ops, p.n_branches);
      if (s.bad) continue;
      const float* src = p.scratch + (size_t)si * p.d;
      float* dst = p.slab + (size_t)s.out * p.d;
      for (int e = e0 + threadIdx.x; e < e1; e += kThreads) __stcg(dst + e, __ldcg(src + e));
    }
    if (k + 1 < p.n_steps) grid_barrier(p.arrivals, target += gridDim.x);
  }
}

// Blocks of wave_epoch_kernel that can be resident at once on the current
// device (occupancy x SMs), queried once per device; 0 on an error.
int co_resident_blocks() {
  static int cache[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (cache[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wave_epoch_kernel, kThreads,
                                                      0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    cache[dev] = per_sm * sms;
  }
  return cache[dev];
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

// One cooperative launch for every step of an epoch. steps holds the
// n_steps + 1 offsets into desc, then one direct flag per step; s_max is
// the widest step (scratch holds s_max rows). Returns the launch's CUDA
// error (0 on success; cudaErrorCooperativeLaunchTooLarge and the like are
// returned, never worked around), or -1 when the co-resident count cannot
// be queried.
extern "C" int acs_wave_epoch(float* slab, int rows, int d, const int* desc,
                              const int* steps, int n_steps, int s_max,
                              const int* branch_ops, int n_branches, float* scratch,
                              int* err, unsigned int* arrivals, void* stream) {
  if (n_steps == 0 || s_max == 0 || d == 0) return 0;
  const int resident = co_resident_blocks();
  if (resident < 1) return -1;
  EpochParams p{slab, rows, d, desc, steps, n_steps, branch_ops, n_branches, scratch, err,
                arrivals, (d + kChunk - 1) / kChunk};
  const long long widest = static_cast<long long>(s_max) * p.chunks;
  const int grid = static_cast<int>(widest < resident ? widest : resident);
  void* args[] = {&p};
  cudaError_t rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(wave_epoch_kernel), dim3(grid), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) {
    cudaGetLastError();  // clear the launch error so later launches are not blamed
    return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}
