// Device-resident ready-queue epoch executor — the ACS-HW path on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/ready_queue.py::_ready_queue_kernel
// (a Pallas program with grid=(1,) whose fori_loop pops exactly n tasks).
//
// What it computes: one epoch of the window's ready queue. Each task row
// (branch, in0, in1, in2, out_row) applies the branch's opcode elementwise
// to slab rows in0 and in1 and writes the out row; a task runs once every
// upstream in dep_tbl has retired; retiring sets done[t] and decrements
// each dependent's counter. The slab and done are the same bits whatever
// the order, because dep_tbl holds every RAW, WAR and WAW edge.
//
// Contract (the plain version kernels/ref.py::ready_queue_ref keeps it too):
// * Validate first. Every task's branch id and opcode, and its in0, in1 and
//   out rows, are in range (in2 is read by no opcode and not checked);
//   every live edge points forward (t < dep < n; dep == n is the sentinel);
//   the in-degrees counted from dep_tbl equal rem0[:n]; ring0[:tail0] lists
//   each task whose rem0 is 0 exactly once, and nothing else. If any check
//   fails, no task runs: the slab comes back unchanged, done is all 0 and
//   ring equals ring0, and the caller raises its stall error. Tables that
//   pass provably drain, so no spin-wait below can hang.
// * ring[:n] comes back as the order in which tasks started: a permutation
//   of 0..n-1 and a topological order of dep_tbl, not fixed from run to
//   run. ring[n] keeps ring0[n] (the lowering's pad, n).
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor cores):
// each input read once and each output written once, the chain universe
// ([128, 4096] f32 slab, 2,048 tasks) moves ~4.7 MB, 1.35 us. The kernel is
// bound by neither: by its critical path, one hop (row, fence, counter,
// claim) per dependent task, as a chain of 32 tasks takes 32 hops.
//
// Design: a persistent, co-resident grid (cooperative launch, one block of
// 512 threads an SM) of blocks that each run whole tasks.
// * Pre-pass: the blocks check the tables in parallel (grid-strided task
//   rows and edges; in-degrees counted with atomics into scratch; ring0's
//   entries marked seen), pass a grid barrier, compare the counts with
//   rem0 and tail0, pass a second barrier, and all return if any block
//   found a fault. The counted in-degrees are then the working counters.
// * Claim: a block's first thread takes the next slot of one device-wide
//   ring (atomicAdd on a head counter). Slots below tail0 hold ring0's
//   tasks; a later slot is spun on with acquire loads and __nanosleep
//   backoff until a retiring block publishes a task there. The spin ends
//   when a finished counter reaches n, never on the claim index, so a
//   claim past the last pushed slot cannot hang.
// * Run: all threads compute the out row with 16-byte ld.global.cg loads
//   (a row another SM wrote in this launch must not come from a stale L1
//   line) and stores; at d = 4096 and 512 threads, two float4 a thread.
// * Retire: __syncthreads, then warp 0 fences (the row's stores before any
//   counter update) and retires the task: lane j takes dep_tbl[t, j] (32
//   columns a round) and does one atomicSub on its dependent's counter;
//   the old value 1 marks the last upstream, which exactly one lane sees.
//   __ballot_sync gathers the zero-crossings, one atomicAdd on the tail
//   reserves their slots, and each is published with st.release. With
//   kWorkFirst, the block keeps the first task it woke and runs it next,
//   with no ring round trip; it pushes the rest.
// * Measured on an H100 80GB HBM3 at 700 W (kernels/scan_epoch_times.py,
//   torch.profiler): the chain universe 0.091 ms of device time, one
//   32-deep chain 0.086-0.090 ms and one task 0.008 ms, so a hop of about
//   2.5 us and 64 chains in 1.01-1.06 times one chain's time; the first,
//   one-block design took 8.5 ms for the universe (64 chains one after
//   another). Work-first saves ~15 %, 512 threads ~12 % over 256; grids of
//   66 and 132 blocks time alike, 264 ~6 % slower; the backoff is within
//   noise. 32 registers.
//
// Rounding: each opcode is written with __fmaf_rn / __fadd_rn and the file
// is built with -fmad=false: the multiply-add rounds once, as the
// reference's XLA-compiled kernels contract it, and the rest as written, so
// every step rounds as kernels/ops.py's branches do and the slab is
// bit-equal to the serial baseline.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "grid_barrier.cuh"

namespace {

// The launch shape, from the sweep on an H100 (kernels/scan_epoch_times.py
// --sweep builds copies of this file with these four lines changed):
// threads a block; the grid (0: one block an SM, at most the co-resident
// count and n); whether a block runs the first task it woke itself; the
// spin's longest __nanosleep.
constexpr int kThreads = 512;
constexpr int kGrid = 0;
constexpr bool kWorkFirst = true;
constexpr int kSleepNs = 256;
constexpr int kMaxDevices = 64;

// Opcodes: kernels/ops.py LOOP_OPCODES.
constexpr int OP_AXPY = 0;  // 1.5 * x + y + 1
constexpr int OP_MUL = 1;   // x * y - 0.5

// The scratch words, zeroed by the wrapper on the stream: these counters
// (kGridSize and kBlocksRan, the launch's grid and the blocks that ran a
// task, are for the wrapper's launch_stats), then the counted in-degrees
// [n], the seen marks [n] and the ring [n] (slot i holds task + 1 once
// pushed, 0 before).
constexpr int kHead = 0, kTail = 1, kFinished = 2, kStarted = 3, kBad = 4, kArrivals = 5,
              kBlocksRan = 6, kZeros = 7, kGridSize = 8, kHeader = 10;

struct QueueParams {
  float* slab;  // [rows, d], the output (a copy of the input slab)
  int rows, d;
  const int* task_tbl;  // [n, 5]
  const int* dep_tbl;   // [n, m]
  int n, m;
  const int* branch_ops;  // [n_branches]
  int n_branches;
  const int* ring0;  // [n + 1]
  const int* rem0;   // [n + 1]
  const int* tail0;  // [1]
  int* ring;         // [n + 1] out
  int* done;         // [n] out
  int* scratch;      // [kHeader + 3 n], zeroed
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ bool known_op(int op) { return op == OP_AXPY || op == OP_MUL; }

// The task of the next ring slot, or -1 once every task has retired.
// Called by one thread of the block.
__device__ __forceinline__ int claim(int* s, const int* slots, const int* ring0, int n,
                                     int tail0) {
  const int i = atomicAdd(s + kHead, 1);
  if (i < tail0) return __ldg(ring0 + i);
  int nap = 0;
  while (true) {
    if (i < n) {
      const int v = ld_acquire(slots + i);
      if (v != 0) return v - 1;
    }
    if (ld_acquire(s + kFinished) >= n) return -1;
    if (nap > 0) __nanosleep(nap);
    nap = min(max(2 * nap, 32), kSleepNs);
  }
}

__device__ __forceinline__ float apply(int op, float a, float b) {
  return op == OP_AXPY ? __fadd_rn(__fmaf_rn(1.5f, a, b), 1.0f) : __fmaf_rn(a, b, -0.5f);
}

__device__ __forceinline__ float4 apply4(int op, float4 a, float4 b) {
  return make_float4(apply(op, a.x, b.x), apply(op, a.y, b.y), apply(op, a.z, b.z),
                     apply(op, a.w, b.w));
}

__global__ void __launch_bounds__(kThreads) ready_queue_kernel(const QueueParams p) {
  __shared__ int s_task;
  int* s = p.scratch;
  int* counts = s + kHeader;  // counted in-degrees, then the working counters
  int* seen = counts + p.n;
  int* slots = seen + p.n;  // the ring of pushed tasks
  const int n = p.n, m = p.m;
  const int tail0 = __ldg(p.tail0);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (first == 0) s[kGridSize] = gridDim.x;

  // Pre-pass 1: task rows, edges, ring0; in-degree counts.
  bool bad = tail0 < 0 || tail0 > n;
  for (long long t = first; t < n; t += stride) {
    const int* task = p.task_tbl + 5 * t;
    const int b = __ldg(task);
    const int op = (b >= 0 && b < p.n_branches) ? __ldg(p.branch_ops + b) : -1;
    const int in0 = __ldg(task + 1), in1 = __ldg(task + 2), out = __ldg(task + 4);
    bad |= !known_op(op) || in0 < 0 || in0 >= p.rows || in1 < 0 || in1 >= p.rows || out < 0 ||
           out >= p.rows;
    if (__ldg(p.rem0 + t) == 0) atomicAdd(s + kZeros, 1);
    p.done[t] = 0;
  }
  for (long long i = first; i <= n; i += stride) p.ring[i] = __ldg(p.ring0 + i);
  for (long long e = first; e < (long long)n * m; e += stride) {
    const int dep = __ldg(p.dep_tbl + e);
    if (dep == n) continue;  // the sentinel
    if (dep <= e / m || dep > n) {
      bad = true;
    } else {
      atomicAdd(counts + dep, 1);
    }
  }
  if (tail0 >= 0 && tail0 <= n) {
    for (long long i = first; i < tail0; i += stride) {
      const int t = __ldg(p.ring0 + i);
      bad |= t < 0 || t >= n || atomicAdd(seen + t, 1) != 0 || __ldg(p.rem0 + t) != 0;
    }
  }
  if (bad) atomicExch(s + kBad, 1);
  grid_barrier(reinterpret_cast<unsigned int*>(s + kArrivals), gridDim.x);

  // Pre-pass 2: the counts against rem0 and tail0.
  bad = first == 0 && __ldcg(s + kZeros) != tail0;
  for (long long t = first; t < n; t += stride) bad |= __ldcg(counts + t) != __ldg(p.rem0 + t);
  if (bad) atomicExch(s + kBad, 1);
  grid_barrier(reinterpret_cast<unsigned int*>(s + kArrivals), 2 * gridDim.x);
  if (__ldcg(s + kBad) != 0) return;  // every block reads the same flag

  // The queue.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool vec = (p.d % 4) == 0 && (reinterpret_cast<uintptr_t>(p.slab) % 16) == 0;
  int own = -1;  // (thread 0) a task this block woke and runs next (kWorkFirst)
  int ran = 0;   // (thread 0) tasks this block ran
  while (true) {
    int pos = 0;  // (thread 0) the task's place in the start order
    if (threadIdx.x == 0) {
      const int t = own >= 0 ? own : claim(s, slots, p.ring0, n, tail0);
      own = -1;
      if (t >= 0) {
        pos = atomicAdd(s + kStarted, 1);  // read after the row: its latency is hidden
        ++ran;
      }
      s_task = t;
    }
    __syncthreads();
    const int t = s_task;
    if (t < 0) break;

    const int* task = p.task_tbl + 5 * (size_t)t;
    const int op = __ldg(p.branch_ops + __ldg(task));
    const float* x = p.slab + (size_t)__ldg(task + 1) * p.d;
    const float* y = p.slab + (size_t)__ldg(task + 2) * p.d;
    float* out = p.slab + (size_t)__ldg(task + 4) * p.d;
    // out may alias x or y: each element is read, then written, by one thread.
    if (vec) {
      for (int e = threadIdx.x; e < p.d / 4; e += blockDim.x) {
        __stcg(reinterpret_cast<float4*>(out) + e,
               apply4(op, __ldcg(reinterpret_cast<const float4*>(x) + e),
                      __ldcg(reinterpret_cast<const float4*>(y) + e)));
      }
    } else {
      for (int e = threadIdx.x; e < p.d; e += blockDim.x) {
        __stcg(out + e, apply(op, __ldcg(x + e), __ldcg(y + e)));
      }
    }
    if (threadIdx.x == 0) p.ring[pos] = t;
    __syncthreads();  // the row is written, and s_task read, by every thread

    if (warp == 0) {
      __threadfence();  // the row's stores before any counter update
      if (lane == 0) p.done[t] = 1;
      const int* deps = p.dep_tbl + (size_t)t * m;
      int keep = -1;
      for (int j0 = 0; j0 < m; j0 += 32) {
        const int dep = j0 + lane < m ? __ldg(deps + j0 + lane) : n;
        const bool woke = dep < n && atomicSub(counts + dep, 1) == 1;
        unsigned int mask = __ballot_sync(0xffffffffu, woke);
        if (mask == 0) continue;
        if (kWorkFirst && keep < 0) {
          keep = __shfl_sync(0xffffffffu, dep, __ffs(mask) - 1);
          mask &= mask - 1;
        }
        if (mask == 0) continue;
        int base = 0;
        if (lane == 0) base = atomicAdd(s + kTail, __popc(mask));
        base = tail0 + __shfl_sync(0xffffffffu, base, 0);
        if (mask & (1u << lane)) {
          st_release(slots + base + __popc(mask & ((1u << lane) - 1)), dep + 1);
        }
      }
      if (keep >= 0) __threadfence();  // the woken task's rows, read after the other upstreams'
      if (lane == 0) {
        own = keep;
        atomicAdd(s + kFinished, 1);
      }
    }
  }
  if (threadIdx.x == 0 && ran > 0) atomicAdd(s + kBlocksRan, 1);
}

// The grid: kGrid, or one block an SM, capped at the blocks that can be
// co-resident (occupancy x SMs, queried once per device) and at n; 0 when
// the device cannot be queried.
int grid_for(int n) {
  static int cache[kMaxDevices][2] = {};  // SMs, co-resident blocks
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  int* c = cache[dev];
  if (c[1] == 0) {
    int per_sm = 0;
    if (cudaDeviceGetAttribute(&c[0], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ready_queue_kernel, kThreads,
                                                      0) != cudaSuccess)
      return 0;
    c[1] = per_sm * c[0];
  }
  return std::min({kGrid > 0 ? kGrid : c[0], c[1], n});
}

}  // namespace

// One epoch in one cooperative launch on `stream`. scratch holds
// kHeader + 3 n zeroed int32 words. Returns the launch's CUDA error (0 on
// success; a refused cooperative launch is returned, never worked
// around), or -1 when the device cannot be queried for the grid.
extern "C" int acs_ready_queue(float* slab, int rows, int d, const int* task_tbl,
                               const int* dep_tbl, int n, int m, const int* branch_ops,
                               int n_branches, const int* ring0, const int* rem0,
                               const int* tail0, int* ring, int* done, int* scratch,
                               void* stream) {
  if (n == 0) return 0;
  const int grid = grid_for(n);
  if (grid < 1) return -1;
  QueueParams p{slab,       rows,  d,    task_tbl, dep_tbl, n,   m,      branch_ops,
                n_branches, ring0, rem0, tail0,    ring,    done, scratch};
  void* args[] = {&p};
  cudaError_t rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(ready_queue_kernel), dim3(grid), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) {
    cudaGetLastError();  // clear the launch error so later launches are not blamed
    return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}
