// Mamba's selective scan on Hopper (sm_90a), alone or fused with the
// Mamba layer's neighbours.
//
// Replaces: no pallas_call. The reference runs the recurrence of
// src/repro/models/recurrent.py apply_mamba as jax.lax.scan over a step
// function; eagerly on the card that loop costs about 7 launches a step
// and layer. For each batch row, channel e and step t, over N <= 16 states:
//
//   da  = exp(dt_t[e] * a[e, n])
//   h   = da * h + (dt_t[e] * x_t[e]) * b_t[n]
//   y_t = sum over n of h[e, n] * c_t[n]
//
// Two entries share one kernel template:
// * plain (acs_mamba_scan variant 0): dt, x [B, S, E], b, c [B, S, N],
//   a [E, N], h0 [B, E, N], all float32; it writes ys [B, S, E] and
//   hT [B, E, N];
// * fused (variants 1-3: float32, bfloat16, float16 inputs): the span of
//   apply_mamba from the dt projection's output to the gated output, in
//   one launch. dt = softplus(dt_raw + dt_bias) (torch's threshold of 20),
//   a = -exp(A_log), the scan, then y = (ys + D * x) * silu(z) cast to the
//   model dtype. dt_raw, x, z, b and c are read in the model dtype through
//   their batch and row strides (z, b and c are slices of wider
//   projections); dt_bias, A_log, D, h0 and hT are float32.
//
// Bound on this card, at falcon-mamba-7b's prefill [1, 512, 8192], N = 16,
// plain float32: the bytes are dt, x and ys (16.8 MB each) and b, c, a, h0
// and hT (under 1.1 MB): 51.4 MB, 0.0153 ms at 3.35 TB/s. The arithmetic
// is B*S*E*N = 67.1 M exponentials and 6 float operations beside each
// (0.0061 ms at 67 TFLOP/s). An exponential is one MUFU.EX2 on the
// special-function units, 16 results a clock on each of the 132 SMs: at
// 1.98 GHz, 4.18 T a second, so the 67.1 M take 0.0161 ms. The
// exponentials bind, just above the bytes.
//
// Design (the first design, four lanes a channel each running the whole
// sequence in time order, filled 8 warps an SM at falcon's 8,192 channels
// and took 0.162 ms, 10x its bound):
// * Parallel in time. A block of 512 threads owns C channels of one batch
//   row and walks the sequence in chunks of T = P * L steps. Each channel
//   has P lanes of one warp (P a power of two, 1..16, from S; a template
//   parameter, so the scan unrolls); lane j owns the L = 4 consecutive
//   steps j*L .. j*L+3 of the chunk (L = 1 at S = 1, a decode step, in
//   blocks of 64 threads). C = 512 / P, so a [T, C] tile is 2,048
//   elements. Falcon at S = 512 and S = 128: P = 16, T = 64, C = 32, 256
//   blocks of 16 warps, two an SM: 32 warps an SM (64 registers, 45.5 KB
//   of shared memory in float32, 37.4 KB in bf16).
// * The N states loop inside the thread, two at a time so their chains and
//   shuffles interleave. For each state a lane computes its steps' decays
//   and inputs (dt * x) * b once and keeps them in registers, with the pair
//   (A, B) of its segment: h_end = A * h_start + B. The channel's first
//   lane folds in the carry from the previous chunk; a Kogge-Stone scan
//   over the P lanes with warp shuffles combines (A1, B1) then (A2, B2)
//   into (A1 * A2, A2 * B1 + B2), so each lane gets its segment's true
//   start state; it replays its L steps from there in time order and adds
//   h * c into its y registers, in state order. The serial chain is L steps
//   and log2 P combines, not S steps, and y needs no reduction across
//   lanes. The last lane's final h is the next chunk's carry (shared
//   memory), and after the last chunk hT. No atomics: a row's results
//   depend on S alone, not on B or the other rows.
// * Coalesced staging. The layout is [B, S, E] with channels contiguous,
//   so dt and x (dt_raw and x) stream through a 2-stage ring of [T, C]
//   tiles filled by 16-byte cp.async copies (csrc/sm90_tiles.cuh
//   cp_async16; element loads where a row is not 16-byte aligned), chunk
//   k + 1 in flight while chunk k is scanned. The tile's 16-byte chunks are
//   XOR-swizzled by the row's segment (tile_pos), so the lanes of a
//   channel, which read one column at rows L apart, spread over the bank
//   groups. b and c are staged transposed, [N, T], a lane's 4 steps of a
//   state in one 16-byte read; the next chunk's b and c (and, fused, this
//   chunk's z and D) are loaded into registers while the chunk's y leaves.
// * The chunk's y goes back through the dt tile and leaves as whole rows:
//   the fused epilogue adds D * x (x from the tile), multiplies by
//   silu(z) = z / (1 + exp(-z)) and rounds to the model dtype there.
// * Rounding: each product and sum rounds to float32 on its own (the file
//   is built with -fmad=false); softplus's expf and log1pf, -exp(A_log),
//   silu's expf and the division are the CUDA math library's, as torch's
//   eager kernels. The state loop's decay is ex2.approx (within 2 ulp of
//   exp) of dt * (a * log2 e): the accurate expf was the loop's largest
//   part (8 of ~28 instructions a state and step), and the loop's time
//   follows its instruction count.
//   Within a segment the steps run in the plain version's order; the carry
//   into a segment comes from the combine and y sums its N terms in state
//   order, so the kernel is held to its plain versions (kernels/ref.py
//   selective_scan_ref, mamba_scan_ref) within 1e-5 (abs and rel), not bit
//   for bit.
// * Any B, S, E and N from 1 to 16 with no padding copy: the last chunk and
//   channel tile are masked (a masked step has dt = 0: decay 1, input 0).
//
// What binds it: the state loop issues about 20 instructions a state and
// step (chip_smoke.py counts them from the SASS) against one exponential
// on the SFUs, which take 8 of a scheduler's clocks for a warp's 32, so
// instruction issue, not the SFUs or the bytes, is the limit; the kernel
// issues at about 60 % of the schedulers' peak, and which stall holds the
// rest is not measured. On an H100 80GB HBM3 at 700 W (chip_smoke.py):
// falcon's prefill, the scan alone in float32, 0.072 ms of device (the
// first design 0.162), the fused bf16 entry 0.093-0.097, S = 128 0.025; a
// decode launch 0.005 (0.05-0.07 ms single with the host path).

// The backward (acs_mamba_scan_bwd, the training path's; the reference
// trains through XLA's derivative of its lax.scan) is mamba_scan_bwd_kernel
// below, with its reduction: the adjoint of the recurrence is a linear
// recurrence in reverse time, so it runs the forward's layout backwards,
// chunk by chunk from the last, recomputing each chunk's states from the
// carry-in the forward saved under grad. Bound on this card at
// falcon-mamba-7b's training shape [4, 512, 8192], N 16, bf16: the bytes
// (dt_raw, x, z, dy read and d dt_raw, dx, dz written, 33.5 MB each; b, c,
// db, dc; the saved states 14.7 MB) ~255 MB, 0.076 ms, against the
// recompute's 268 M exponentials, 0.064 ms: the bytes, just above. What
// binds it is instruction issue: a forward replay, a reverse scan and the
// per-step products of eight gradients, 55 SASS instructions a state and
// step in its state loop (0.44 ms at full issue on 132 SMs), on one
// 16-warp block an SM (128 registers). The first design also summed db and
// dc across its warps behind a barrier a state pair (80 barriers a block,
// 77 instructions a state and step) and waited on each chunk's loads; on
// an H100 80GB HBM3 at 700 W (kernels/bwd_times.py) it took 1.29 ms of
// device time, this one 0.94 (the reduction 0.047 of each).

#include "sm90_tiles.cuh"

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

using namespace sm90;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;       // a block, S > 1
constexpr int kDecodeThreads = 64;  // a block, S = 1: 128 blocks at E = 8192
constexpr int kMaxN = 16;
constexpr int kSeg = 4;           // steps a lane owns in a chunk (S > 1)
constexpr int kMaxLanesLog2 = 4;  // up to 16 lanes a channel: chunks of 64 steps
constexpr int kMaxDevices = 64;
// The backward's chunk: 16 lanes a channel of 4 steps each, the forward's
// chunk at S > 32, whose carry-in states the forward saves under grad.
constexpr int kBwdLanes = 16;
constexpr int kBwdSteps = kBwdLanes * kSeg;
constexpr int kBwdChans = kThreads / kBwdLanes;  // 32 channels a block

struct Params {
  const void* dt;        // [B, S, E]: dt (plain, float32) or dt_raw (fused, T)
  const void* x;         // [B, S, E] T
  const void* z;         // [B, S, E] T (fused)
  const void* b;         // [B, S, N] T
  const void* c;         // [B, S, N] T
  const float* a;        // [E, N]: a (plain) or A_log (fused)
  const float* dt_bias;  // [E] (fused)
  const float* d;        // [E] (fused)
  const float* h0;       // [B, E, N]
  void* y;               // [B, S, E]: ys float32 (plain) or the gated output in T (fused)
  float* ht;             // [B, E, N]
  // Batch and row strides in elements; the last dimension is unit-stride.
  long long sb_dt, ss_dt, sb_x, ss_x, sb_z, ss_z, sb_b, ss_b, sb_c, ss_c;
  int seq, ch, n;
  int vec_dt, vec_x;   // 16-byte copies allowed for the dt and x tiles
  // Under grad (null otherwise): each 64-step chunk's carry-in state h for
  // chunks 1 .. nt - 1, [B, nt - 1, E, N], what the backward recomputes a
  // chunk from (chunk 0 starts from h0).
  float* states;
};

// The row stride of transposed b and c ([n][step]) for a chunk of
// `steps`: 16-byte rows, padded by 4 words so the transposing stores of
// one step's n values spread over the banks.
__host__ __device__ constexpr int bc_stride(int steps) { return ((steps + 3) & ~3) + 4; }

// Shared memory of one block, in bytes from the base: two stages of the dt
// tile (float32-sized, as the chunk's y reuses it) and of the x tile, then
// b and c transposed ([n][ldb]), the carry h and the decays a ([C][n]).
struct Layout {
  int threads, lanes, steps, chans, ldb;
  size_t dt_stage, x_stage, off_x, off_b, off_c, off_h, off_a, bytes;
};

__host__ __device__ inline Layout layout(int seg, int lanes_log2, int n, int elem) {
  Layout o;
  o.threads = seg == 1 ? kDecodeThreads : kThreads;
  o.lanes = 1 << lanes_log2;
  o.steps = o.lanes * seg;
  o.chans = o.threads >> lanes_log2;
  o.ldb = bc_stride(o.steps);
  const size_t tile = static_cast<size_t>(o.threads) * seg;  // steps * chans
  o.dt_stage = tile * 4;
  o.x_stage = tile * elem;
  o.off_x = 2 * o.dt_stage;
  o.off_b = o.off_x + 2 * o.x_stage;
  o.off_c = o.off_b + static_cast<size_t>(n) * o.ldb * 4;
  o.off_h = o.off_c + static_cast<size_t>(n) * o.ldb * 4;
  o.off_a = o.off_h + static_cast<size_t>(o.chans) * n * 4;
  o.bytes = o.off_a + static_cast<size_t>(o.chans) * n * 4;
  return o;
}

// Element (t, c) of a [steps, chans] tile: 16-byte chunk (t, c / kq) goes
// to chunk slot (t * chans / kq + c / kq) XOR (t's segment mod 8), so the
// lanes of a channel, reading one column at rows L apart, spread over the
// eight 16-byte bank groups (at most 2-way conflicts at 16 lanes a
// channel). A segment's rows are whole groups of 8 slots, so the XOR
// stays inside them and the map is one-to-one.
template <typename E>
__device__ __forceinline__ int tile_pos(int t, int c, int chans, int seg_log2) {
  constexpr int kq = 16 / static_cast<int>(sizeof(E));
  return (((t * (chans / kq) + c / kq) ^ ((t >> seg_log2) & 7)) * kq) + (c % kq);
}

// dst (a [steps, chans] tile) from src rows r < r_lim, columns c < c_lim
// (row stride ld), 0 elsewhere: 16-byte cp.async copies when vec (c_lim, ld
// and src in whole 16-byte chunks), else element loads.
template <typename E, int kThr>
__device__ __forceinline__ void stage_tile(E* dst, const E* src, long long ld, int steps,
                                           int r_lim, int chans, int c_lim, int seg_log2,
                                           bool vec) {
  constexpr int kq = 16 / static_cast<int>(sizeof(E));
  if (vec) {
    const int nq = chans / kq;
    for (int i = threadIdx.x; i < steps * nq; i += kThr) {
      const int r = i / nq;
      const int c = (i - r * nq) * kq;
      const bool ok = r < r_lim && c < c_lim;
      cp_async16(dst + tile_pos<E>(r, c, chans, seg_log2), ok ? src + r * ld + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < steps * chans; i += kThr) {
      const int r = i / chans;
      const int c = i - r * chans;
      dst[tile_pos<E>(r, c, chans, seg_log2)] =
          (r < r_lim && c < c_lim) ? src[r * ld + c] : from_f<E>(0.0f);
    }
  }
}

// A lane's L values of one transposed b or c row, from its segment's
// first step: one 16-byte read for L = 4 (eight lanes read 128 contiguous
// bytes: no bank conflict).
template <int L>
__device__ __forceinline__ void load_seg(float (&v)[L], const float* seg) {
  if constexpr (L == 4) {
    const float4 q = *reinterpret_cast<const float4*>(seg);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    static_assert(L == 1, "a lane owns 1 or 4 steps");
    v[0] = seg[0];
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^v in one MUFU.EX2 (ex2.approx: within 2 ulp): the state loop's decay
// exp(dt * a) as 2^(dt * (a * log2 e)), the rates stored pre-scaled.
__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// torch.nn.functional.softplus with beta 1 and threshold 20.
__device__ __forceinline__ float softplus(float v) { return v > 20.0f ? v : log1pf(expf(v)); }

template <typename T, bool kFused, int L, int kLanesLog2>
__global__ void __launch_bounds__(L == 1 ? kDecodeThreads : kThreads, L > 1 ? 2 : 1)
    mamba_scan_kernel(const Params p) {
  static_assert(L == 1 || L == kSeg, "a lane owns 1 or 4 steps of a chunk");
  static_assert(kLanesLog2 <= kMaxLanesLog2 && (L > 1 || kLanesLog2 == 0), "lanes a channel");
  constexpr int kLanes = 1 << kLanesLog2;
  constexpr int kSegLog2 = L == 1 ? 0 : 2;
  constexpr int kThr = L == 1 ? kDecodeThreads : kThreads;
  // b and c elements a thread stages a chunk: steps * n <= kBc * kThr.
  constexpr int kBc = L == 1 ? 1 : (kSeg << kMaxLanesLog2) * kMaxN / kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(L, kLanesLog2, p.n, sizeof(T));
  const int n = p.n;
  constexpr int steps = kLanes * L;         // a chunk
  constexpr int chans = kThr >> kLanesLog2;  // a block
  constexpr int ldb = bc_stride(steps);
  float* s_b = reinterpret_cast<float*>(smem + lay.off_b);
  float* s_c = reinterpret_cast<float*>(smem + lay.off_c);
  float* s_h = reinterpret_cast<float*>(smem + lay.off_h);
  float* s_a = reinterpret_cast<float*>(smem + lay.off_a);

  const int tiles_c = (p.ch + chans - 1) / chans;
  const int bi = blockIdx.x / tiles_c;
  const int c0 = (blockIdx.x - bi * tiles_c) * chans;
  const int c_lim = min(chans, p.ch - c0);
  const int nt = (p.seq + steps - 1) / steps;

  const T* dt_src = static_cast<const T*>(p.dt) + bi * p.sb_dt + c0;
  const T* x_src = static_cast<const T*>(p.x) + bi * p.sb_x + c0;
  const T* b_src = static_cast<const T*>(p.b) + bi * p.sb_b;
  const T* c_src = static_cast<const T*>(p.c) + bi * p.sb_c;
  const T* z_src = kFused ? static_cast<const T*>(p.z) + bi * p.sb_z + c0 : nullptr;

  auto dt_tile = [&](int st) { return reinterpret_cast<T*>(smem + st * lay.dt_stage); };
  auto y_tile = [&](int st) { return reinterpret_cast<float*>(smem + st * lay.dt_stage); };
  auto x_tile = [&](int st) { return reinterpret_cast<T*>(smem + lay.off_x + st * lay.x_stage); };
  auto rows_of = [&](int k) { return min(steps, p.seq - k * steps); };
  // dt and x of chunk k into stage k & 1 (cp.async).
  auto load = [&](int k) {
    const int st = k & 1;
    const long long t0 = static_cast<long long>(k) * steps;
    stage_tile<T, kThr>(dt_tile(st), dt_src + t0 * p.ss_dt, p.ss_dt, steps, rows_of(k), chans,
                        c_lim, kSegLog2, p.vec_dt);
    stage_tile<T, kThr>(x_tile(st), x_src + t0 * p.ss_x, p.ss_x, steps, rows_of(k), chans,
                        c_lim, kSegLog2, p.vec_x);
  };
  // b and c of chunk k into registers (in flight while the block works)...
  auto bc_fetch = [&](int k, float (&bv)[kBc], float (&cv)[kBc]) {
    const int rows = rows_of(k);
#pragma unroll
    for (int u = 0; u < kBc; ++u) {
      const int i = threadIdx.x + u * kThr;
      const int r = i / n;
      const long long t = static_cast<long long>(k) * steps + r;
      const bool ok = i < steps * n && r < rows;
      bv[u] = ok ? to_f(b_src[t * p.ss_b + (i - r * n)]) : 0.0f;
      cv[u] = ok ? to_f(c_src[t * p.ss_c + (i - r * n)]) : 0.0f;
    }
  };
  // ... then transposed to [n][step] in shared memory.
  auto bc_store = [&](const float (&bv)[kBc], const float (&cv)[kBc]) {
#pragma unroll
    for (int u = 0; u < kBc; ++u) {
      const int i = threadIdx.x + u * kThr;
      const int r = i / n;
      if (i < steps * n) {
        s_b[(i - r * n) * ldb + r] = bv[u];
        s_c[(i - r * n) * ldb + r] = cv[u];
      }
    }
  };
  // The gate z and skip weight D of this thread's L output elements of
  // chunk k (element u is tile element threadIdx.x + u * kThr).
  auto zd_fetch = [&](int k, float (&zv)[L], float (&dv)[L]) {
    const int rows = rows_of(k);
#pragma unroll
    for (int u = 0; u < L; ++u) {
      const int i = threadIdx.x + u * kThr;
      const int r = i / chans;
      const int cc = i - r * chans;
      const bool ok = r < rows && cc < c_lim;
      const long long t = static_cast<long long>(k) * steps + r;
      zv[u] = ok ? to_f(z_src[t * p.ss_z + cc]) : 0.0f;
      dv[u] = ok ? p.d[c0 + cc] : 0.0f;
    }
  };

  load(0);
  cp_async_commit();
  float zv[L], dv[L];  // the fused epilogue's z and D (a decode step's fetched now)
  if constexpr (kFused && L == 1) zd_fetch(0, zv, dv);
  {
    float bv[kBc], cv[kBc];
    bc_fetch(0, bv, cv);
    // The block's channels: the initial state and the decay rates, all of
    // a thread's loads in flight at once (kPro of them).
    constexpr int kPro = L == 1 ? kMaxN : 8;
    const int hn = c_lim * n;
    const float* h0_src = p.h0 + (static_cast<size_t>(bi) * p.ch + c0) * n;
    const float* a_src = p.a + static_cast<size_t>(c0) * n;
    for (int i0 = threadIdx.x; i0 < chans * n; i0 += kPro * kThr) {
      float hv[kPro], av[kPro];
#pragma unroll
      for (int u = 0; u < kPro; ++u) {
        const int i = i0 + u * kThr;
        hv[u] = i < hn ? h0_src[i] : 0.0f;
        av[u] = i < hn ? a_src[i] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kPro; ++u) {
        const int i = i0 + u * kThr;
        if (i < chans * n) {
          s_h[i] = hv[u];
          const float a = (kFused && i < hn) ? -expf(av[u]) : av[u];
          s_a[i] = __fmul_rn(a, kLog2e);
        }
      }
    }
    bc_store(bv, cv);
  }

  const int j = threadIdx.x & (kLanes - 1);  // this lane's segment of the chunk
  const int cl = threadIdx.x >> kLanesLog2;  // its channel in the block
  const bool live = cl < c_lim;
  const float bias = (kFused && live) ? p.dt_bias[c0 + cl] : 0.0f;
  const int t_seg = j * L;

  for (int k = 0; k < nt; ++k) {
    const int st = k & 1;
    const int rows = rows_of(k);
    cp_async_wait<0>();
    // Tile k, b and c of chunk k (and h and a) are in shared memory; every
    // thread is done with chunk k - 1, so stage (k + 1) & 1 is free.
    __syncthreads();
    if (k + 1 < nt) load(k + 1);  // in flight while chunk k is scanned
    cp_async_commit();

    const T* tdt = dt_tile(st);
    const T* tx = x_tile(st);
    float dtv[L], dx[L], y[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const int t = t_seg + i;
      float v = to_f(tdt[tile_pos<T>(t, cl, chans, kSegLog2)]);
      if constexpr (kFused) v = (live && t < rows) ? softplus(__fadd_rn(v, bias)) : 0.0f;
      dtv[i] = v;
      dx[i] = __fmul_rn(v, to_f(tx[tile_pos<T>(t, cl, chans, kSegLog2)]));
      y[i] = 0.0f;
    }

    // kS states at once (two, so their chains and shuffles interleave; one
    // for an odd last state), from state nn.
    const float* a_row = s_a + cl * n;
    float* h_row = s_h + cl * n;
    auto states = [&](auto ks, int nn) {
      constexpr int kS = decltype(ks)::value;
      float da[kS][L], bx[kS][L], A[kS], B[kS], hc[kS];
#pragma unroll
      for (int q = 0; q < kS; ++q) {
        const float an = a_row[nn + q];
        float bv[L];
        load_seg<L>(bv, s_b + (nn + q) * ldb + t_seg);
        // This segment from a zero start: h_end = A * h_start + B.
#pragma unroll
        for (int i = 0; i < L; ++i) {
          da[q][i] = exp2_approx(__fmul_rn(dtv[i], an));
          bx[q][i] = __fmul_rn(dx[i], bv[i]);
          if (i == 0) {
            A[q] = da[q][0];
            B[q] = bx[q][0];
          } else {
            B[q] = __fadd_rn(__fmul_rn(da[q][i], B[q]), bx[q][i]);
            A[q] = __fmul_rn(A[q], da[q][i]);
          }
        }
        hc[q] = h_row[nn + q];  // the carry into the chunk
        if (j == 0) B[q] = __fadd_rn(__fmul_rn(A[q], hc[q]), B[q]);
        if constexpr (steps == kBwdSteps) {
          if (p.states != nullptr && k > 0 && j == 0 && live)
            p.states[((static_cast<size_t>(bi) * (nt - 1) + k - 1) * p.ch + c0 + cl) * n + nn +
                     q] = hc[q];
        }
      }
      // Inclusive scan over the channel's lanes: B becomes the true state at
      // the end of this lane's segment.
#pragma unroll
      for (int d = 1; d < kLanes; d <<= 1) {
#pragma unroll
        for (int q = 0; q < kS; ++q) {
          const float a_up = __shfl_up_sync(kFull, A[q], d, kLanes);
          const float b_up = __shfl_up_sync(kFull, B[q], d, kLanes);
          if (j >= d) {
            B[q] = __fadd_rn(__fmul_rn(A[q], b_up), B[q]);
            A[q] = __fmul_rn(a_up, A[q]);
          }
        }
      }
      // Replay the segment from its true start, adding h * c into y in
      // state order.
#pragma unroll
      for (int q = 0; q < kS; ++q) {
        float h = kLanes > 1 ? __shfl_up_sync(kFull, B[q], 1, kLanes) : B[q];
        if (j == 0) h = hc[q];
        float cv[L];
        load_seg<L>(cv, s_c + (nn + q) * ldb + t_seg);
#pragma unroll
        for (int i = 0; i < L; ++i) {
          h = __fadd_rn(__fmul_rn(da[q][i], h), bx[q][i]);
          y[i] = __fadd_rn(y[i], __fmul_rn(h, cv[i]));
        }
        if (j == kLanes - 1) h_row[nn + q] = h;  // the next chunk's carry
      }
    };
    int nn = 0;
    for (; nn + 1 < n; nn += 2) states(std::integral_constant<int, 2>{}, nn);
    if (nn < n) states(std::integral_constant<int, 1>{}, nn);

    __syncthreads();  // every lane has read its dt (the y tile overwrites it), b and c
    float bv[kBc], cv[kBc];
    if (k + 1 < nt) bc_fetch(k + 1, bv, cv);             // in flight through the epilogue
    if constexpr (kFused && L > 1) zd_fetch(k, zv, dv);  // likewise
    float* ty = y_tile(st);
#pragma unroll
    for (int i = 0; i < L; ++i) ty[tile_pos<float>(t_seg + i, cl, chans, kSegLog2)] = y[i];
    __syncthreads();  // the chunk's y tile is whole

    // The chunk's rows out: this thread's L elements of the tile.
#pragma unroll
    for (int u = 0; u < L; ++u) {
      const int i = threadIdx.x + u * kThr;
      const int r = i / chans;
      const int cc = i - r * chans;
      if (r >= rows || cc >= c_lim) continue;
      const size_t o = (static_cast<size_t>(bi) * p.seq + static_cast<size_t>(k) * steps + r)
                       * p.ch + c0 + cc;
      float v = ty[tile_pos<float>(r, cc, chans, kSegLog2)];
      if constexpr (kFused) {
        const float xv = to_f(tx[tile_pos<T>(r, cc, chans, kSegLog2)]);
        v = __fadd_rn(v, __fmul_rn(dv[u], xv));
        const float gate = __fdiv_rn(zv[u], __fadd_rn(1.0f, expf(-zv[u])));
        static_cast<T*>(p.y)[o] = from_f<T>(__fmul_rn(v, gate));
      } else {
        static_cast<float*>(p.y)[o] = v;
      }
    }
    if (k + 1 < nt) bc_store(bv, cv);  // read after the next chunk's first barrier
  }

  for (int i = threadIdx.x; i < c_lim * n; i += kThr) {
    p.ht[(static_cast<size_t>(bi) * p.ch + c0) * n + i] = s_h[i];
  }
}

// (grid, threads, shared bytes, lanes a channel, steps a lane, steps a
// chunk, channels a block, blocks an SM, registers a thread) of a launch,
// into out[0..8] when out is not null; the launch itself when run.
template <typename T, bool kFused, int L, int kLanesLog2>
int run(const Params& p, int n_batch, cudaStream_t stream, int* out, bool launch) {
  auto kernel = mamba_scan_kernel<T, kFused, L, kLanesLog2>;
  const Layout lay = layout(L, kLanesLog2, p.n, sizeof(T));
  static size_t allowed[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return -3;
  if (lay.bytes > allowed[dev]) {
    const size_t most = layout(L, kLanesLog2, kMaxN, sizeof(T)).bytes;  // this instance's largest
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(most));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[dev] = most;
  }
  const int blocks = n_batch * ((p.ch + lay.chans - 1) / lay.chans);
  if (out != nullptr) {
    int per_sm = 0;
    cudaFuncAttributes attr{};
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                    lay.threads, lay.bytes);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int cfg[9] = {blocks, lay.threads, static_cast<int>(lay.bytes), lay.lanes, L,
                        lay.steps, lay.chans, per_sm, attr.numRegs};
    for (int i = 0; i < 9; ++i) out[i] = cfg[i];
  }
  if (launch) kernel<<<blocks, lay.threads, lay.bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Lanes a channel (log2) and steps a lane for a sequence of seq steps: one
// step a lane at S = 1, else 8, over as many lanes (up to 16) as the
// sequence fills.
int lanes_log2_for(int seq, int* seg) {
  if (seq == 1) {
    *seg = 1;
    return 0;
  }
  *seg = kSeg;
  const int segs = (seq + kSeg - 1) / kSeg;
  int lg = 0;
  while (lg < kMaxLanesLog2 && (1 << lg) < segs) ++lg;
  return lg;
}

template <typename T, bool kFused>
int dispatch(Params& p, int n_batch, cudaStream_t stream, int* out, bool launch) {
  constexpr int kq = 16 / static_cast<int>(sizeof(T));
  auto vec = [&](const void* ptr, long long sb, long long ss) {
    return p.ch % kq == 0 && aligned16(ptr) && (n_batch == 1 || sb % kq == 0) &&
           (p.seq == 1 || ss % kq == 0);
  };
  p.vec_dt = vec(p.dt, p.sb_dt, p.ss_dt);
  p.vec_x = vec(p.x, p.sb_x, p.ss_x);
  int seg = kSeg;
  switch (lanes_log2_for(p.seq, &seg)) {
    case 0: return seg == 1 ? run<T, kFused, 1, 0>(p, n_batch, stream, out, launch)
                            : run<T, kFused, kSeg, 0>(p, n_batch, stream, out, launch);
    case 1: return run<T, kFused, kSeg, 1>(p, n_batch, stream, out, launch);
    case 2: return run<T, kFused, kSeg, 2>(p, n_batch, stream, out, launch);
    case 3: return run<T, kFused, kSeg, 3>(p, n_batch, stream, out, launch);
    default: return run<T, kFused, kSeg, kMaxLanesLog2>(p, n_batch, stream, out, launch);
  }
}

int select_variant(int variant, Params& p, int n_batch, cudaStream_t stream, int* out, bool launch) {
  if (p.n < 1 || p.n > kMaxN || n_batch < 1 || p.seq < 1 || p.ch < 1) return -1;
  switch (variant) {
    case 0: return dispatch<float, false>(p, n_batch, stream, out, launch);
    case 1: return dispatch<float, true>(p, n_batch, stream, out, launch);
    case 2: return dispatch<__nv_bfloat16, true>(p, n_batch, stream, out, launch);
    case 3: return dispatch<__half, true>(p, n_batch, stream, out, launch);
    default: return -2;
  }
}


// ---------------------------------------------------------------------------
// The backward (acs_mamba_scan_bwd)
// ---------------------------------------------------------------------------

struct BwdParams {
  Params f;             // the forward's inputs (y and hT unused)
  const void* dy;       // [B, S, E] contiguous: the output's gradient, T (fused) or float32
  const float* dht;     // [B, E, N] hT's gradient, or null
  void* ddt;            // [B, S, E] contiguous: d dt_raw in T (fused) or d dt float32
  void* dx;             // [B, S, E] contiguous
  void* dz;             // [B, S, E] contiguous, T (fused)
  float* dh0;           // [B, E, N]
  float* part_b;        // [B, tiles, S, N]: each block's sum of db over its channels
  float* part_c;        // [B, tiles, S, N]: the same for dc
  float* part_a;        // [B, E, N]: each batch row's da (fused: dA_log)
  float* part_d;        // [B, E]: each batch row's dD (fused)
  float* part_bias;     // [B, E]: each batch row's d dt_bias (fused)
  void* db;             // [B, S, N] contiguous, T
  void* dc;             // [B, S, N] contiguous, T
  float* da;            // [E, N]: da (plain) or dA_log (fused)
  float* dd;            // [E] (fused)
  float* dbias;         // [E] (fused)
  int vec_z, vec_dy;    // 16-byte copies allowed for the z and dy tiles
};

// The backward block's shared memory, in bytes from the base: two buffers
// (chunk k's, and chunk k - 1's landing while k runs) of the four [64, 32]
// tiles in T (dt, x, z, dy), of b and c transposed ([n][ldb] floats) and
// of the chunk's start states ([32][n]); then the carry G from the next
// chunk, the decay rates (log2-scaled and true) and da's running sums
// ([32][n] each); and the warps' db and dc for the whole chunk, [16 warps]
// [b, c][n][64 steps] floats (128 KB at N 16), summed across the warps once
// a chunk, whose room then stages the chunk's outputs (d dt, dx, dz: three
// [64, 32] tiles in T) and its db and dc ([2][64][n + 1] floats) on their
// way out as whole rows.
struct BwdLayout {
  int ldb;
  size_t tile, off_bc, off_hs, off_g, off_a2, off_at, off_da, off_red, bytes;
};

__host__ __device__ inline BwdLayout bwd_layout(int n, int elem) {
  BwdLayout o;
  o.ldb = bc_stride(kBwdSteps);
  o.tile = static_cast<size_t>(kBwdSteps) * kBwdChans * elem;
  const size_t en = static_cast<size_t>(kBwdChans) * n * 4;  // a [32][n] float array
  o.off_bc = 8 * o.tile;
  o.off_hs = o.off_bc + 2 * 2 * static_cast<size_t>(n) * o.ldb * 4;
  o.off_g = o.off_hs + 2 * en;
  o.off_a2 = o.off_g + en;
  o.off_at = o.off_a2 + en;
  o.off_da = o.off_at + en;
  o.off_red = o.off_da + en;
  const size_t red = static_cast<size_t>(kThreads / 32) * 2 * n * kBwdSteps * 4;
  const size_t out = 3 * o.tile + 2 * static_cast<size_t>(kBwdSteps) * (n + 1) * 4;
  o.bytes = o.off_red + (red > out ? red : out);
  return o;
}

// The gradient of the scan (plain, variant 0) or of the fused layer span
// (variants 1-3), one block per (batch row, 32 channels), its chunks of 64
// steps from the last to the first. For each state the adjoint
//   g_t = c_t * gy_t + G_t,  G_{t-1} = exp(dt_t a) * g_t  (G_{S-1} = dhT)
// is a linear recurrence in reverse time, so the forward's design runs it
// backwards: each lane's 4 steps give a pair (A, R) with G_out = A * G_in
// + R, a shuffle scan in reverse lane order joins the 16 lanes, the last
// lane folding in the next chunk's carry, and each lane replays its steps
// from its true G. h_{t-1} comes from a forward replay of the chunk from
// its saved start state (the forward's carry, kernels/selective_scan.py
// saves it under grad). Per step, with q = g_t exp(dt_t a) h_{t-1}:
//   dc_t += gy_t h_t, db_t += g_t dt_t x_t  (sums over channels)
//   dx_t = dt_t * sum_n g_t b_t,  ddt_t = x_t * sum_n g_t b_t + sum_n q a
//   da += q dt_t,  dh0 = G_{-1}.
// Fused: gy = dy * silu(z), dx gains D * gy, dz = dy * (ys + D x) *
// silu'(z), d dt_raw = ddt * softplus'(dt_raw + dt_bias) (torch's
// threshold of 20), dD = sum gy x, d dt_bias = sum d dt_raw, dA_log = da * a.
// No atomics: db and dc are summed over a warp's two channels by a
// shuffle (lanes 0-15 keep db, 16-31 dc), each warp writes its sums for
// every state of the chunk, and after one barrier every thread adds the 16
// warps in warp order for four steps of one state; the channel tiles are
// added by the reduction kernel in tile order; da, dD and d dt_bias over a
// channel's lanes by a butterfly, over chunks in order and over batch rows
// by the reduction kernel. Four barriers a chunk: [A] when its tiles have
// landed (chunk k - 1's copies then start into the other buffer, and land
// while chunk k runs), [B] when the warps' db and dc are written, [C] when
// they are summed (their room then stages the chunk's d dt, dx and dz) and
// [D] when those tiles are whole, which leave as rows of four neighbouring
// channels a thread (a lane's own steps are rows apart); b, c and the start
// states of chunk k - 1 are loaded into registers after [B] and stored
// transposed once chunk k's outputs have left.
template <typename T, bool kFused>
__global__ void __launch_bounds__(kThreads, 1)
    mamba_scan_bwd_kernel(const __grid_constant__ BwdParams bp) {
  constexpr int kLanesLog2 = 4;
  constexpr int kLanes = kBwdLanes;
  constexpr int steps = kBwdSteps;
  constexpr int chans = kBwdChans;
  constexpr int kSegLog2 = 2;
  constexpr int kWarps = kThreads / 32;
  constexpr int kBc = steps * kMaxN / kThreads;  // b and c elements a thread moves a chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const Params& p = bp.f;
  const int n = p.n;
  const BwdLayout lay = bwd_layout(n, sizeof(T));
  const int ldb = lay.ldb;
  auto tile_of = [&](int buf, int which) {  // which: dt, x, z, dy
    return reinterpret_cast<T*>(smem + (4 * buf + which) * lay.tile);
  };
  auto b_of = [&](int buf) { return reinterpret_cast<float*>(smem + lay.off_bc) + 2 * buf * n * ldb; };
  auto c_of = [&](int buf) { return b_of(buf) + n * ldb; };
  auto hs_of = [&](int buf) { return reinterpret_cast<float*>(smem + lay.off_hs) + buf * chans * n; };
  float* s_g = reinterpret_cast<float*>(smem + lay.off_g);
  float* s_a2 = reinterpret_cast<float*>(smem + lay.off_a2);
  float* s_at = reinterpret_cast<float*>(smem + lay.off_at);
  float* s_da = reinterpret_cast<float*>(smem + lay.off_da);
  float* s_red = reinterpret_cast<float*>(smem + lay.off_red);

  const int tiles_c = (p.ch + chans - 1) / chans;
  const int bi = blockIdx.x / tiles_c;
  const int tile = blockIdx.x - bi * tiles_c;
  const int c0 = tile * chans;
  const int c_lim = min(chans, p.ch - c0);
  const int nt = (p.seq + steps - 1) / steps;

  const T* dt_src = static_cast<const T*>(p.dt) + bi * p.sb_dt + c0;
  const T* x_src = static_cast<const T*>(p.x) + bi * p.sb_x + c0;
  const T* z_src = kFused ? static_cast<const T*>(p.z) + bi * p.sb_z + c0 : nullptr;
  const T* dy_src = static_cast<const T*>(bp.dy) + static_cast<size_t>(bi) * p.seq * p.ch + c0;
  const T* b_src = static_cast<const T*>(p.b) + bi * p.sb_b;
  const T* c_src = static_cast<const T*>(p.c) + bi * p.sb_c;
  const size_t row_en = (static_cast<size_t>(bi) * p.ch + c0) * n;  // this block's [E, N] rows
  const int rows_of_last = p.seq - (nt - 1) * steps;
  auto rows_of = [&](int k) { return k == nt - 1 ? rows_of_last : steps; };

  // Chunk k's four tiles into buffer k & 1 (cp.async, committed).
  auto stage_tiles = [&](int k) {
    const int buf = k & 1;
    const int rows = rows_of(k);
    const long long t0 = static_cast<long long>(k) * steps;
    stage_tile<T, kThreads>(tile_of(buf, 0), dt_src + t0 * p.ss_dt, p.ss_dt, steps, rows, chans,
                            c_lim, kSegLog2, p.vec_dt);
    stage_tile<T, kThreads>(tile_of(buf, 1), x_src + t0 * p.ss_x, p.ss_x, steps, rows, chans,
                            c_lim, kSegLog2, p.vec_x);
    if constexpr (kFused)
      stage_tile<T, kThreads>(tile_of(buf, 2), z_src + t0 * p.ss_z, p.ss_z, steps, rows, chans,
                              c_lim, kSegLog2, bp.vec_z);
    stage_tile<T, kThreads>(tile_of(buf, 3), dy_src + t0 * p.ch, p.ch, steps, rows, chans, c_lim,
                            kSegLog2, bp.vec_dy);
    cp_async_commit();
  };
  // Chunk k's b, c and start states into registers...
  auto fetch_bc = [&](int k, float (&bv)[kBc], float (&cv)[kBc], float& hv) {
    const int rows = rows_of(k);
    const long long t0 = static_cast<long long>(k) * steps;
#pragma unroll
    for (int u = 0; u < kBc; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int r = i / n;
      const bool ok = i < steps * n && r < rows;
      bv[u] = ok ? to_f(b_src[(t0 + r) * p.ss_b + (i - r * n)]) : 0.0f;
      cv[u] = ok ? to_f(c_src[(t0 + r) * p.ss_c + (i - r * n)]) : 0.0f;
    }
    const int i = threadIdx.x;  // chans * n <= kThreads
    hv = 0.0f;
    if (i < c_lim * n)
      hv = k == 0 ? p.h0[row_en + i]
                  : p.states[((static_cast<size_t>(bi) * (nt - 1) + k - 1) * p.ch + c0) * n + i];
  };
  // ... then into buffer k & 1, b and c transposed to [n][step].
  auto store_bc = [&](int k, const float (&bv)[kBc], const float (&cv)[kBc], float hv) {
    float* sb_ = b_of(k & 1);
    float* sc_ = c_of(k & 1);
#pragma unroll
    for (int u = 0; u < kBc; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int r = i / n;
      if (i < steps * n) {
        sb_[(i - r * n) * ldb + r] = bv[u];
        sc_[(i - r * n) * ldb + r] = cv[u];
      }
    }
    if (threadIdx.x < chans * n) hs_of(k & 1)[threadIdx.x] = hv;
  };

  for (int i = threadIdx.x; i < chans * n; i += kThreads) {
    const bool ok = i < c_lim * n;
    const float av = ok ? p.a[static_cast<size_t>(c0) * n + i] : 0.0f;
    const float at = (kFused && ok) ? -expf(av) : av;
    s_at[i] = at;
    s_a2[i] = __fmul_rn(at, kLog2e);
    s_da[i] = 0.0f;
    s_g[i] = (ok && bp.dht != nullptr) ? bp.dht[row_en + i] : 0.0f;
  }
  stage_tiles(nt - 1);
  {
    float bv[kBc], cv[kBc], hv;
    fetch_bc(nt - 1, bv, cv, hv);
    store_bc(nt - 1, bv, cv, hv);
  }

  const int j = threadIdx.x & (kLanes - 1);
  const int cl = threadIdx.x >> kLanesLog2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool live = cl < c_lim;
  const float bias = (kFused && live) ? p.dt_bias[c0 + cl] : 0.0f;
  const float dval = (kFused && live) ? p.d[c0 + cl] : 0.0f;
  const int t_seg = j * kSeg;
  float acc_d = 0.0f, acc_bias = 0.0f;  // this thread's steps' dD and d dt_bias
  float* red_w = s_red + warp * 2 * n * steps;  // this warp's db, then dc, [n][steps]

  for (int k = nt - 1; k >= 0; --k) {
    const int buf = k & 1;
    const int rows = rows_of(k);
    const long long t0 = static_cast<long long>(k) * steps;
    cp_async_wait<0>();
    __syncthreads();  // [A]: chunk k is in buffer k & 1, and chunk k + 1's buffer is free
    if (k > 0) stage_tiles(k - 1);
    const T* t_dt = tile_of(buf, 0);
    const T* t_x = tile_of(buf, 1);
    const T* t_z = tile_of(buf, 2);
    const T* t_dy = tile_of(buf, 3);
    const float* s_b = b_of(buf);
    const float* s_c = c_of(buf);
    const float* s_hs = hs_of(buf);

    float dtv[kSeg], xv[kSeg], dxin[kSeg], gy[kSeg], ys[kSeg], sb[kSeg], sa[kSeg];
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      const int t = t_seg + i;
      const bool in = live && t < rows;
      const int pos = tile_pos<T>(t, cl, chans, kSegLog2);
      float v = to_f(t_dt[pos]);
      if constexpr (kFused) v = in ? softplus(__fadd_rn(v, bias)) : 0.0f;
      dtv[i] = in ? v : 0.0f;
      xv[i] = to_f(t_x[pos]);
      dxin[i] = __fmul_rn(dtv[i], xv[i]);
      float g = in ? to_f(t_dy[pos]) : 0.0f;
      if constexpr (kFused) {
        const float zv = to_f(t_z[pos]);
        g = __fmul_rn(g, __fdiv_rn(zv, __fadd_rn(1.0f, expf(-zv))));
      }
      gy[i] = g;
      ys[i] = sb[i] = sa[i] = 0.0f;
    }

    auto states = [&](auto ks, int nn) {
      constexpr int kS = decltype(ks)::value;
      float da[kS][kSeg], bx[kS][kSeg], hh[kS][kSeg + 1], bv[kS][kSeg], cv[kS][kSeg];
      float A[kS], B[kS], hc[kS], gc[kS], at[kS];
      const int row = cl * n + nn;
#pragma unroll
      for (int q = 0; q < kS; ++q) {
        const float an = s_a2[row + q];
        at[q] = s_at[row + q];
        load_seg<kSeg>(bv[q], s_b + (nn + q) * ldb + t_seg);
        load_seg<kSeg>(cv[q], s_c + (nn + q) * ldb + t_seg);
#pragma unroll
        for (int i = 0; i < kSeg; ++i) {
          da[q][i] = exp2_approx(__fmul_rn(dtv[i], an));
          bx[q][i] = __fmul_rn(dxin[i], bv[q][i]);
          if (i == 0) {
            A[q] = da[q][0];
            B[q] = bx[q][0];
          } else {
            B[q] = __fadd_rn(__fmul_rn(da[q][i], B[q]), bx[q][i]);
            A[q] = __fmul_rn(A[q], da[q][i]);
          }
        }
        hc[q] = s_hs[row + q];
        gc[q] = s_g[row + q];
        if (j == 0) B[q] = __fadd_rn(__fmul_rn(A[q], hc[q]), B[q]);
      }
      // The forward: each lane's true start state, then its steps' h.
#pragma unroll
      for (int d = 1; d < kLanes; d <<= 1) {
#pragma unroll
        for (int q = 0; q < kS; ++q) {
          const float a_up = __shfl_up_sync(kFull, A[q], d, kLanes);
          const float b_up = __shfl_up_sync(kFull, B[q], d, kLanes);
          if (j >= d) {
            B[q] = __fadd_rn(__fmul_rn(A[q], b_up), B[q]);
            A[q] = __fmul_rn(a_up, A[q]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kS; ++q) {
        float h = __shfl_up_sync(kFull, B[q], 1, kLanes);
        if (j == 0) h = hc[q];
        hh[q][0] = h;
#pragma unroll
        for (int i = 0; i < kSeg; ++i) {
          h = __fadd_rn(__fmul_rn(da[q][i], h), bx[q][i]);
          hh[q][i + 1] = h;
          ys[i] = __fadd_rn(ys[i], __fmul_rn(h, cv[q][i]));
        }
      }
      // The adjoint: each lane's pair from a zero carry, in reverse.
#pragma unroll
      for (int q = 0; q < kS; ++q) {
        float r = 0.0f;
#pragma unroll
        for (int i = kSeg - 1; i >= 0; --i)
          r = __fmul_rn(da[q][i], __fadd_rn(__fmul_rn(gy[i], cv[q][i]), r));
        A[q] = __fmul_rn(__fmul_rn(__fmul_rn(da[q][0], da[q][1]), da[q][2]), da[q][3]);
        B[q] = j == kLanes - 1 ? __fadd_rn(__fmul_rn(A[q], gc[q]), r) : r;
      }
#pragma unroll
      for (int d = 1; d < kLanes; d <<= 1) {
#pragma unroll
        for (int q = 0; q < kS; ++q) {
          const float a_dn = __shfl_down_sync(kFull, A[q], d, kLanes);
          const float b_dn = __shfl_down_sync(kFull, B[q], d, kLanes);
          if (j + d < kLanes) {
            B[q] = __fadd_rn(__fmul_rn(A[q], b_dn), B[q]);
            A[q] = __fmul_rn(A[q], a_dn);
          }
        }
      }
      float cb[kS][kSeg], cc[kS][kSeg];
#pragma unroll
      for (int q = 0; q < kS; ++q) {
        float g_in = __shfl_down_sync(kFull, B[q], 1, kLanes);
        if (j == kLanes - 1) g_in = gc[q];
        float dap = 0.0f;
#pragma unroll
        for (int i = kSeg - 1; i >= 0; --i) {
          const float g = __fadd_rn(__fmul_rn(gy[i], cv[q][i]), g_in);
          cb[q][i] = __fmul_rn(g, dxin[i]);
          cc[q][i] = __fmul_rn(gy[i], hh[q][i + 1]);
          sb[i] = __fadd_rn(sb[i], __fmul_rn(g, bv[q][i]));
          const float qv = __fmul_rn(__fmul_rn(g, da[q][i]), hh[q][i]);
          sa[i] = __fadd_rn(sa[i], __fmul_rn(qv, at[q]));
          dap = __fadd_rn(dap, __fmul_rn(qv, dtv[i]));
          g_in = __fmul_rn(da[q][i], g);
        }
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          dap = __fadd_rn(dap, __shfl_xor_sync(kFull, dap, off, kLanes));
        __syncwarp();
        if (j == 0) {
          s_g[row + q] = g_in;  // the previous chunk's carry; after chunk 0, dh0
          s_da[row + q] = __fadd_rn(s_da[row + q], dap);
        }
      }
      // db and dc over the warp's two channels: lanes 0-15 add their
      // partner's db to theirs, lanes 16-31 its dc, and each writes its
      // four steps of the state into the warp's sums.
#pragma unroll
      for (int q = 0; q < kS; ++q) {
        float v[kSeg];
#pragma unroll
        for (int i = 0; i < kSeg; ++i) {
          const float mine = lane < 16 ? cb[q][i] : cc[q][i];
          const float theirs = __shfl_xor_sync(kFull, lane < 16 ? cc[q][i] : cb[q][i], 16);
          v[i] = __fadd_rn(mine, theirs);
        }
        *reinterpret_cast<float4*>(red_w + ((lane >> 4) * n + nn + q) * steps + t_seg) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    };
    int nn = 0;
    for (; nn + 1 < n; nn += 2) states(std::integral_constant<int, 2>{}, nn);
    if (nn < n) states(std::integral_constant<int, 1>{}, nn);
    __syncthreads();  // [B]: every warp's db and dc of the chunk are written

    float bv_next[kBc], cv_next[kBc], hv_next = 0.0f;
    if (k > 0) fetch_bc(k - 1, bv_next, cv_next, hv_next);  // in flight through the stores
    // db and dc of the chunk over the block's channels: four steps of one
    // state a thread, the 16 warps added in warp order, into this block's
    // partial sums ([B, tiles, N, S] each).
    // db and dc of the chunk over the block's channels: four steps of one
    // state a thread, the 16 warps added in warp order.
    const int sum_row = threadIdx.x / (steps / 4);  // b's state, then c's
    const int sum_t4 = (threadIdx.x % (steps / 4)) * 4;
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (sum_row < 2 * n) {
#pragma unroll 4
      for (int w = 0; w < kWarps; ++w) {
        const float4 v =
            *reinterpret_cast<const float4*>(s_red + (w * 2 * n + sum_row) * steps + sum_t4);
        sum.x = __fadd_rn(sum.x, v.x);
        sum.y = __fadd_rn(sum.y, v.y);
        sum.z = __fadd_rn(sum.z, v.z);
        sum.w = __fadd_rn(sum.w, v.w);
      }
    }

#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      const int t = t_seg + i;
      if (!live || t >= rows) continue;
      const int pos = tile_pos<T>(t, cl, chans, kSegLog2);
      const float ddt = __fadd_rn(__fmul_rn(xv[i], sb[i]), sa[i]);
      float dxo = __fmul_rn(dtv[i], sb[i]);
      if constexpr (kFused) {
        dxo = __fadd_rn(dxo, __fmul_rn(dval, gy[i]));
        const float v = __fadd_rn(to_f(t_dt[pos]), bias);
        const float ev = expf(v);
        const float draw = v > 20.0f ? ddt : __fmul_rn(ddt, __fdiv_rn(ev, __fadd_rn(ev, 1.0f)));
        acc_bias = __fadd_rn(acc_bias, draw);
        acc_d = __fadd_rn(acc_d, __fmul_rn(gy[i], xv[i]));
        const float zv = to_f(t_z[pos]);
        const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-zv)));
        const float dsilu = __fmul_rn(sig, __fadd_rn(1.0f, __fmul_rn(zv, __fsub_rn(1.0f, sig))));
        const float yd = __fadd_rn(ys[i], __fmul_rn(dval, xv[i]));
        sa[i] = __fmul_rn(__fmul_rn(to_f(t_dy[pos]), yd), dsilu);  // dz
        sb[i] = draw;
      } else {
        sb[i] = ddt;
      }
      dtv[i] = dxo;
    }
    __syncthreads();  // [C]: the warps' sums are read; their room takes the outputs
    T* o_dt = reinterpret_cast<T*>(s_red);
    T* o_dx = o_dt + steps * chans;
    T* o_dz = o_dx + steps * chans;
    float* o_sum = reinterpret_cast<float*>(o_dz + steps * chans);  // [b, c][steps][n + 1]
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      const int pos = tile_pos<T>(t_seg + i, cl, chans, kSegLog2);
      o_dt[pos] = from_f<T>(sb[i]);
      o_dx[pos] = from_f<T>(dtv[i]);
      if constexpr (kFused) o_dz[pos] = from_f<T>(sa[i]);
    }
    if (sum_row < 2 * n) {
      const int bc = sum_row >= n;
      float* o = o_sum + (bc * steps + sum_t4) * (n + 1) + sum_row - bc * n;
      o[0] = sum.x;
      o[n + 1] = sum.y;
      o[2 * (n + 1)] = sum.z;
      o[3 * (n + 1)] = sum.w;
    }
    __syncthreads();  // [D]: the chunk's output tiles and sums are whole
    // The sums into this block's partials ([B, tiles, S, N] each), whole
    // runs of the chunk's steps.
    for (int e = threadIdx.x; e < 2 * rows * n; e += kThreads) {
      const int bc = e >= rows * n;
      const int rem = e - bc * rows * n;
      const int r = rem / n;
      (bc ? bp.part_c : bp.part_b)[((static_cast<size_t>(bi) * tiles_c + tile) * p.seq + t0) * n +
                                   rem] = o_sum[(bc * steps + r) * (n + 1) + rem - r * n];
    }
    {  // ... and out as rows, four neighbouring channels a thread
      using V = std::conditional_t<sizeof(T) == 2, uint2, uint4>;
      const int e0 = threadIdx.x * 4;
      const int r = e0 / chans;
      const int cc = e0 - r * chans;
      if (r < rows && cc < c_lim) {
        const int pos = tile_pos<T>(r, cc, chans, kSegLog2);
        const size_t o = (static_cast<size_t>(bi) * p.seq + t0 + r) * p.ch + c0 + cc;
        T* outs[3] = {static_cast<T*>(bp.ddt), static_cast<T*>(bp.dx), static_cast<T*>(bp.dz)};
        const T* tiles[3] = {o_dt, o_dx, o_dz};
#pragma unroll
        for (int w = 0; w < (kFused ? 3 : 2); ++w) {
          if (cc + 4 <= c_lim && (p.ch & 3) == 0) {
            *reinterpret_cast<V*>(outs[w] + o) = *reinterpret_cast<const V*>(tiles[w] + pos);
          } else {
            for (int u = 0; u < 4 && cc + u < c_lim; ++u) outs[w][o + u] = tiles[w][pos + u];
          }
        }
      }
    }
    if (k > 0) store_bc(k - 1, bv_next, cv_next, hv_next);
  }

  __syncthreads();  // s_g holds dh0 and s_da the block's da
  for (int i = threadIdx.x; i < c_lim * n; i += kThreads) {
    bp.dh0[row_en + i] = s_g[i];
    bp.part_a[row_en + i] = kFused ? __fmul_rn(s_da[i], s_at[i]) : s_da[i];
  }
  if constexpr (kFused) {
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      acc_d = __fadd_rn(acc_d, __shfl_xor_sync(kFull, acc_d, off, kLanes));
      acc_bias = __fadd_rn(acc_bias, __shfl_xor_sync(kFull, acc_bias, off, kLanes));
    }
    if (j == 0 && live) {
      bp.part_d[static_cast<size_t>(bi) * p.ch + c0 + cl] = acc_d;
      bp.part_bias[static_cast<size_t>(bi) * p.ch + c0 + cl] = acc_bias;
    }
  }
}

// The sums across blocks, each in a fixed order: db and dc over the
// channel tiles in tile order ([B, S, N], rounded to T), da (or dA_log)
// over the batch rows, and (fused) dD and d dt_bias likewise.
template <typename T, bool kFused>
__global__ void __launch_bounds__(256)
    mamba_scan_bwd_reduce_kernel(const __grid_constant__ BwdParams bp, int n_batch) {
  const Params& p = bp.f;
  const int tiles_c = (p.ch + kBwdChans - 1) / kBwdChans;
  const size_t sn = static_cast<size_t>(p.seq) * p.n;
  const size_t n_bc = n_batch * sn;
  const size_t n_a = static_cast<size_t>(p.ch) * p.n;
  const size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i < n_bc) {
    const size_t bi = i / sn;
    const size_t rest = i - bi * sn;
    float sb = 0.0f, sc = 0.0f;
    for (int t = 0; t < tiles_c; ++t) {
      const size_t src = (bi * tiles_c + t) * sn + rest;
      sb = __fadd_rn(sb, bp.part_b[src]);
      sc = __fadd_rn(sc, bp.part_c[src]);
    }
    static_cast<T*>(bp.db)[i] = from_f<T>(sb);
    static_cast<T*>(bp.dc)[i] = from_f<T>(sc);
  } else if (i < n_bc + n_a) {
    const size_t e = i - n_bc;
    float s = 0.0f;
    for (int b = 0; b < n_batch; ++b) s = __fadd_rn(s, bp.part_a[b * n_a + e]);
    bp.da[e] = s;
  } else if (kFused && i < n_bc + n_a + p.ch) {
    const size_t e = i - n_bc - n_a;
    float sd = 0.0f, sbias = 0.0f;
    for (int b = 0; b < n_batch; ++b) {
      sd = __fadd_rn(sd, bp.part_d[b * static_cast<size_t>(p.ch) + e]);
      sbias = __fadd_rn(sbias, bp.part_bias[b * static_cast<size_t>(p.ch) + e]);
    }
    bp.dd[e] = sd;
    bp.dbias[e] = sbias;
  }
}

template <typename T, bool kFused>
int run_bwd(BwdParams& bp, int n_batch, cudaStream_t stream) {
  Params& p = bp.f;
  constexpr int kq = 16 / static_cast<int>(sizeof(T));
  auto vec = [&](const void* ptr, long long sb, long long ss) {
    return p.ch % kq == 0 && aligned16(ptr) && (n_batch == 1 || sb % kq == 0) &&
           (p.seq == 1 || ss % kq == 0);
  };
  p.vec_dt = vec(p.dt, p.sb_dt, p.ss_dt);
  p.vec_x = vec(p.x, p.sb_x, p.ss_x);
  bp.vec_z = kFused ? vec(p.z, p.sb_z, p.ss_z) : 0;
  bp.vec_dy = vec(bp.dy, static_cast<long long>(p.seq) * p.ch, p.ch);
  auto kernel = mamba_scan_bwd_kernel<T, kFused>;
  const size_t bytes = bwd_layout(p.n, sizeof(T)).bytes;
  static size_t allowed[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return -3;
  if (bytes > allowed[dev]) {
    const size_t most = bwd_layout(kMaxN, sizeof(T)).bytes;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(most));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[dev] = most;
  }
  const int blocks = n_batch * ((p.ch + kBwdChans - 1) / kBwdChans);
  kernel<<<blocks, kThreads, bytes, stream>>>(bp);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const size_t total = static_cast<size_t>(n_batch) * p.seq * p.n +
                       static_cast<size_t>(p.ch) * p.n + (kFused ? p.ch : 0);
  mamba_scan_bwd_reduce_kernel<T, kFused>
      <<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(bp, n_batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch with the pointers of one call and the sizes of its key, both as
// arrays of 64-bit integers (a short host path: the sizes are packed once
// per key, the pointers written into one array per call):
//   call[0..12]: dt, x, z, b, c, a, dt_bias, d, h0, y, hT, the stream, and
//   the chunk states to save under grad (0: none; S > 64 only);
//   sizes[0..14]: variant, B, S, E, N, then the batch and row strides of
//   dt, x, z, b and c, in elements.
// variant: 0 = the plain scan (float32; a is the decay, z, dt_bias and d
// unused, y gets ys), 1 / 2 / 3 = the fused layer span with float32 /
// bfloat16 / float16 dt_raw, x, z, b, c and y (a is A_log). Returns
// cudaGetLastError() after the launch (0 on success), -1 for an empty
// scan or a state size outside 1..16, -2 for an unknown variant.
extern "C" int acs_mamba_scan(const long long* call, const long long* sizes) {
  auto ptr = [&](int i) { return reinterpret_cast<void*>(call[i]); };
  Params p{ptr(0), ptr(1), ptr(2), ptr(3), ptr(4),
           static_cast<const float*>(ptr(5)), static_cast<const float*>(ptr(6)),
           static_cast<const float*>(ptr(7)), static_cast<const float*>(ptr(8)), ptr(9),
           static_cast<float*>(ptr(10)),
           sizes[5], sizes[6], sizes[7], sizes[8], sizes[9],
           sizes[10], sizes[11], sizes[12], sizes[13], sizes[14],
           static_cast<int>(sizes[2]), static_cast<int>(sizes[3]), static_cast<int>(sizes[4]),
           0, 0, static_cast<float*>(ptr(12))};
  return select_variant(static_cast<int>(sizes[0]), p, static_cast<int>(sizes[1]),
                        static_cast<cudaStream_t>(ptr(11)), nullptr, true);
}

// The launch acs_mamba_scan would make for these sizes (strides unused),
// into out[9] (see run); no launch. Returns 0 or a CUDA error.
extern "C" int acs_mamba_scan_config(const long long* sizes, int* out) {
  Params p{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
           nullptr, nullptr, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
           static_cast<int>(sizes[2]), static_cast<int>(sizes[3]), static_cast<int>(sizes[4]),
           0, 0, nullptr};
  return select_variant(static_cast<int>(sizes[0]), p, static_cast<int>(sizes[1]), nullptr, out,
                        false);
}

// The backward of acs_mamba_scan (the same variants, sizes and strides):
//   call[0..11]: dt, x, z, b, c, a, dt_bias, d, h0, the forward's chunk
//   states ([B, ceil(S / 64) - 1, E, N], saved under grad; unused at
//   S <= 64), dy ([B, S, E] contiguous, the output's dtype), dhT ([B, E,
//   N] float32, or 0);
//   call[12..22]: ddt, dx, dz ([B, S, E] contiguous: d dt_raw, dx and dz in
//   the model dtype, fused; d dt and dx float32, plain), dh0 [B, E, N], the
//   float32 workspace (acs_mamba_scan_bwd_workspace floats), db, dc ([B, S,
//   N] contiguous, the model dtype), da [E, N] (dA_log, fused), dD [E],
//   d dt_bias [E] (fused), the stream.
// Launches the backward kernel, then the reduction across its blocks.
// Returns cudaGetLastError() after the first launch that fails (0 on
// success), -1 / -2 as acs_mamba_scan.
extern "C" int acs_mamba_scan_bwd(const long long* call, const long long* sizes) {
  auto ptr = [&](int i) { return reinterpret_cast<void*>(call[i]); };
  const int n_batch = static_cast<int>(sizes[1]);
  const int seq = static_cast<int>(sizes[2]), ch = static_cast<int>(sizes[3]);
  const int n = static_cast<int>(sizes[4]);
  if (n < 1 || n > kMaxN || n_batch < 1 || seq < 1 || ch < 1) return -1;
  const int tiles = (ch + kBwdChans - 1) / kBwdChans;
  float* ws = static_cast<float*>(ptr(16));
  const size_t part_bc = static_cast<size_t>(n_batch) * tiles * seq * n;
  BwdParams bp{};
  bp.f = Params{ptr(0), ptr(1), ptr(2), ptr(3), ptr(4),
                static_cast<const float*>(ptr(5)), static_cast<const float*>(ptr(6)),
                static_cast<const float*>(ptr(7)), static_cast<const float*>(ptr(8)), nullptr,
                nullptr,
                sizes[5], sizes[6], sizes[7], sizes[8], sizes[9],
                sizes[10], sizes[11], sizes[12], sizes[13], sizes[14],
                seq, ch, n, 0, 0, static_cast<float*>(ptr(9))};
  bp.dy = ptr(10);
  bp.dht = static_cast<const float*>(ptr(11));
  bp.ddt = ptr(12);
  bp.dx = ptr(13);
  bp.dz = ptr(14);
  bp.dh0 = static_cast<float*>(ptr(15));
  bp.part_b = ws;
  bp.part_c = ws + part_bc;
  bp.part_a = ws + 2 * part_bc;
  bp.part_d = bp.part_a + static_cast<size_t>(n_batch) * ch * n;
  bp.part_bias = bp.part_d + static_cast<size_t>(n_batch) * ch;
  bp.db = ptr(17);
  bp.dc = ptr(18);
  bp.da = static_cast<float*>(ptr(19));
  bp.dd = static_cast<float*>(ptr(20));
  bp.dbias = static_cast<float*>(ptr(21));
  cudaStream_t stream = static_cast<cudaStream_t>(ptr(22));
  switch (static_cast<int>(sizes[0])) {
    case 0: return run_bwd<float, false>(bp, n_batch, stream);
    case 1: return run_bwd<float, true>(bp, n_batch, stream);
    case 2: return run_bwd<__nv_bfloat16, true>(bp, n_batch, stream);
    case 3: return run_bwd<__half, true>(bp, n_batch, stream);
    default: return -2;
  }
}

// The backward's float32 workspace for these sizes, in floats: each
// block's db and dc sums ([B, ceil(E / 32), S, N] each), each batch row's
// da ([B, E, N]), dD and d dt_bias ([B, E] each).
extern "C" long long acs_mamba_scan_bwd_workspace(const long long* sizes) {
  const long long n_batch = sizes[1], seq = sizes[2], ch = sizes[3], n = sizes[4];
  const long long tiles = (ch + kBwdChans - 1) / kBwdChans;
  return 2 * n_batch * tiles * seq * n + n_batch * ch * n + 2 * n_batch * ch;
}
