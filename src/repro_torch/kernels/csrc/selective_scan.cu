// Mamba's selective scan on Hopper (sm_90a).
//
// Replaces: no pallas_call. The reference runs the recurrence of
// src/repro/models/recurrent.py apply_mamba as jax.lax.scan over a step
// function; eagerly on the card that loop costs about 7 launches a step
// and layer. This kernel runs the whole scan of one layer in one launch:
//
//   da  = exp(dt_t[e] * a[e, n])
//   h   = da * h + (dt_t[e] * x_t[e]) * b_t[n]
//   y_t = sum over n of h[e, n] * c_t[n]
//
// over dt, x [B, S, E], b, c [B, S, N], a [E, N], h0 [B, E, N], all
// float32; it writes ys [B, S, E] and hT [B, E, N].
//
// Bound on this card, at falcon-mamba-7b's prefill [1, 512, 8192], N = 16:
// the bytes are dt, x and ys (16.8 MB each) and b, c, a, h0 and hT (under
// 1.1 MB): 51.4 MB, 0.0153 ms at 3.35 TB/s. The arithmetic is B*S*E*N =
// 67.1 M exponentials and 6 float operations beside each (0.407 GFLOP,
// 0.0061 ms at 67 TFLOP/s). An exponential is one MUFU.EX2 on the
// special-function units, 16 results a clock on each of the 132 SMs: at
// 1.98 GHz, 4.18 T a second, so the 67.1 M take 0.0161 ms. The
// exponentials bind, just above the bytes.
//
// Design:
// * Four lanes own one (batch row, channel) and hold its N <= 16 states
//   in registers, N / 4 each (states 4 * sub .. 4 * sub + 3 of lane sub),
//   so the exponentials spread over all four SM sub-partitions: one lane
//   per channel gave falcon-mamba's 8,192 channels only 2 warps an SM.
//   Each lane sums its states' terms of y in order, then two butterfly
//   shuffles add the four partial sums; the quad's first lane stores y.
// * A block of 128 threads owns 32 channels of one batch row. dt and x
//   stream through a 3-stage ring of [32 steps, 32 channels] tiles in
//   shared memory, b and c through [32 steps, 16] tiles beside them,
//   filled by 16-byte cp.async copies (csrc/sm90_tiles.cuh stage), so the
//   loads of tiles k + 1 and k + 2 are in flight while tile k is scanned.
//   Rows that are not 16-byte multiples (E or N not a multiple of 4, or an
//   unaligned pointer) stage with element loads.
// * Any B, S, E and N from 1 to 16 with no padding copy: the last time
//   tile and channel tile are masked, and a state past N is never
//   updated.
// * Time order per channel is kept. Each product and sum rounds to float32
//   on its own (the file is built with -fmad=false), in the plain
//   version's order (kernels/ref.py selective_scan_ref); expf is the CUDA
//   math library's, as torch's exp on the card. The sum over n for y runs
//   in another order than the plain version's einsum, so the kernel is
//   held to it within a tolerance (float32, 1e-5 relative) and not bit
//   for bit; hT comes out bit-equal at falcon-mamba's shapes.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py): falcon-mamba's
// prefill 0.166 ms back to back, 10x its bound (the same loop unrolled by
// 4 took 0.148 ms of device time in another call: no clear gain, not
// kept); a decode launch [1, 1, 8192] 0.0026 ms on the device, 0.03-0.05
// ms with the wrapper's host path. 80 registers, 36 KB of static shared
// memory, no spills. What holds it at 10x is not known yet: the
// instruction count of the accurate expf, about 15 a state and step,
// bounds it near 0.03 ms.

#include "sm90_tiles.cuh"

#include <cstddef>

namespace {

using namespace sm90;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kLanes = 4;                  // lanes per channel
constexpr int kMaxN = 16;
constexpr int kPer = kMaxN / kLanes;       // states per lane
constexpr int kC = kThreads / kLanes;      // channels per block
constexpr int kT = 32;                     // time steps per tile
constexpr int kStages = 3;

struct Params {
  const float* dt;  // [B, S, E]
  const float* x;   // [B, S, E]
  const float* b;   // [B, S, N]
  const float* c;   // [B, S, N]
  const float* a;   // [E, N]
  const float* h0;  // [B, E, N]
  float* ys;        // [B, S, E]
  float* ht;        // [B, E, N]
  int seq, ch, n;
  int vec_e, vec_n;  // 16-byte copies allowed for the [.., E] and [.., N] tiles
};

__global__ void __launch_bounds__(kThreads) selective_scan_kernel(const Params p) {
  __shared__ __align__(16) float s_dt[kStages][kT * kC];
  __shared__ __align__(16) float s_x[kStages][kT * kC];
  __shared__ __align__(16) float s_b[kStages][kT * kMaxN];
  __shared__ __align__(16) float s_c[kStages][kT * kMaxN];

  const int tiles_c = (p.ch + kC - 1) / kC;
  const int bi = blockIdx.x / tiles_c;
  const int c0 = (blockIdx.x - bi * tiles_c) * kC;
  const int c_lim = min(kC, p.ch - c0);
  const size_t row_e = static_cast<size_t>(bi) * p.seq * p.ch + c0;  // [bi, 0, c0]
  const size_t row_n = static_cast<size_t>(bi) * p.seq * p.n;        // [bi, 0, 0]
  const int nt = (p.seq + kT - 1) / kT;

  auto load = [&](int k) {
    const size_t t0 = static_cast<size_t>(k) * kT;
    const int r_lim = p.seq - k * kT;
    const int st = k % kStages;
    stage<float, kT, kC, kC, kThreads>(s_dt[st], p.dt + row_e + t0 * p.ch, p.ch, r_lim, c_lim,
                                       p.vec_e);
    stage<float, kT, kC, kC, kThreads>(s_x[st], p.x + row_e + t0 * p.ch, p.ch, r_lim, c_lim,
                                       p.vec_e);
    stage<float, kT, kMaxN, kMaxN, kThreads>(s_b[st], p.b + row_n + t0 * p.n, p.n, r_lim, p.n,
                                             p.vec_n);
    stage<float, kT, kMaxN, kMaxN, kThreads>(s_c[st], p.c + row_n + t0 * p.n, p.n, r_lim, p.n,
                                             p.vec_n);
  };

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < nt) load(k);
    cp_async_commit();
  }

  const int cl = threadIdx.x / kLanes;  // this quad's channel in the tile
  const int sub = threadIdx.x % kLanes;
  const int e = c0 + cl;
  const bool live = cl < c_lim;
  float a_r[kPer], h[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int n = sub * kPer + j;
    const bool ok = live && n < p.n;
    a_r[j] = ok ? p.a[static_cast<size_t>(e) * p.n + n] : 0.0f;
    h[j] = ok ? p.h0[(static_cast<size_t>(bi) * p.ch + e) * p.n + n] : 0.0f;
  }
  float* ys = p.ys + row_e + cl;

  for (int k = 0; k < nt; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile k is in shared memory; every reader of tile k-1 is done
    if (k + kStages - 1 < nt) load(k + kStages - 1);
    cp_async_commit();
    const int st = k % kStages;
    const int rows = min(kT, p.seq - k * kT);
    const float* tdt = s_dt[st] + cl;
    const float* tx = s_x[st] + cl;
    const float* tb = s_b[st] + sub * kPer;
    const float* tc = s_c[st] + sub * kPer;
    for (int t = 0; t < rows; ++t) {
      const float dtv = tdt[t * kC];
      const float dx = __fmul_rn(dtv, tx[t * kC]);
      float y = 0.0f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (sub * kPer + j < p.n) {
          const float da = expf(__fmul_rn(dtv, a_r[j]));
          h[j] = __fadd_rn(__fmul_rn(da, h[j]), __fmul_rn(dx, tb[t * kMaxN + j]));
          y = __fadd_rn(y, __fmul_rn(h[j], tc[t * kMaxN + j]));
        }
      }
      y = __fadd_rn(y, __shfl_xor_sync(kFull, y, 1));
      y = __fadd_rn(y, __shfl_xor_sync(kFull, y, 2));
      if (sub == 0 && live) ys[(static_cast<size_t>(k) * kT + t) * p.ch] = y;
    }
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int n = sub * kPer + j;
      if (n < p.n) p.ht[(static_cast<size_t>(bi) * p.ch + e) * p.n + n] = h[j];
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or -1 for a
// state size outside 1..16.
extern "C" int acs_selective_scan(const void* dt, const void* x, const void* b, const void* c,
                                  const void* a, const void* h0, void* ys, void* ht,
                                  int n_batch, int seq, int ch, int n, void* stream) {
  if (n < 1 || n > kMaxN) return -1;
  const int vec_e = ch % 4 == 0 && aligned16(dt) && aligned16(x);
  const int vec_n = n % 4 == 0 && aligned16(b) && aligned16(c);
  Params p{static_cast<const float*>(dt), static_cast<const float*>(x),
           static_cast<const float*>(b),  static_cast<const float*>(c),
           static_cast<const float*>(a),  static_cast<const float*>(h0),
           static_cast<float*>(ys),       static_cast<float*>(ht),
           seq, ch, n, vec_e, vec_n};
  const int blocks = n_batch * ((ch + kC - 1) / kC);
  selective_scan_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
