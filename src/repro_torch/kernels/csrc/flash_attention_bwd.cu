// Flash attention's backward on Hopper (sm_90a) in float32: dQ, dK and dV
// from q, k, v, the forward's output o, its row log-sum-exp lse and the
// output's gradient dO.
//
// Replaces: no Pallas kernel. The reference's flash_attention
// (src/repro/kernels/flash_attention.py, flash_attention -> _flash_kernel)
// has no VJP, so the reference trains through XLA's derivative of its jnp
// oracle (ref.attention_ref). The forward here is flash_attention.cu; its
// lse output is what this file recomputes the probabilities from.
//
// Semantics are the plain version's (kernels/ref.py attention_bwd_ref),
// with s the scaled score q.k * scale, s' = softcap * tanh(s / softcap)
// (or s), P = exp(s' - lse) on visible keys and 0 elsewhere:
//   Di = rowsum(dO * O)                      (a prologue kernel)
//   dP = dO V^T,  dS = P * (dP - Di) * (1 - tanh^2)   (the last factor only with softcap)
//   dQ = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO,
// dK and dV summed over the query heads of a kv group (GQA). The masks are
// the forward's: causal at q_offset, a sliding window, prefix_len keys
// visible to every row, a ragged Sk. A row that sees no key (lse -inf)
// contributes nothing. q and k of width D, v of width Dv (MLA: 192 and
// 128): Dv == D up to 256, or Dv != D with both up to 256.
//
// This file is the float32 path (flash_attention.py backward_path:
// "fma_f32"), the tolerance tests' path. bfloat16 and float16 take
// flash_attention_bwd_wgmma.cu (wgmma, TMA, the key-tile pass split over
// the card by the wrapper's plan), through an aligned, zero-padded copy
// where TMA cannot address the tensors themselves.
//
// Design, FlashAttention-2's backward in two passes, deterministic: there
// are no atomics and no split of a sum across blocks, so every sum runs in
// one fixed order and the same inputs give the same bits run after run.
// * Prologue: one warp a row computes Di (a butterfly sum).
// * Key-tile pass (dK, dV) and query-tile pass (dQ) on scalar FMAs, the
//   forward's scalar design with the roles of rows and keys swapped in
//   the key-tile pass.

#include "flash_attention_bwd.cuh"
#include "sm90_tiles.cuh"

#include <cmath>
#include <cstddef>

namespace {

using namespace flash_bwd;
using namespace sm90;

#if !defined(ACS_FLASH_BWD_MAX_D)
#error "build through flash_attention.py, which defines the head widths"
#endif

constexpr int kMaxD = ACS_FLASH_BWD_MAX_D;  // D and Dv up to this width
static_assert(kMaxD % 32 == 0, "a lane holds kMaxD / 32 gradient columns");

// ---------------------------------------------------------------------------
// Prologue: Di = rowsum(dO * O), one warp a row
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kDotThreads) flash_bwd_dot_kernel(const Params p) {
  const size_t row = (static_cast<size_t>(blockIdx.x) * kDotThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<size_t>(p.n_batch) * p.n_heads * p.sq) return;  // warp-uniform
  const float* o = static_cast<const float*>(p.o) + row * p.dim_v;
  const float* d = static_cast<const float*>(p.dout) + row * p.dim_v;
  float acc = 0.0f;
  for (int c = lane; c < p.dim_v; c += 32) acc += o[c] * d[c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) p.di[row] = acc;
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs (the tolerance tests' path)
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPerWarp = 4;                // rows (dQ) or keys (dK/dV) a warp owns
constexpr int kBlockRows = kWarps * kPerWarp;
constexpr int kTile = 32;                  // streamed keys (dQ) or queries (dK/dV): one a lane
constexpr int kColsPerLane = kMaxD / 32;   // gradient columns a lane holds

__device__ __forceinline__ float dot_row(const float* a, const float* b, int dim) {
  float s = 0.0f;
  for (int d = 0; d < dim; ++d) s += a[d] * b[d];
  return s;
}

// dQ: a block owns kBlockRows query rows of one (batch, head); lane j of
// each warp takes key j of a 32-key tile.
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dim = p.dim, dim_v = p.dim_v;
  float* q_s = reinterpret_cast<float*>(smem);  // [kBlockRows][dim]
  float* do_s = q_s + kBlockRows * dim;         // [kBlockRows][dim_v]
  float* k_s = do_s + kBlockRows * dim_v;       // [kTile][stride]
  float* v_s = k_s + kTile * p.stride;          // [kTile][stride_v]

  const int n_qt = (p.sq + kBlockRows - 1) / kBlockRows;
  int blk = blockIdx.x;
  const int qt = blk % n_qt;
  blk /= n_qt;
  const int h = blk % p.n_heads;
  const int bi = blk / p.n_heads;
  const int hk = h / (p.n_heads / p.n_kv_heads);
  const int q0 = qt * kBlockRows;
  const int rows_here = min(kBlockRows, p.sq - q0);
  const size_t row_base = (static_cast<size_t>(bi) * p.n_heads + h) * p.sq + q0;
  const size_t kv_row = (static_cast<size_t>(bi) * p.n_kv_heads + hk) * p.sk;
  const float* kg = static_cast<const float*>(p.k) + kv_row * dim;
  const float* vg = static_cast<const float*>(p.v) + kv_row * dim_v;

  for (int i = threadIdx.x; i < kBlockRows * dim; i += kThreads) {
    const bool ok = i < rows_here * dim;
    q_s[i] = ok ? static_cast<const float*>(p.q)[row_base * dim + i] : 0.0f;
  }
  for (int i = threadIdx.x; i < kBlockRows * dim_v; i += kThreads) {
    const bool ok = i < rows_here * dim_v;
    do_s[i] = ok ? static_cast<const float*>(p.dout)[row_base * dim_v + i] : 0.0f;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float lse[kPerWarp], di[kPerWarp], acc[kPerWarp][kColsPerLane];
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const int local = warp * kPerWarp + r;
    lse[r] = local < rows_here ? p.lse[row_base + local] : -INFINITY;
    di[r] = local < rows_here ? p.di[row_base + local] : 0.0f;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) acc[r][c] = 0.0f;
  }
  const int row_lo = p.q_offset + q0;
  const int row_hi = row_lo + rows_here - 1;

  for (int k0 = 0; k0 < p.sk; k0 += kTile) {
    const int nk = min(kTile, p.sk - k0);
    if (k0 >= p.prefix_len) {  // no prefix key in the tile: skip it if no row sees it
      if (p.causal && k0 > row_hi) break;
      if (p.has_window && k0 + nk - 1 <= row_lo - p.window) continue;
    }
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < nk * dim; i += kThreads) {
      const int j = i / dim;
      k_s[j * p.stride + i - j * dim] = kg[static_cast<size_t>(k0) * dim + i];
    }
    for (int i = threadIdx.x; i < nk * dim_v; i += kThreads) {
      const int j = i / dim_v;
      v_s[j * p.stride_v + i - j * dim_v] = vg[static_cast<size_t>(k0) * dim_v + i];
    }
    __syncthreads();
    const int col = k0 + lane;
    const bool key_ok = lane < nk;
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r) {
      const int local = warp * kPerWarp + r;
      if (local >= rows_here) break;  // warp-uniform
      float ds = 0.0f;
      if (key_ok && lse[r] != -INFINITY && visible(p, row_lo + local, col)) {
        const float s = dot_row(q_s + local * dim, k_s + lane * p.stride, dim);
        const float dpv = dot_row(do_s + local * dim_v, v_s + lane * p.stride_v, dim_v);
        float sc = s * p.scale, fac = 1.0f;
        if (p.has_softcap) {
          const float th = tanhf(sc / p.softcap);
          sc = p.softcap * th;
          fac = 1.0f - th * th;
        }
        ds = expf(sc - lse[r]) * (dpv - di[r]) * fac;
      }
      for (int jj = 0; jj < nk; ++jj) {
        const float dsv = __shfl_sync(kFull, ds, jj);
        const float* krow = k_s + jj * p.stride;
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) {
          const int d = lane + 32 * c;
          if (d < dim) acc[r][c] += dsv * krow[d];
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const int local = warp * kPerWarp + r;
    if (local >= rows_here) break;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < dim)
        static_cast<float*>(p.dq)[(row_base + local) * dim + d] = acc[r][c] * p.scale;
    }
  }
}

// dK and dV: a block owns kBlockRows keys of one (batch, kv head); lane j
// of each warp takes query j of a 32-row tile of each head of the group.
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_f32_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dim = p.dim, dim_v = p.dim_v;
  float* k_s = reinterpret_cast<float*>(smem);  // [kBlockRows][dim]
  float* v_s = k_s + kBlockRows * dim;          // [kBlockRows][dim_v]
  float* q_s = v_s + kBlockRows * dim_v;        // [kTile][stride]
  float* do_s = q_s + kTile * p.stride;         // [kTile][stride_v]
  float* lse_s = do_s + kTile * p.stride_v;     // [kTile]
  float* di_s = lse_s + kTile;                  // [kTile]

  const int n_kt = (p.sk + kBlockRows - 1) / kBlockRows;
  int blk = blockIdx.x;
  const int kt = blk % n_kt;
  blk /= n_kt;
  const int hk = blk % p.n_kv_heads;
  const int bi = blk / p.n_kv_heads;
  const int group = p.n_heads / p.n_kv_heads;
  const int k0 = kt * kBlockRows;
  const int keys_here = min(kBlockRows, p.sk - k0);
  const size_t kv_row = (static_cast<size_t>(bi) * p.n_kv_heads + hk) * p.sk + k0;
  const size_t kv_base = kv_row * dim, v_base = kv_row * dim_v;

  for (int i = threadIdx.x; i < kBlockRows * dim; i += kThreads) {
    const bool ok = i < keys_here * dim;
    k_s[i] = ok ? static_cast<const float*>(p.k)[kv_base + i] : 0.0f;
  }
  for (int i = threadIdx.x; i < kBlockRows * dim_v; i += kThreads) {
    const bool ok = i < keys_here * dim_v;
    v_s[i] = ok ? static_cast<const float*>(p.v)[v_base + i] : 0.0f;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float dk[kPerWarp][kColsPerLane], dv[kPerWarp][kColsPerLane];
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) dk[r][c] = dv[r][c] = 0.0f;
  }
  const int k_hi = k0 + keys_here - 1;

  for (int hq = 0; hq < group; ++hq) {
    const int h = hk * group + hq;
    const size_t head_base = (static_cast<size_t>(bi) * p.n_heads + h) * p.sq;
    for (int q0 = 0; q0 < p.sq; q0 += kTile) {
      const int nq = min(kTile, p.sq - q0);
      const int row_lo = p.q_offset + q0;
      if (k0 >= p.prefix_len) {  // no prefix key in the tile: skip rows that see none
        if (p.causal && row_lo + nq - 1 < k0) continue;
        if (p.has_window && row_lo > k_hi + p.window - 1) continue;
      }
      __syncthreads();  // the previous tile's readers are done
      const float* qg = static_cast<const float*>(p.q) + (head_base + q0) * dim;
      const float* dog = static_cast<const float*>(p.dout) + (head_base + q0) * dim_v;
      for (int i = threadIdx.x; i < nq * dim; i += kThreads) {
        const int j = i / dim;
        q_s[j * p.stride + i - j * dim] = qg[i];
      }
      for (int i = threadIdx.x; i < nq * dim_v; i += kThreads) {
        const int j = i / dim_v;
        do_s[j * p.stride_v + i - j * dim_v] = dog[i];
      }
      for (int i = threadIdx.x; i < nq; i += kThreads) {
        lse_s[i] = p.lse[head_base + q0 + i];
        di_s[i] = p.di[head_base + q0 + i];
      }
      __syncthreads();
      const bool q_ok = lane < nq;
#pragma unroll
      for (int r = 0; r < kPerWarp; ++r) {
        const int local = warp * kPerWarp + r;
        if (local >= keys_here) break;  // warp-uniform
        float pj = 0.0f, ds = 0.0f;
        if (q_ok && lse_s[lane] != -INFINITY && visible(p, row_lo + lane, k0 + local)) {
          const float s = dot_row(q_s + lane * p.stride, k_s + local * dim, dim);
          const float dpv = dot_row(do_s + lane * p.stride_v, v_s + local * dim_v, dim_v);
          float sc = s * p.scale, fac = 1.0f;
          if (p.has_softcap) {
            const float th = tanhf(sc / p.softcap);
            sc = p.softcap * th;
            fac = 1.0f - th * th;
          }
          pj = expf(sc - lse_s[lane]);
          ds = pj * (dpv - di_s[lane]) * fac;
        }
        for (int jj = 0; jj < nq; ++jj) {
          const float pv = __shfl_sync(kFull, pj, jj);
          const float dsv = __shfl_sync(kFull, ds, jj);
          const float* qrow = q_s + jj * p.stride;
          const float* dorow = do_s + jj * p.stride_v;
#pragma unroll
          for (int c = 0; c < kColsPerLane; ++c) {
            const int d = lane + 32 * c;
            if (d < dim_v) dv[r][c] += pv * dorow[d];
            if (d < dim) dk[r][c] += dsv * qrow[d];
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const int local = warp * kPerWarp + r;
    if (local >= keys_here) break;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < dim)
        static_cast<float*>(p.dk)[kv_base + static_cast<size_t>(local) * dim + d] =
            dk[r][c] * p.scale;
      if (d < dim_v)
        static_cast<float*>(p.dv)[v_base + static_cast<size_t>(local) * dim_v + d] = dv[r][c];
    }
  }
}

int launch_f32(Params p, cudaStream_t stream) {
  p.stride = p.dim | 1;  // odd word strides: lane j's read of row j in its own bank
  p.stride_v = p.dim_v | 1;
  const size_t smem_kv = sizeof(float) * (kBlockRows * (p.dim + p.dim_v) +
                                          kTile * (p.stride + p.stride_v) + 2 * kTile);
  const size_t smem_q = sizeof(float) * (kBlockRows * (p.dim + p.dim_v) +
                                         kTile * (p.stride + p.stride_v));
  bool kv_opted = false, q_opted = false;  // the sizes follow D: opt in at every launch
  int err = opt_in(flash_bwd_dkdv_f32_kernel, smem_kv, kv_opted);
  if (err) return err;
  err = opt_in(flash_bwd_dq_f32_kernel, smem_q, q_opted);
  if (err) return err;
  const int n_kt = (p.sk + kBlockRows - 1) / kBlockRows;
  flash_bwd_dkdv_f32_kernel<<<n_kt * p.n_batch * p.n_kv_heads, kThreads, smem_kv, stream>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int n_qt = (p.sq + kBlockRows - 1) / kBlockRows;
  flash_bwd_dq_f32_kernel<<<n_qt * p.n_batch * p.n_heads, kThreads, smem_q, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_dot(const Params& p, cudaStream_t stream) {
  const size_t rows = static_cast<size_t>(p.n_batch) * p.n_heads * p.sq;
  const size_t per_block = kDotThreads / 32;
  flash_bwd_dot_kernel<<<(rows + per_block - 1) / per_block, kDotThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 (the only one: bfloat16 and float16 take
// flash_attention_bwd_wgmma.cu); q, k, v, o, dout, dq, dk and dv share it;
// q, k, dq and dk are dim wide, v, o, dout and dv dim_v wide (each 1 to
// 256); lse is the forward's float32 [B, H, Sq]
// output and di a float32 [B, H, Sq] scratch buffer. Launches the
// prologue, the key-tile pass and the query-tile pass on stream, in that
// order. Returns cudaGetLastError() after the first launch that fails (0
// on success), or -1 for a dtype code or width it has no instantiation
// for.
extern "C" int acs_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const float* lse,
                                       float* di, void* dq, void* dk, void* dv, int n_batch,
                                       int n_heads, int n_kv_heads, int sq, int sk, int dim,
                                       int dim_v, int dtype, float scale, int causal,
                                       int has_window,
                                       int window, int has_softcap, float softcap,
                                       int q_offset, int prefix_len, void* stream) {
  if (dim < 1 || dim > kMaxD || dim_v < 1 || dim_v > kMaxD || dtype != 0) return -1;
  Params p{q, k, v, o, dout, lse, di, dq, dk, dv, n_batch, n_heads, n_kv_heads, sq, sk, dim,
           dim_v, 0, 0, scale, causal, has_window, window, has_softcap, softcap, q_offset,
           prefix_len};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_dot(p, s);
  return err ? err : launch_f32(p, s);
}
