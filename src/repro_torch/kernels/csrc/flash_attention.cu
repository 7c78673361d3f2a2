// Online-softmax attention (flash attention) on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention ->
// _flash_kernel (the Pallas kernel whose innermost key-block grid axis
// carries m, l and acc in VMEM scratch, over Sq and Sk padded to blocks).
//
// Bound on this card: the larger of the bytes (q, k, v read once, o
// written once, over 3.35 TB/s) and the visible score and PV operations
// (4 * B * H * sum over rows of the keys each row sees * D, over
// 989 TFLOP/s for bf16). At the serving prefill shapes it is the bytes.
//
// Semantics are the plain version's (kernels/ref.py attention_ref): GQA
// (query head h reads kv head h / (H / Hkv)), a causal mask at a global
// q_offset, a sliding window (key kept iff col > row - window), prefix_len
// keys visible to every row, a softcap softcap * tanh(s / softcap), and
// a ragged Sk with no padding copy. A masked key contributes exactly 0
// (it is skipped, never filled with -1e30 as the Pallas body does), so a
// row that sees no key ends with l == 0 and writes 0.
//
// This first design: one block of 4 warps per (batch, head, 16-row query
// tile). The query tile is staged once in shared memory as float32; the
// keys and values are looped over in tiles of 32, staged in shared memory
// in the input dtype with an odd word stride per row (no bank conflicts
// when lane j reads key j). Each warp owns 4 query rows: lane j computes
// the score of key j for its 4 rows, the warp reduces the tile's max and
// sum by butterfly shuffles, and each lane keeps D/32 output columns of
// the float32 accumulator in registers. Key tiles wholly outside the
// causal and window range of the block's rows are skipped. There are no
// atomics and every sum runs in one fixed order, so the same inputs give
// the same bits run after run. No tensor cores, wgmma or TMA yet: those
// are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // 16 query rows per block
constexpr int kBlockK = 32;                     // keys per tile: one per lane
constexpr int kMaxD = 256;
constexpr int kColsPerLane = kMaxD / 32;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

struct Params {
  const void* q;  // [B, H, Sq, D]
  const void* k;  // [B, Hkv, Sk, D]
  const void* v;  // [B, Hkv, Sk, D]
  void* o;        // [B, H, Sq, D]
  int n_batch, n_heads, n_kv_heads, sq, sk, dim;
  int kv_stride;  // shared-memory row stride of the k and v tiles, in elements
  float scale;
  int causal;
  int has_window, window;
  int has_softcap;
  float softcap;
  int q_offset, prefix_len;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// Butterfly sum: lane i adds partner i^o's partial, and fp addition is
// commutative, so every lane ends with the same bits.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dim = p.dim;
  float* q_s = reinterpret_cast<float*>(smem);                        // [kBlockQ][dim]
  T* k_s = reinterpret_cast<T*>(smem + sizeof(float) * kBlockQ * dim);  // [kBlockK][kv_stride]
  T* v_s = k_s + static_cast<size_t>(kBlockK) * p.kv_stride;

  const int n_qt = (p.sq + kBlockQ - 1) / kBlockQ;
  int blk = blockIdx.x;
  const int qt = blk % n_qt;
  blk /= n_qt;
  const int h = blk % p.n_heads;
  const int bi = blk / p.n_heads;
  const int hk = h / (p.n_heads / p.n_kv_heads);
  const int q0 = qt * kBlockQ;
  const int rows_here = min(kBlockQ, p.sq - q0);

  const T* qg = static_cast<const T*>(p.q) +
                ((static_cast<size_t>(bi) * p.n_heads + h) * p.sq + q0) * dim;
  const T* kg = static_cast<const T*>(p.k) +
                (static_cast<size_t>(bi) * p.n_kv_heads + hk) * p.sk * dim;
  const T* vg = static_cast<const T*>(p.v) +
                (static_cast<size_t>(bi) * p.n_kv_heads + hk) * p.sk * dim;
  T* og = static_cast<T*>(p.o) + ((static_cast<size_t>(bi) * p.n_heads + h) * p.sq + q0) * dim;

  for (int i = threadIdx.x; i < kBlockQ * dim; i += kThreads)
    q_s[i] = i < rows_here * dim ? to_f<T>(qg[i]) : 0.0f;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) acc[r][c] = 0.0f;
  }

  // Global positions of the block's first and last query rows.
  const int row_lo = p.q_offset + q0;
  const int row_hi = row_lo + rows_here - 1;
  const float* q_w = q_s + warp * kRowsPerWarp * dim;

  for (int k0 = 0; k0 < p.sk; k0 += kBlockK) {
    const int nk = min(kBlockK, p.sk - k0);
    if (k0 >= p.prefix_len) {  // no prefix key in the tile: skip it if no row sees it
      if (p.causal && k0 > row_hi) break;  // every later tile is causal-masked too
      if (p.has_window && k0 + nk - 1 <= row_lo - p.window) continue;
    }
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < nk * dim; i += kThreads) {
      const int j = i / dim;
      const int d = i - j * dim;
      k_s[j * p.kv_stride + d] = kg[static_cast<size_t>(k0) * dim + i];
      v_s[j * p.kv_stride + d] = vg[static_cast<size_t>(k0) * dim + i];
    }
    __syncthreads();

    // Lane j scores key k0 + j against the warp's rows.
    const int col = k0 + lane;
    const bool key_ok = lane < nk;
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.0f;
    if (key_ok) {
      const T* krow = k_s + lane * p.kv_stride;
      for (int d = 0; d < dim; ++d) {
        const float kd = to_f<T>(krow[d]);
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) s[r] += q_w[r * dim + d] * kd;
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int local = warp * kRowsPerWarp + r;
      if (local >= rows_here) break;  // warp-uniform
      const int row = row_lo + local;
      bool vis = true;
      if (p.causal) vis = col <= row;
      if (p.has_window) vis = vis && col > row - p.window;
      if (p.prefix_len > 0) vis = vis || col < p.prefix_len;
      vis = vis && key_ok;
      float sc = s[r] * p.scale;
      if (p.has_softcap) sc = p.softcap * tanhf(sc / p.softcap);
      const float tile_max = warp_max(vis ? sc : -INFINITY);
      if (tile_max == -INFINITY) continue;  // no visible key in this tile: warp-uniform
      const float m_new = fmaxf(m[r], tile_max);
      const float alpha = expf(m[r] - m_new);  // 0 while m[r] is still -inf
      const float pj = vis ? expf(sc - m_new) : 0.0f;
      l[r] = l[r] * alpha + warp_sum(pj);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) acc[r][c] *= alpha;
      for (int jj = 0; jj < nk; ++jj) {
        const float pv = __shfl_sync(kFull, pj, jj);
        const T* vrow = v_s + jj * p.kv_stride;
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) {
          const int d = lane + 32 * c;
          if (d < dim) acc[r][c] += pv * to_f<T>(vrow[d]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int local = warp * kRowsPerWarp + r;
    if (local >= rows_here) break;
    const float inv = l[r] > 0.0f ? 1.0f / l[r] : 0.0f;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < dim) og[static_cast<size_t>(local) * dim + d] = from_f<T>(acc[r][c] * inv);
    }
  }
}

// Odd 32-bit-word stride for a row of ``dim`` elements, so that lane j's
// read of row j, column d, falls in its own bank.
int kv_stride_for(int dim, int elem) {
  if (elem == 4) return dim | 1;
  int s = dim;
  while ((s * elem / 4) % 2 == 0 || (s * elem) % 4 != 0) ++s;
  return s;
}

template <typename T>
int launch(Params p, cudaStream_t stream) {
  p.kv_stride = kv_stride_for(p.dim, sizeof(T));
  const size_t smem = sizeof(float) * kBlockQ * p.dim + 2 * sizeof(T) * kBlockK * p.kv_stride;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_qt = (p.sq + kBlockQ - 1) / kBlockQ;
  const int blocks = p.n_batch * p.n_heads * n_qt;
  flash_kernel<T><<<blocks, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. has_window/has_softcap
// select the optional masks. Returns cudaGetLastError() after the launch
// (0 on success), or -1 for a dtype code or head dim it does not take.
extern "C" int acs_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   int n_batch, int n_heads, int n_kv_heads, int sq, int sk,
                                   int dim, int dtype, float scale, int causal,
                                   int has_window, int window, int has_softcap,
                                   float softcap, int q_offset, int prefix_len,
                                   void* stream) {
  if (dim < 1 || dim > kMaxD) return -1;
  Params p{q, k, v, o, n_batch, n_heads, n_kv_heads, sq, sk, dim, 0, scale, causal,
           has_window, window, has_softcap, softcap, q_offset, prefix_len};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  if (dtype == 2) return launch<__half>(p, s);
  return -1;
}
