// Ragged grouped GEMM on Hopper (sm_90a):
//   out[t] = x[t] @ w[tile_groups[t / block_m]]
// with x [M, K], w [G, K, N], tile_groups [M / block_m] int32, out [M, N] in
// x's dtype (float32, float16 or bfloat16), accumulated in float32.
//
// Replaces: src/repro/kernels/grouped_matmul.py, grouped_matmul ->
// _gmm_kernel (the Pallas grid (M/bm, N/bn) whose weight BlockSpec reads
// the m-tile's group id through scalar prefetch, K kept whole, N padded to
// block_n by a copy of w).
//
// Bound on this card: the larger of the bytes (x and the weights of every
// group some tile names read once, out written once, over 3.35 TB/s) and
// the 2*M*K*N operations (989 TFLOP/s dense bf16/fp16; 67 TFLOP/s for
// float32 outside the tensor cores). At the MoE FFN's shapes it is the
// bytes: granite-moe's decode reads 48 experts' [1536, 512] bf16 weights
// for 48 rows (75.5 MB, 0.0226 ms); a 512-token prefill (M = 6144) moves
// ~100 MB against 9.7 GFLOP (0.030 ms against 0.0098 ms).
//
// This first design, simple and right:
// * A block owns up to BM rows of ONE m-tile and 64 output columns. The
//   grid's x axis walks m-tiles and, inside each, chunks of BM rows
//   (ceil(block_m / BM) of them), so a block's rows always share a group,
//   for any block_m >= 1: decode gives block_m = 1 (one expert row each),
//   prefill 32-128. BM is 64 when block_m >= 64, else 16, to waste fewer
//   rows on small tiles; the rows past the tile's end are staged as 0 and
//   never stored.
// * The block reads its group id itself (the role of Pallas's scalar
//   prefetch). An id outside [0, G) makes the block write nothing and set
//   *err = 1; no load ever leaves w. The wrapper raises on the flag.
// * K is looped over in tiles staged in shared memory (16-byte vector
//   loads when K, N and the pointers allow, else element loads), with
//   every edge bounds-checked: any K, and any N with no padding copy.
// * float16 / bfloat16: WMMA 16x16x16 tensor-core products (mma.sync
//   underneath) into float32 accumulator fragments, 4 warps a block; the
//   tile goes through shared memory to the bounds-checked store.
//   float32: a 256-thread FMA tile, each thread TM x 4 outputs.
// * Deterministic: no split-K and no atomics; every output's sum runs over
//   K in one fixed order, so the same inputs give the same bits.
// wgmma, TMA and a multi-stage pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int kBN = 64;  // output columns per block

struct Params {
  const void* x;            // [M, K]
  const void* w;            // [G, K, N]
  const int* tile_groups;   // [M / block_m]
  void* out;                // [M, N]
  int* err;                 // [1], set to 1 by a block whose group id is bad
  int m, k, n, g, block_m;
  int chunks;               // blocks along M per m-tile: ceil(block_m / BM)
  int vec_x, vec_w;         // 16-byte loads allowed for x / w
};

// float32 -> the 16-bit output type, round to nearest even.
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

// The block's m-tile, first row, row count and group id; false (after
// raising the flag) when the group id is outside [0, G).
struct Tile {
  int row0, rows, gid;
};

template <int BM>
__device__ __forceinline__ bool block_tile(const Params& p, Tile* t) {
  const int tile = blockIdx.x / p.chunks;
  const int sub = blockIdx.x - tile * p.chunks;
  t->row0 = tile * p.block_m + sub * BM;
  t->rows = min(BM, p.block_m - sub * BM);
  t->gid = p.tile_groups[tile];
  if (t->gid < 0 || t->gid >= p.g) {
    if (threadIdx.x == 0) *p.err = 1;  // every writer stores the same value
    return false;
  }
  return true;
}

// dst[r * LD + c] = src[r * ld_src + c] for r < r_lim, c < c_lim, else 0.
// With vec, 8 elements a load: c_lim and ld_src are multiples of 8 and src
// is 16-byte aligned, so a vector is wholly inside or wholly outside.
template <typename T, int R, int C, int LD, int kThreads>
__device__ __forceinline__ void stage(T* dst, const T* src, size_t ld_src, int r_lim,
                                      int c_lim, bool vec) {
  if (vec) {
    constexpr int V = C / 8;
    for (int i = threadIdx.x; i < R * V; i += kThreads) {
      const int r = i / V;
      const int c = (i - r * V) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < r_lim && c < c_lim) v = *reinterpret_cast<const uint4*>(src + r * ld_src + c);
      *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < R * C; i += kThreads) {
      const int r = i / C;
      const int c = i - r * C;
      dst[r * LD + c] = (r < r_lim && c < c_lim) ? src[r * ld_src + c] : from_f<T>(0.0f);
    }
  }
}

// float16 / bfloat16 on the tensor cores. WM x WN warps; each warp owns
// FM x FN fragments of 16 x 16.
template <typename T, int BM, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32)
gmm_tc_kernel(Params p) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int BK = 64;
  constexpr int FM = BM / (WM * 16);
  constexpr int FN = kBN / (WN * 16);
  static_assert(FM * WM * 16 == BM && FN * WN * 16 == kBN, "warp tiling");
  // Row strides: 16-byte aligned rows (WMMA and the vector stores need
  // it), an odd number of 16-byte units (fewer bank conflicts).
  constexpr int LDA = BK + 8;
  constexpr int LDB = kBN + 8;
  constexpr int LDC = kBN + 4;  // float32
  constexpr int A_BYTES = BM * LDA * static_cast<int>(sizeof(T));
  constexpr int B_BYTES = BK * LDB * static_cast<int>(sizeof(T));
  constexpr int C_BYTES = BM * LDC * 4;
  constexpr int SMEM = (A_BYTES + B_BYTES) > C_BYTES ? (A_BYTES + B_BYTES) : C_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  T* as = reinterpret_cast<T*>(smem);
  T* bs = reinterpret_cast<T*>(smem + A_BYTES);
  float* cs = reinterpret_cast<float*>(smem);  // reused after the K loop

  Tile t;
  if (!block_tile<BM>(p, &t)) return;
  const int n0 = blockIdx.y * kBN;
  const T* x = static_cast<const T*>(p.x) + static_cast<size_t>(t.row0) * p.k;
  const T* w = static_cast<const T*>(p.w) + static_cast<size_t>(t.gid) * p.k * p.n + n0;

  const int warp = threadIdx.x / 32;
  const int wm = warp / WN;
  const int wn = warp - wm * WN;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < p.k; k0 += BK) {
    stage<T, BM, BK, LDA, kThreads>(as, x + k0, p.k, t.rows, p.k - k0, p.vec_x);
    stage<T, BK, kBN, LDB, kThreads>(bs, w + static_cast<size_t>(k0) * p.n, p.n, p.k - k0,
                                     p.n - n0, p.vec_w);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], as + (wm * FM + i) * 16 * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], bs + kk * LDB + (wn * FN + j) * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(cs + (wm * FM + i) * 16 * LDC + (wn * FN + j) * 16, acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();
  T* out = static_cast<T*>(p.out) + static_cast<size_t>(t.row0) * p.n + n0;
  const int cols = min(kBN, p.n - n0);
  for (int i = threadIdx.x; i < t.rows * kBN; i += kThreads) {
    const int r = i / kBN;
    const int c = i - r * kBN;
    if (c < cols) out[static_cast<size_t>(r) * p.n + c] = from_f<T>(cs[r * LDC + c]);
  }
}

// float32 with FMAs: 256 threads, thread (ty, tx) owns rows ty*TM .. +TM
// and columns tx + 16*j, j < 4.
template <int BM>
__global__ void __launch_bounds__(256)
gmm_f32_kernel(Params p) {
  constexpr int kThreads = 256;
  constexpr int BK = 16;
  constexpr int TM = BM / 16;
  __shared__ float as[BK][BM + 1];  // transposed: as[k][row]
  __shared__ float bs[BK][kBN];

  Tile t;
  if (!block_tile<BM>(p, &t)) return;
  const int n0 = blockIdx.y * kBN;
  const float* x = static_cast<const float*>(p.x) + static_cast<size_t>(t.row0) * p.k;
  const float* w =
      static_cast<const float*>(p.w) + static_cast<size_t>(t.gid) * p.k * p.n + n0;
  const int cols = min(kBN, p.n - n0);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x - ty * 16;

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < p.k; k0 += BK) {
    const int klim = min(BK, p.k - k0);
    for (int i = threadIdx.x; i < BM * BK; i += kThreads) {
      const int r = i / BK;
      const int c = i - r * BK;
      as[c][r] = (r < t.rows && c < klim) ? x[static_cast<size_t>(r) * p.k + k0 + c] : 0.0f;
    }
    for (int i = threadIdx.x; i < BK * kBN; i += kThreads) {
      const int r = i / kBN;
      const int c = i - r * kBN;
      bs[r][c] = (r < klim && c < cols) ? w[static_cast<size_t>(k0 + r) * p.n + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = as[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = static_cast<float*>(p.out) + static_cast<size_t>(t.row0) * p.n + n0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    if (r >= t.rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (c < cols) out[static_cast<size_t>(r) * p.n + c] = acc[i][j];
    }
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

template <int BM>
int launch(Params p, int dtype, cudaStream_t stream) {
  p.chunks = (p.block_m + BM - 1) / BM;
  const dim3 grid(static_cast<unsigned>((p.m / p.block_m) * p.chunks), (p.n + kBN - 1) / kBN);
  // BM 64: 2 x 2 warps of 2 x 2 fragments; BM 16: 1 x 4 warps of one each.
  constexpr int WM = BM == 64 ? 2 : 1;
  constexpr int WN = BM == 64 ? 2 : 4;
  if (dtype == 0) {
    gmm_f32_kernel<BM><<<grid, 256, 0, stream>>>(p);
  } else if (dtype == 1) {
    gmm_tc_kernel<__nv_bfloat16, BM, WM, WN><<<grid, WM * WN * 32, 0, stream>>>(p);
  } else {
    gmm_tc_kernel<__half, BM, WM, WN><<<grid, WM * WN * 32, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. The caller guarantees
// block_m >= 1 and m % block_m == 0. Returns cudaGetLastError() after the
// launch (0 on success), or -1 for a dtype code it does not take.
extern "C" int acs_grouped_matmul(const void* x, const void* w, const int* tile_groups,
                                  void* out, int* err, int m, int k, int n, int g,
                                  int block_m, int dtype, void* stream) {
  if (dtype < 0 || dtype > 2) return -1;
  if (m == 0 || n == 0) return 0;
  Params p{};
  p.x = x;
  p.w = w;
  p.tile_groups = tile_groups;
  p.out = out;
  p.err = err;
  p.m = m;
  p.k = k;
  p.n = n;
  p.g = g;
  p.block_m = block_m;
  p.vec_x = (k % 8 == 0) && aligned16(x);
  p.vec_w = (n % 8 == 0) && aligned16(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return block_m >= 64 ? launch<64>(p, dtype, s) : launch<16>(p, dtype, s);
}
