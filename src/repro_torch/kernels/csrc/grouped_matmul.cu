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
// ~100 MB against 9.7 GFLOP (0.030 ms against 0.0098 ms). Decode is a
// GEMV per expert: the only way to its bound is enough bytes of w in
// flight to cover the memory latency on every SM.
//
// float16 / bfloat16, one tiled kernel in two shapes, picked by block_m:
// * A block owns up to BM rows of ONE m-tile and BN output columns. The
//   grid walks n-tiles slowest, then m-tiles, then chunks of BM rows
//   inside an m-tile (ceil(block_m / BM) of them), so a block's rows always
//   share a group for any block_m >= 1, and the m-tiles of one group that
//   follow each other in x run side by side while their w columns are in
//   L2. Rows past the tile's end are staged as 0 and never stored.
// * K streams through a 4-stage ring of (x, w) tiles filled by 16-byte
//   cp.async copies: three tiles are in flight while the block multiplies
//   the fourth. Rows past K and columns past N land as zeros (src-size
//   0), so any K and N run with no padding copy of w.
// * Products on the tensor cores: ldmatrix (.trans for w, which is
//   row-major [K, N]) and mma.sync.m16n8k16 into float32 accumulators.
// * The epilogue rounds the accumulators to x's dtype into shared memory
//   and stores the tile with 16-byte writes.
// * Decode (block_m <= 16): BM 16, BN 64, BK 64, 4 warps of 16 columns.
//   The tile's few rows of x ride in the ring beside w (rows past block_m
//   are zero-filled); a [1536, 512] expert splits into 8 blocks, so 48
//   experts give 384 blocks, each with 24 KB of w in flight.
// * Prefill: BM 128 (BM 64 when block_m <= 64), BN 128, BK 32, 8 warps of
//   64 x 32 (32 x 32) outputs.
// * The block reads its group id itself (the role of Pallas's scalar
//   prefetch). An id outside [0, G) makes the block write nothing and set
//   *err = 1; no load ever leaves w. The wrapper raises on the flag.
// * Deterministic: no split-K and no atomics; every output's sum runs over
//   K in one fixed order, so the same inputs give the same bits.
// K, N or pointers that do not allow 16-byte copies (K or N not a multiple
// of 8) stage the same tiles with element loads.
//
// float32 keeps the first design: a 256-thread FMA tile of BM x 64, each
// thread TM x 4 outputs, K staged synchronously in tiles of 16.

#include "sm90_tiles.cuh"

#include <cstddef>
#include <cstdint>

namespace {

using namespace sm90;

struct Params {
  const void* x;            // [M, K]
  const void* w;            // [G, K, N]
  const int* tile_groups;   // [M / block_m]
  void* out;                // [M, N]
  int* err;                 // [1], set to 1 by a block whose group id is bad
  int m, k, n, g, block_m;
  int chunks;               // blocks along M per m-tile: ceil(block_m / BM)
  int m_tiles;              // M / block_m
  int vec_x, vec_w;         // 16-byte copies allowed for x / w (and out)
};

// The block's first row, row count, group id and first column; false
// (after raising the flag) when the group id is outside [0, G).
struct Tile {
  int row0, rows, gid, n0;
};

template <int BM, int BN>
__device__ __forceinline__ bool block_tile(const Params& p, Tile* t) {
  int id = static_cast<int>(blockIdx.x);
  const int chunk = id % p.chunks;
  id /= p.chunks;
  const int tile = id % p.m_tiles;
  t->n0 = (id / p.m_tiles) * BN;
  t->row0 = tile * p.block_m + chunk * BM;
  t->rows = min(BM, p.block_m - chunk * BM);
  t->gid = p.tile_groups[tile];
  if (t->gid < 0 || t->gid >= p.g) {
    if (threadIdx.x == 0) *p.err = 1;  // every writer stores the same value
    return false;
  }
  return true;
}

template <int BM, int BN, int BK, int WM, int WN, int STAGES>
struct TcShape {
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int LDA = BK + 8;  // shared row strides: 16-byte multiples, and
  static constexpr int LDB = BN + 8;  // 8 rows of an ldmatrix hit 8 distinct bank groups
  static constexpr int LDC = BN + 8;
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int STAGE_ELEMS = A_ELEMS + BK * LDB;
  static constexpr int SMEM_ELEMS =
      STAGES * STAGE_ELEMS > BM * LDC ? STAGES * STAGE_ELEMS : BM * LDC;
};

// float16 / bfloat16 on the tensor cores. WM x WN warps, each owning a
// (BM / WM) x (BN / WN) block of outputs: FM x FN mma tiles of 16 x 8.
template <typename T, int BM, int BN, int BK, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(WM * WN * 32)
gmm_tc_kernel(const Params p) {
  using S = TcShape<BM, BN, BK, WM, WN, STAGES>;
  constexpr int kThreads = S::kThreads;
  constexpr int WTM = BM / WM;
  constexpr int WTN = BN / WN;
  constexpr int FM = WTM / 16;
  constexpr int FN = WTN / 8;
  static_assert(FM * 16 == WTM && FN * 8 == WTN && FN % 2 == 0, "warp tiling");
  static_assert(BK % 16 == 0 && BN % 8 == 0, "tile shape");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  Tile t;
  if (!block_tile<BM, BN>(p, &t)) return;
  const T* x = static_cast<const T*>(p.x) + static_cast<size_t>(t.row0) * p.k;
  const T* w = static_cast<const T*>(p.w) + static_cast<size_t>(t.gid) * p.k * p.n + t.n0;
  const int cols = min(BN, p.n - t.n0);
  const int nk = (p.k + BK - 1) / BK;

  auto load = [&](int kt, int slot) {
    T* as = smem + slot * S::STAGE_ELEMS;
    T* bs = as + S::A_ELEMS;
    const int k0 = kt * BK;
    stage<T, BM, BK, S::LDA, kThreads>(as, x + k0, p.k, t.rows, p.k - k0, p.vec_x);
    stage<T, BK, BN, S::LDB, kThreads>(bs, w + static_cast<size_t>(k0) * p.n, p.n, p.k - k0,
                                       cols, p.vec_w);
  };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / WN;
  const int wn = warp - wm * WN;
  float acc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

  // Ring: tiles 0 .. STAGES-2 in flight before the loop; iteration kt waits
  // for tile kt, then refills the slot iteration kt-1 read (the barrier
  // says every thread is done with it) with tile kt + STAGES - 1.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) load(nxt, nxt % STAGES);
    cp_async_commit();

    const T* as = smem + (kt % STAGES) * S::STAGE_ELEMS;
    const T* bs = as + S::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[FM][4];
      uint32_t b[FN / 2][4];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        ldmatrix_x4(a[i], as + (wm * WTM + i * 16 + (lane & 15)) * S::LDA + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < FN / 2; ++j)
        ldmatrix_x4_trans(b[j], bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * S::LDB +
                                    wn * WTN + j * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN / 2; ++j) {
          Mma<T>::run(acc[i][2 * j], a[i], b[j][0], b[j][1]);
          Mma<T>::run(acc[i][2 * j + 1], a[i], b[j][2], b[j][3]);
        }
    }
  }

  // Epilogue: round into shared memory (the ring is free once every copy
  // has landed and every thread is past its last product), then 16-byte
  // stores of the tile's live rows and columns.
  cp_async_wait<0>();
  __syncthreads();
  T* cs = smem;  // [BM][LDC]
  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      const int r = wm * WTM + i * 16 + g;
      const int c = wn * WTN + j * 8 + 2 * tq;
      *reinterpret_cast<uint32_t*>(cs + r * S::LDC + c) = Mma<T>::pack(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<uint32_t*>(cs + (r + 8) * S::LDC + c) =
          Mma<T>::pack(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  T* out = static_cast<T*>(p.out) + static_cast<size_t>(t.row0) * p.n + t.n0;
  if (p.vec_w) {  // N % 8 == 0: whole 16-byte chunks of live columns
    constexpr int CH = BN / 8;
    for (int i = threadIdx.x; i < t.rows * CH; i += kThreads) {
      const int r = i / CH;
      const int c = (i - r * CH) * 8;
      if (c < cols)
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(r) * p.n + c) =
            *reinterpret_cast<const uint4*>(cs + r * S::LDC + c);
    }
  } else {
    for (int i = threadIdx.x; i < t.rows * BN; i += kThreads) {
      const int r = i / BN;
      const int c = i - r * BN;
      if (c < cols) out[static_cast<size_t>(r) * p.n + c] = cs[r * S::LDC + c];
    }
  }
}

// float32 with FMAs: 256 threads, thread (ty, tx) owns rows ty*TM .. +TM
// and columns tx + 16*j, j < 4.
constexpr int kF32BN = 64;

template <int BM>
__global__ void __launch_bounds__(256)
gmm_f32_kernel(const Params p) {
  constexpr int kThreads = 256;
  constexpr int BK = 16;
  constexpr int TM = BM / 16;
  __shared__ float as[BK][BM + 1];  // transposed: as[k][row]
  __shared__ float bs[BK][kF32BN];

  Tile t;
  if (!block_tile<BM, kF32BN>(p, &t)) return;
  const float* x = static_cast<const float*>(p.x) + static_cast<size_t>(t.row0) * p.k;
  const float* w =
      static_cast<const float*>(p.w) + static_cast<size_t>(t.gid) * p.k * p.n + t.n0;
  const int cols = min(kF32BN, p.n - t.n0);
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
    for (int i = threadIdx.x; i < BK * kF32BN; i += kThreads) {
      const int r = i / kF32BN;
      const int c = i - r * kF32BN;
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

  float* out = static_cast<float*>(p.out) + static_cast<size_t>(t.row0) * p.n + t.n0;
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

dim3 grid_for(Params* p, int bm, int bn) {
  p->chunks = (p->block_m + bm - 1) / bm;
  p->m_tiles = p->m / p->block_m;
  const long long blocks =
      static_cast<long long>(p->m_tiles) * p->chunks * ((p->n + bn - 1) / bn);
  return dim3(static_cast<unsigned>(blocks));
}

template <typename T, int BM, int BN, int BK, int WM, int WN, int STAGES>
int launch_tc(Params p, cudaStream_t stream) {
  using S = TcShape<BM, BN, BK, WM, WN, STAGES>;
  constexpr size_t smem = sizeof(T) * S::SMEM_ELEMS;
  static bool opted_in = false;  // above 48 KB once per instantiation
  if (smem > 48 * 1024 && !opted_in) {
    cudaError_t e = cudaFuncSetAttribute(gmm_tc_kernel<T, BM, BN, BK, WM, WN, STAGES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const dim3 grid = grid_for(&p, BM, BN);
  gmm_tc_kernel<T, BM, BN, BK, WM, WN, STAGES><<<grid, S::kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tc_shape(Params p, cudaStream_t stream) {
  if (p.block_m <= 16) return launch_tc<T, 16, 64, 64, 1, 4, 4>(p, stream);  // decode
  if (p.block_m <= 64) return launch_tc<T, 64, 128, 32, 2, 4, 4>(p, stream);
  return launch_tc<T, 128, 128, 32, 2, 4, 4>(p, stream);
}

template <int BM>
int launch_f32(Params p, cudaStream_t stream) {
  const dim3 grid = grid_for(&p, BM, kF32BN);
  gmm_f32_kernel<BM><<<grid, 256, 0, stream>>>(p);
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
  p.vec_w = (n % 8 == 0) && aligned16(w) && aligned16(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return block_m >= 64 ? launch_f32<64>(p, s) : launch_f32<16>(p, s);
  if (dtype == 1) return launch_tc_shape<__nv_bfloat16>(p, s);
  return launch_tc_shape<__half>(p, s);
}
