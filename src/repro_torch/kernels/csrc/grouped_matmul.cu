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
//
// The backward (acs_grouped_matmul_dx, acs_grouped_matmul_dw) replaces no
// Pallas kernel: the reference trains through XLA's derivative of its
// oracle (src/repro/kernels/ref.py grouped_matmul_ref). Its plain version
// is kernels/ref.py grouped_matmul_bwd_ref.
// * dx[t] = dy[t] @ w[g_t]^T is the forward's tiled kernel with the roles
//   of K and N swapped and w read transposed in place (template flag BT):
//   the w tile is staged as [BN output columns][BK contraction] straight
//   from w's rows, where the contraction (N) is contiguous, and fed to
//   mma.sync through ldmatrix without .trans, as flash feeds K in Q K^T.
//   No [G, N, K] copy of the experts' weights is made. A tile with a bad
//   group id writes zeros.
// * dw[g] = sum over g's tiles t, in tile order, of x[t]^T @ dy[t]: a
//   block owns (group, 128 rows of K, 128 columns of N) and walks that
//   group's tiles in index order, block_m rows at a time in chunks of 32,
//   through the same 4-stage cp.async ring (x's chunk [32 m][128 k] read
//   as the A operand through ldmatrix.trans, dy's as the forward's w). No
//   atomics and no split of a sum: the same inputs give the same bits, and
//   a group no tile names gets exactly 0. The group -> tiles list comes
//   from tile_groups itself: a one-block kernel (gmm_tile_table_kernel)
//   writes each group's tiles in index order (a stable counting sort, one
//   warp a group, ballots) before the dw launch, on the same stream.
// * Bound: bytes. At granite-moe-3b-a800m's training shape (40 experts x
//   C 512 rows, w [40, 1536, 512] bf16) each of dx and dw moves ~147 MB
//   (dx of w_gate: dy 21.0 MB + w 62.9 MB + dx 62.9 MB) for 32.2 GFLOP:
//   0.044 ms at 3.35 TB/s against 0.033 ms at 989 TFLOP/s.
// * float32 (the tolerance tests) on FMAs: dx is the float32 tile with w
//   read transposed; dw a 256-thread 64 x 64 tile over 16-row chunks.

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
  int* err;                 // [1], set to 1 by a block whose group id is bad (or null)
  int m, k, n, g, block_m;
  int chunks;               // blocks along M per m-tile: ceil(block_m / BM)
  int m_tiles;              // M / block_m
  int vec_x, vec_w;         // 16-byte copies allowed for x / w
  int vec_out;              // 16-byte stores allowed for out
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
    if (threadIdx.x == 0 && p.err != nullptr) *p.err = 1;  // every writer stores the same value
    return false;
  }
  return true;
}

// BT: w is read transposed (dx), its tile staged as [BN][BK].
template <int BM, int BN, int BK, int WM, int WN, int STAGES, bool BT = false>
struct TcShape {
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int LDA = BK + 8;  // shared row strides: 16-byte multiples, and
  static constexpr int LDB = BT ? BK + 8 : BN + 8;  // 8 rows of an ldmatrix hit 8
  static constexpr int LDC = BN + 8;                // distinct bank groups
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int STAGE_ELEMS = A_ELEMS + (BT ? BN : BK) * LDB;
  static constexpr int SMEM_ELEMS =
      STAGES * STAGE_ELEMS > BM * LDC ? STAGES * STAGE_ELEMS : BM * LDC;
};

// Zeros over a block's live rows and columns of out (a dx tile whose group
// id is bad).
template <typename T, int BN>
__device__ __forceinline__ void zero_tile(const Params& p, const Tile& t, int threads) {
  T* out = static_cast<T*>(p.out) + static_cast<size_t>(t.row0) * p.n + t.n0;
  const int cols = min(BN, p.n - t.n0);
  for (int i = threadIdx.x; i < t.rows * BN; i += threads) {
    const int r = i / BN;
    const int c = i - r * BN;
    if (c < cols) out[static_cast<size_t>(r) * p.n + c] = from_f<T>(0.0f);
  }
}

// float16 / bfloat16 on the tensor cores. WM x WN warps, each owning a
// (BM / WM) x (BN / WN) block of outputs: FM x FN mma tiles of 16 x 8.
// BT (dx): w is [G, N_out, K_contraction] as read, i.e. the forward's w
// transposed in place.
template <typename T, int BM, int BN, int BK, int WM, int WN, int STAGES, bool BT>
__global__ void __launch_bounds__(WM * WN * 32)
gmm_tc_kernel(const Params p) {
  using S = TcShape<BM, BN, BK, WM, WN, STAGES, BT>;
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
  if (!block_tile<BM, BN>(p, &t)) {
    if (BT) zero_tile<T, BN>(p, t, kThreads);
    return;
  }
  const T* x = static_cast<const T*>(p.x) + static_cast<size_t>(t.row0) * p.k;
  const T* w = static_cast<const T*>(p.w) + static_cast<size_t>(t.gid) * p.k * p.n +
               (BT ? static_cast<size_t>(t.n0) * p.k : static_cast<size_t>(t.n0));
  const int cols = min(BN, p.n - t.n0);
  const int nk = (p.k + BK - 1) / BK;

  auto load = [&](int kt, int slot) {
    T* as = smem + slot * S::STAGE_ELEMS;
    T* bs = as + S::A_ELEMS;
    const int k0 = kt * BK;
    stage<T, BM, BK, S::LDA, kThreads>(as, x + k0, p.k, t.rows, p.k - k0, p.vec_x);
    if (BT)
      stage<T, BN, BK, S::LDB, kThreads>(bs, w + k0, p.k, cols, p.k - k0, p.vec_w);
    else
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
      for (int j = 0; j < FN / 2; ++j) {
        if (BT)  // rows: output columns j*16 .. +15; columns: the contraction
          ldmatrix_x4(b[j], bs + (wn * WTN + j * 16 + (lane & 7) + ((lane >> 4) << 3)) * S::LDB +
                                kk + ((lane >> 3) & 1) * 8);
        else
          ldmatrix_x4_trans(b[j], bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * S::LDB +
                                      wn * WTN + j * 16 + (lane >> 4) * 8);
      }
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
  if (p.vec_out) {  // N % 8 == 0: whole 16-byte chunks of live columns
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
// and columns tx + 16*j, j < 4. BT as in gmm_tc_kernel.
constexpr int kF32BN = 64;

template <int BM, bool BT>
__global__ void __launch_bounds__(256)
gmm_f32_kernel(const Params p) {
  constexpr int kThreads = 256;
  constexpr int BK = 16;
  constexpr int TM = BM / 16;
  __shared__ float as[BK][BM + 1];  // transposed: as[k][row]
  __shared__ float bs[BK][kF32BN];

  Tile t;
  if (!block_tile<BM, kF32BN>(p, &t)) {
    if (BT) zero_tile<float, kF32BN>(p, t, kThreads);
    return;
  }
  const float* x = static_cast<const float*>(p.x) + static_cast<size_t>(t.row0) * p.k;
  const float* w = static_cast<const float*>(p.w) + static_cast<size_t>(t.gid) * p.k * p.n +
                   (BT ? static_cast<size_t>(t.n0) * p.k : static_cast<size_t>(t.n0));
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
      if (BT) {  // neighbouring threads on neighbouring contraction steps of one row
        const int c = i / BK;
        const int r = i - c * BK;
        bs[r][c] = (r < klim && c < cols) ? w[static_cast<size_t>(c) * p.k + k0 + r] : 0.0f;
      } else {
        const int r = i / kF32BN;
        const int c = i - r * kF32BN;
        bs[r][c] = (r < klim && c < cols) ? w[static_cast<size_t>(k0 + r) * p.n + c] : 0.0f;
      }
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

template <typename T, int BM, int BN, int BK, int WM, int WN, int STAGES, bool BT>
int launch_tc(Params p, cudaStream_t stream) {
  using S = TcShape<BM, BN, BK, WM, WN, STAGES, BT>;
  constexpr size_t smem = sizeof(T) * S::SMEM_ELEMS;
  static bool opted_in = false;
  const int err = opt_in(gmm_tc_kernel<T, BM, BN, BK, WM, WN, STAGES, BT>, smem, opted_in);
  if (err) return err;
  const dim3 grid = grid_for(&p, BM, BN);
  gmm_tc_kernel<T, BM, BN, BK, WM, WN, STAGES, BT><<<grid, S::kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool BT>
int launch_tc_shape(Params p, cudaStream_t stream) {
  if (p.block_m <= 16) return launch_tc<T, 16, 64, 64, 1, 4, 4, BT>(p, stream);  // decode
  if (p.block_m <= 64) return launch_tc<T, 64, 128, 32, 2, 4, 4, BT>(p, stream);
  return launch_tc<T, 128, 128, 32, 2, 4, 4, BT>(p, stream);
}

template <int BM, bool BT>
int launch_f32(Params p, cudaStream_t stream) {
  const dim3 grid = grid_for(&p, BM, kF32BN);
  gmm_f32_kernel<BM, BT><<<grid, 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool BT>
int launch_dtype(const Params& p, int dtype, cudaStream_t s) {
  if (dtype == 0) return p.block_m >= 64 ? launch_f32<64, BT>(p, s) : launch_f32<16, BT>(p, s);
  if (dtype == 1) return launch_tc_shape<__nv_bfloat16, BT>(p, s);
  return launch_tc_shape<__half, BT>(p, s);
}

// ---------------------------------------------------------------------------
// dw: the group -> tiles table, then one block per (group, K tile, N tile)
// ---------------------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTableThreads = 1024;

// offs[g] .. offs[g + 1] - 1 index order[], which lists group g's tiles in
// index order (ids outside [0, G) are in no list). One block; warp w counts
// and then places the groups w, w + 32, ...
__global__ void __launch_bounds__(kTableThreads)
gmm_tile_table_kernel(const int* __restrict__ tile_groups, int tiles, int g,
                      int* __restrict__ order, int* __restrict__ offs) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  constexpr int kWarps = kTableThreads / 32;
  for (int gid = warp; gid < g; gid += kWarps) {
    int count = 0;
    for (int base = 0; base < tiles; base += 32) {
      const int t = base + lane;
      count += __popc(__ballot_sync(kFull, t < tiles && tile_groups[t] == gid));
    }
    if (lane == 0) offs[gid + 1] = count;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    offs[0] = 0;
    for (int i = 0; i < g; ++i) offs[i + 1] += offs[i];
  }
  __syncthreads();
  for (int gid = warp; gid < g; gid += kWarps) {
    int pos = offs[gid];
    for (int base = 0; base < tiles; base += 32) {
      const int t = base + lane;
      const bool hit = t < tiles && tile_groups[t] == gid;
      const unsigned mask = __ballot_sync(kFull, hit);
      if (hit) order[pos + __popc(mask & ((1u << lane) - 1u))] = t;
      pos += __popc(mask);
    }
  }
}

struct DwParams {
  const void* x;     // [M, K]
  const void* dy;    // [M, N]
  const int* order;  // [T] tiles by group, in index order within a group
  const int* offs;   // [G + 1]
  void* dw;          // [G, K, N]
  int m, k, n, g, block_m;
  int vec_x, vec_dy, vec_out;  // 16-byte copies: K % 8 / N % 8 / N % 8 and alignment
};

// The block's (group, first K row, first N column); the group is the
// slowest index, so the blocks of one group, which read the same rows of x
// and dy, run side by side.
template <int BM, int BN>
__device__ __forceinline__ void dw_block(const DwParams& p, int* grp, int* k0, int* n0) {
  const int n_tiles = (p.n + BN - 1) / BN;
  const int k_tiles = (p.k + BM - 1) / BM;
  int id = static_cast<int>(blockIdx.x);
  *n0 = (id % n_tiles) * BN;
  id /= n_tiles;
  *k0 = (id % k_tiles) * BM;
  *grp = id / k_tiles;
}

template <typename T, int BM, int BN, int BK, int WM, int WN, int STAGES>
struct DwShape {
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int LDA = BM + 8;  // x's chunk [BK m][BM k]
  static constexpr int LDB = BN + 8;  // dy's chunk [BK m][BN n]
  static constexpr int LDC = BN + 8;
  static constexpr int A_ELEMS = BK * LDA;
  static constexpr int STAGE_ELEMS = A_ELEMS + BK * LDB;
  static constexpr int SMEM_ELEMS =
      STAGES * STAGE_ELEMS > BM * LDC ? STAGES * STAGE_ELEMS : BM * LDC;
};

// dw[g][k0 .. +BM][n0 .. +BN] on the tensor cores: the contraction runs over
// the group's tiles in index order, each in chunks of BK rows (rows past
// the tile's end staged as 0).
template <typename T, int BM, int BN, int BK, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(WM * WN * 32)
gmm_dw_tc_kernel(const DwParams p) {
  using S = DwShape<T, BM, BN, BK, WM, WN, STAGES>;
  constexpr int kThreads = S::kThreads;
  constexpr int WTM = BM / WM;
  constexpr int WTN = BN / WN;
  constexpr int FM = WTM / 16;
  constexpr int FN = WTN / 8;
  static_assert(FM * 16 == WTM && FN * 8 == WTN && FN % 2 == 0, "warp tiling");
  static_assert(BK % 16 == 0 && BM % 8 == 0 && BN % 8 == 0, "tile shape");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  int grp, k0, n0;
  dw_block<BM, BN>(p, &grp, &k0, &n0);
  const int first = p.offs[grp];
  const int chunks = (p.block_m + BK - 1) / BK;  // per tile
  const int steps = (p.offs[grp + 1] - first) * chunks;
  const T* x = static_cast<const T*>(p.x) + k0;
  const T* dy = static_cast<const T*>(p.dy) + n0;
  const int k_lim = p.k - k0;
  const int n_lim = p.n - n0;

  auto load = [&](int step, int slot) {
    T* as = smem + slot * S::STAGE_ELEMS;
    T* bs = as + S::A_ELEMS;
    const int tile = p.order[first + step / chunks];
    const int c = (step % chunks) * BK;
    const size_t m0 = static_cast<size_t>(tile) * p.block_m + c;
    const int rows = min(BK, p.block_m - c);
    stage<T, BK, BM, S::LDA, kThreads>(as, x + m0 * p.k, p.k, rows, k_lim, p.vec_x);
    stage<T, BK, BN, S::LDB, kThreads>(bs, dy + m0 * p.n, p.n, rows, n_lim, p.vec_dy);
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

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = st + STAGES - 1;
    if (nxt < steps) load(nxt, nxt % STAGES);
    cp_async_commit();

    const T* as = smem + (st % STAGES) * S::STAGE_ELEMS;
    const T* bs = as + S::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[FM][4];
      uint32_t b[FN / 2][4];
      // A = x^T: rows k, columns m; stored [m][k], so each 8 x 8 tile is
      // read transposed (tiles: k 0-7 / 8-15 across lanes 8-15, m 0-7 /
      // 8-15 across lanes 16-31).
#pragma unroll
      for (int i = 0; i < FM; ++i)
        ldmatrix_x4_trans(a[i], as + (kk + (lane & 7) + ((lane >> 4) & 1) * 8) * S::LDA +
                                    wm * WTM + i * 16 + ((lane >> 3) & 1) * 8);
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

  cp_async_wait<0>();
  __syncthreads();
  T* cs = smem;  // [BM][LDC]
  const int gq = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      const int r = wm * WTM + i * 16 + gq;
      const int c = wn * WTN + j * 8 + 2 * tq;
      *reinterpret_cast<uint32_t*>(cs + r * S::LDC + c) = Mma<T>::pack(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<uint32_t*>(cs + (r + 8) * S::LDC + c) =
          Mma<T>::pack(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  T* out = static_cast<T*>(p.dw) + (static_cast<size_t>(grp) * p.k + k0) * p.n + n0;
  const int rows = min(BM, k_lim);
  const int cols = min(BN, n_lim);
  if (p.vec_out) {
    constexpr int CH = BN / 8;
    for (int i = threadIdx.x; i < rows * CH; i += kThreads) {
      const int r = i / CH;
      const int c = (i - r * CH) * 8;
      if (c < cols)
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(r) * p.n + c) =
            *reinterpret_cast<const uint4*>(cs + r * S::LDC + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * BN; i += kThreads) {
      const int r = i / BN;
      const int c = i - r * BN;
      if (c < cols) out[static_cast<size_t>(r) * p.n + c] = cs[r * S::LDC + c];
    }
  }
}

// float32 dw with FMAs: 256 threads over a 64 x 64 tile, thread (ty, tx)
// owning K rows ty*4 .. +4 and N columns tx + 16*j, 16-row chunks.
__global__ void __launch_bounds__(256) gmm_dw_f32_kernel(const DwParams p) {
  constexpr int kThreads = 256;
  constexpr int BM = 64, BN = 64, BK = 16, TM = 4;
  __shared__ float as[BK][BM + 1];  // as[m][k] = x rows
  __shared__ float bs[BK][BN];      // bs[m][n] = dy rows

  int grp, k0, n0;
  dw_block<BM, BN>(p, &grp, &k0, &n0);
  const int first = p.offs[grp];
  const int chunks = (p.block_m + BK - 1) / BK;
  const int steps = (p.offs[grp + 1] - first) * chunks;
  const float* x = static_cast<const float*>(p.x) + k0;
  const float* dy = static_cast<const float*>(p.dy) + n0;
  const int k_lim = min(BM, p.k - k0);
  const int n_lim = min(BN, p.n - n0);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x - ty * 16;

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int st = 0; st < steps; ++st) {
    const int tile = p.order[first + st / chunks];
    const int c0 = (st % chunks) * BK;
    const size_t m0 = static_cast<size_t>(tile) * p.block_m + c0;
    const int rows = min(BK, p.block_m - c0);
    for (int i = threadIdx.x; i < BK * BM; i += kThreads) {
      const int r = i / BM;
      const int c = i - r * BM;
      as[r][c] = (r < rows && c < k_lim) ? x[(m0 + r) * p.k + c] : 0.0f;
    }
    for (int i = threadIdx.x; i < BK * BN; i += kThreads) {
      const int r = i / BN;
      const int c = i - r * BN;
      bs[r][c] = (r < rows && c < n_lim) ? dy[(m0 + r) * p.n + c] : 0.0f;
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

  float* out = static_cast<float*>(p.dw) + (static_cast<size_t>(grp) * p.k + k0) * p.n + n0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    if (r >= k_lim) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (c < n_lim) out[static_cast<size_t>(r) * p.n + c] = acc[i][j];
    }
  }
}

template <typename T>
int launch_dw_tc(const DwParams& p, cudaStream_t stream) {
  constexpr int BM = 128, BN = 128, BK = 32, WM = 2, WN = 4, STAGES = 4;
  using S = DwShape<T, BM, BN, BK, WM, WN, STAGES>;
  constexpr size_t smem = sizeof(T) * S::SMEM_ELEMS;
  static bool opted_in = false;
  const int err = opt_in(gmm_dw_tc_kernel<T, BM, BN, BK, WM, WN, STAGES>, smem, opted_in);
  if (err) return err;
  const long long blocks = static_cast<long long>(p.g) * ((p.k + BM - 1) / BM) *
                           ((p.n + BN - 1) / BN);
  gmm_dw_tc_kernel<T, BM, BN, BK, WM, WN, STAGES>
      <<<static_cast<unsigned>(blocks), S::kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_dw_f32(const DwParams& p, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(p.g) * ((p.k + 63) / 64) * ((p.n + 63) / 64);
  gmm_dw_f32_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(p);
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
  p.vec_out = p.vec_w;
  return launch_dtype<false>(p, dtype, static_cast<cudaStream_t>(stream));
}

// dx [M, K] = each tile of dy [M, N] times its group's w [G, K, N]
// transposed (read in place); a tile whose group id lies outside [0, G)
// gets zeros and sets *err (err may be null: the forward has flagged the
// same ids). Returns as acs_grouped_matmul.
extern "C" int acs_grouped_matmul_dx(const void* dy, const void* w, const int* tile_groups,
                                     void* dx, int* err, int m, int k, int n, int g,
                                     int block_m, int dtype, void* stream) {
  if (dtype < 0 || dtype > 2) return -1;
  if (m == 0 || k == 0) return 0;
  Params p{};
  p.x = dy;
  p.w = w;
  p.tile_groups = tile_groups;
  p.out = dx;
  p.err = err;
  p.m = m;
  p.k = n;  // the contraction
  p.n = k;  // the output's columns
  p.g = g;
  p.block_m = block_m;
  p.vec_x = (n % 8 == 0) && aligned16(dy);
  p.vec_w = (n % 8 == 0) && aligned16(w);
  p.vec_out = (k % 8 == 0) && aligned16(dx);
  return launch_dtype<true>(p, dtype, static_cast<cudaStream_t>(stream));
}

// dw [G, K, N]: for each group, the sum over its tiles (in index order) of
// x's tile transposed times dy's tile; 0 for a group no tile names. order
// ([M / block_m] int32) and offs ([G + 1] int32) are scratch for the group
// -> tiles table, written by the first of the two launches. Returns as
// acs_grouped_matmul.
extern "C" int acs_grouped_matmul_dw(const void* x, const void* dy, const int* tile_groups,
                                     int* order, int* offs, void* dw, int m, int k, int n,
                                     int g, int block_m, int dtype, void* stream) {
  if (dtype < 0 || dtype > 2) return -1;
  if (k == 0 || n == 0 || g == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gmm_tile_table_kernel<<<1, kTableThreads, 0, s>>>(tile_groups, m / block_m, g, order, offs);
  const int e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  DwParams p{};
  p.x = x;
  p.dy = dy;
  p.order = order;
  p.offs = offs;
  p.dw = dw;
  p.m = m;
  p.k = k;
  p.n = n;
  p.g = g;
  p.block_m = block_m;
  p.vec_x = (k % 8 == 0) && aligned16(x);
  p.vec_dy = (n % 8 == 0) && aligned16(dy);
  p.vec_out = (n % 8 == 0) && aligned16(dw);
  if (dtype == 0) return launch_dw_f32(p, s);
  if (dtype == 1) return launch_dw_tc<__nv_bfloat16>(p, s);
  return launch_dw_tc<__half>(p, s);
}
