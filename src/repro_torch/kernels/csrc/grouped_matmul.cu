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
// * dx[t] = dy[t] @ w[g_t]^T: bfloat16 / float16 on wgmma (gmm_dx_wgmma_kernel),
//   with both operands K-major as they lie in memory (dy's rows and w[g]'s
//   rows both run along the contraction N), so no transpose bit and no
//   [G, N, K] copy of the experts' weights. TMA must be able to address dy,
//   w and dx (K and N multiples of 8, aligned pointers); where it cannot,
//   the wrapper (grouped_matmul.py dx_path, "wgmma_padded") passes aligned
//   copies zero-padded to multiples of 8 columns. A persistent grid (the
//   wrapper's dx_plan: one block an SM) walks the output tiles by a linear
//   index, (m-tile, 128-row chunk of it, column tile of K) from slowest to
//   fastest, so a tile's rows never leave one m-tile (one group) and the
//   blocks running side by side read a few experts' w while it is in L2.
//   The plan also picks the tile's width, 256 or 128 columns of K, by when
//   the busiest block finishes (granite-moe: 256 for gate / up, 128 for
//   down, where 256 leaves a last round on 56 of 132 SMs). A producer
//   thread streams each tile's 64-column steps of N by TMA through a
//   3-stage mbarrier ring (4 at width 128): dy as [tile][block_m][N], two
//   64-row boxes; w[g] as [G][K][N], one box of the tile's K rows; rows
//   past block_m land as 0, and the box of a consumer warpgroup with no
//   row left in the m-tile is not loaded. Two consumer
//   warpgroups of 64 rows multiply on wgmma, one step's products in flight
//   while the next step's issue. The epilogue rounds into swizzled shared
//   memory and TMA-stores into dx as [tile][block_m][K], clipped to block_m
//   and K, while the producer already loads the next tile. A tile whose
//   group id is bad takes no step, loads nothing from w, writes zeros and
//   sets *err.
// * dw[g] = sum over g's tiles t, in tile order, of x[t]^T @ dy[t]; no
//   atomics and no split of a sum: the same inputs give the same bits, and
//   a group no tile names gets exactly 0. bfloat16 / float16 on wgmma
//   (path 1). TMA must be able to address x, dy and dw (K and N multiples
//   of 8, aligned pointers) and the groups' tile counts must fit in shared
//   memory (G <= kDwMaxGroups); where they do not, the wrapper
//   (grouped_matmul.py dw_path, "wgmma_padded") passes aligned copies of x
//   and dy zero-padded to multiples of 8 columns and launches once for
//   each run of kDwMaxGroups groups. A persistent grid (the wrapper's dw_grid: one block an
//     SM) walks the (group, 128 rows of K, 256 columns of N) tiles group
//     by group, so the blocks running side by side read one group's rows
//     of x and dy while they are in L2. A producer warp streams each
//     tile's 64-row chunks of the group's m-tiles, in tile order, by TMA
//     through a 3-stage mbarrier ring, reading x as [tile][block_m][K] and
//     dy as [tile][block_m][N] in place (rows past block_m land as 0); two
//     consumer warpgroups multiply x^T by dy on wgmma with both operands
//     MN-major in shared memory (the transpose bits: no transposed copy),
//     64 x 256 float32 accumulators each, one step's products in flight
//     while the next step's issue. The epilogue rounds into swizzled
//     shared memory and TMA-stores the tile, clipped to K and N, while the
//     producer already loads the next tile. The consumers count every
//     group's tiles once into shared memory and the producer finds them
//     with warp ballots over tile_groups: no table launch (it cost 0.0038
//     ms of the call).
// * Bound: bytes. At granite-moe-3b-a800m's training shape (40 experts x
//   C 512 rows, w [40, 1536, 512] bf16) each of dx and dw moves ~147 MB
//   (dx of w_gate: dy 21.0 MB + w 62.9 MB + dx 62.9 MB) for 32.2 GFLOP:
//   0.044 ms at 3.35 TB/s against 0.033 ms at 989 TFLOP/s.
// * float32 (the tolerance tests) on FMAs: dx is the float32 tile with w
//   read transposed (template flag BT); dw (path 0) a 256-thread 64 x 64
//   tile over 16-row chunks, after a one-block kernel (gmm_tile_table_kernel)
//   writes each group's tiles in index order (a stable counting sort, one
//   warp a group, ballots) on the same stream.

#include "sm90_tiles.cuh"
#include "sm90_wgmma.cuh"

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

template <int BM, int BN, int BK, int WM, int WN, int STAGES>
struct TcShape {
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int LDA = BK + 8;  // shared row strides: 16-byte multiples, and
  static constexpr int LDB = BN + 8;  // 8 rows of an ldmatrix hit 8
  static constexpr int LDC = BN + 8;  // distinct bank groups
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int STAGE_ELEMS = A_ELEMS + BK * LDB;
  static constexpr int SMEM_ELEMS =
      STAGES * STAGE_ELEMS > BM * LDC ? STAGES * STAGE_ELEMS : BM * LDC;
};

// float16 / bfloat16 on the tensor cores (the forward). WM x WN warps, each
// owning a (BM / WM) x (BN / WN) block of outputs: FM x FN mma tiles of
// 16 x 8.
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
// and columns tx + 16*j, j < 4. BT (dx): w is [G, N_out, K_contraction] as
// read, i.e. the forward's w transposed in place; a tile whose group id is
// bad writes zeros.
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
    if (!BT) return;
    float* out = static_cast<float*>(p.out) + static_cast<size_t>(t.row0) * p.n + t.n0;
    const int cols = min(kF32BN, p.n - t.n0);
    for (int i = threadIdx.x; i < t.rows * kF32BN; i += kThreads) {
      const int r = i / kF32BN;
      const int c = i - r * kF32BN;
      if (c < cols) out[static_cast<size_t>(r) * p.n + c] = 0.0f;
    }
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

template <typename T, int BM, int BN, int BK, int WM, int WN, int STAGES>
int launch_tc(Params p, cudaStream_t stream) {
  using S = TcShape<BM, BN, BK, WM, WN, STAGES>;
  constexpr size_t smem = sizeof(T) * S::SMEM_ELEMS;
  static bool opted_in = false;
  const int err = opt_in(gmm_tc_kernel<T, BM, BN, BK, WM, WN, STAGES>, smem, opted_in);
  if (err) return err;
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

template <int BM, bool BT>
int launch_f32(Params p, cudaStream_t stream) {
  const dim3 grid = grid_for(&p, BM, kF32BN);
  gmm_f32_kernel<BM, BT><<<grid, 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool BT>
int launch_f32_shape(const Params& p, cudaStream_t s) {
  return p.block_m >= 64 ? launch_f32<64, BT>(p, s) : launch_f32<16, BT>(p, s);
}

// ---------------------------------------------------------------------------
// float32 dw: the group -> tiles table, then one block per (group, K tile,
// N tile)
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
  const int* tile_groups;  // [T]: the wgmma kernel finds a group's tiles itself
  const int* order;  // [T] tiles by group, in index order within a group (float32)
  const int* offs;   // [G + 1] (float32)
  void* dw;          // [G, K, N]
  int m, k, n, g, block_m;
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

// ---------------------------------------------------------------------------
// dw on wgmma: a persistent grid over (group, K tile, N tile), TMA-fed
// ---------------------------------------------------------------------------

constexpr int kDwBM = 128;                 // rows of K a tile: one warpgroup each 64
constexpr int kDwBN = 256;                 // columns of N a tile
constexpr int kDwBK = 64;                  // rows of a group's tiles a stage
constexpr int kDwStages = 3;
constexpr int kDwThreads = 2 * 128 + 32;   // two consumer warpgroups, one producer warp
constexpr int kBox = 64 * 64 * 2;          // one [64][64] box of 16-bit elements
constexpr int kDwXBoxes = kDwBM / 64;
constexpr int kDwYBoxes = kDwBN / 64;
constexpr int kDwStageBytes = (kDwXBoxes + kDwYBoxes) * kBox;
constexpr int kDwEpiBytes = 2 * kDwYBoxes * kBox;  // each warpgroup's [64][BN] result
constexpr size_t kDwSmem = kDwStages * kDwStageBytes + kDwEpiBytes + 2 * kDwStages * 8 + 1024;
// Groups the wgmma kernel takes: it counts each group's tiles in shared
// memory beside its ring (int32 a group).
constexpr int kDwMaxGroups = 4096;

// Tile `tile` of the walk -> (group, first K row, first N column): the
// group slowest, so the blocks running side by side read one group's rows
// of x and dy while they are in L2.
__device__ __forceinline__ void dw_tile(const DwParams& p, int tile, int k_tiles, int n_tiles,
                                        int* grp, int* k0, int* n0) {
  *grp = tile / (k_tiles * n_tiles);
  const int rem = tile - *grp * k_tiles * n_tiles;
  *k0 = (rem / n_tiles) * kDwBM;
  *n0 = (rem - (rem / n_tiles) * n_tiles) * kDwBN;
}

// Block b takes tiles b, b + gridDim.x, ... (the grid is the wrapper's).
// A group's tiles are the m-tiles whose id names it, in index order: the
// producer warp finds them with ballots over tile_groups as it goes, and
// the consumers count every group's tiles once, at the start, into shared
// memory (no table launch). The producer warp streams each tile's
// steps (a group tile's 64-row chunks, in tile order) through a kDwStages
// ring of x and dy boxes, read
// in place as [tile][block_m][K] and [tile][block_m][N] (rows past
// block_m land as 0); each consumer warpgroup multiplies x^T (MN-major A)
// by dy (MN-major B) into 64 x 256 float32 accumulators, rounds them into
// its swizzled out tile and TMA-stores it, clipped to K and N, while the
// producer already loads the next tile.
template <typename T>
__global__ void __launch_bounds__(kDwThreads, 1)
gmm_dw_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
                    const __grid_constant__ CUtensorMap tdw, const DwParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* epi = ring + kDwStages * kDwStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + kDwEpiBytes);
  uint64_t* empty = full + kDwStages;
  int* named = reinterpret_cast<int*>(empty + kDwStages);  // [G]: tiles a group has
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int k_tiles = (p.k + kDwBM - 1) / kDwBM;
  const int n_tiles = (p.n + kDwBN - 1) / kDwBN;
  const int total = p.g * k_tiles * n_tiles;
  const int chunks = (p.block_m + kDwBK - 1) / kDwBK;
  const int warp = threadIdx.x >> 5;

  const int lane = threadIdx.x & 31;
  const int m_tiles = p.m / p.block_m;
  if (warp == 8) {  // producer: lane 0 issues every copy
    int q = 0;  // steps so far over this block's tiles
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      int grp, k0, n0;
      dw_tile(p, tile, k_tiles, n_tiles, &grp, &k0, &n0);
      for (int base = 0; base < m_tiles; base += 32) {
        unsigned hits = __ballot_sync(
            kFull, base + lane < m_tiles && p.tile_groups[base + lane] == grp);
        for (; hits; hits &= hits - 1) {
          const int t = base + __ffs(hits) - 1;
          for (int c = 0; c < p.block_m; c += kDwBK, ++q) {
            if (lane != 0) continue;
            const int s = q % kDwStages;
            mbar_wait(&empty[s], ((q / kDwStages) & 1) ^ 1);
            unsigned char* xs = ring + s * kDwStageBytes;
            unsigned char* ys = xs + kDwXBoxes * kBox;
            mbar_arrive_expect_tx(&full[s], kDwStageBytes);
#pragma unroll
            for (int b = 0; b < kDwXBoxes; ++b)
              tma_load_3d(xs + b * kBox, &tx, &full[s], k0 + 64 * b, c, t);
#pragma unroll
            for (int b = 0; b < kDwYBoxes; ++b)
              tma_load_3d(ys + b * kBox, &tdy, &full[s], n0 + 64 * b, c, t);
          }
        }
      }
    }
    return;
  }

  // Each group's tile count: integer adds, so their order does not matter.
  for (int i = threadIdx.x; i < p.g; i += 256) named[i] = 0;
  named_sync(1, 256);
  for (int t = threadIdx.x; t < m_tiles; t += 256) {
    const int id = p.tile_groups[t];
    if (id >= 0 && id < p.g) atomicAdd(&named[id], 1);
  }
  named_sync(1, 256);

  const int wg = warp >> 2;  // this warpgroup's rows: 64 wg .. 64 wg + 63 of the K tile
  const int tid = threadIdx.x & 127;
  const int wq = tid >> 5;
  const int gq = (tid & 31) >> 2;
  const int tq = tid & 3;
  unsigned char* cs = epi + wg * kDwYBoxes * kBox;
  int q = 0;
  bool stored = false;
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    int grp, k0, n0;
    dw_tile(p, tile, k_tiles, n_tiles, &grp, &k0, &n0);
    const int steps = named[grp] * chunks;
    float acc[kDwBN / 2];
#pragma unroll
    for (int i = 0; i < kDwBN / 2; ++i) acc[i] = 0.0f;
    // One step's products stay in flight while the next step's issue; a
    // stage is released once the products that read it are done.
    int held = -1;
    for (int st = 0; st < steps; ++st, ++q) {
      const int s = q % kDwStages;
      mbar_wait(&full[s], (q / kDwStages) & 1);
      const unsigned char* xs = ring + s * kDwStageBytes + wg * kBox;
      const unsigned char* ys = ring + s * kDwStageBytes + kDwXBoxes * kBox;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDwBK / 16; ++kk)
        Wgmma<T, kDwBN>::template ss<1, 1>(acc, desc_mnmajor(xs + kk * 2048, kBox),
                                           desc_mnmajor(ys + kk * 2048, kBox), 1);
      wgmma_commit();
      wgmma_wait<1>();
      if (held >= 0 && tid == 0) mbar_arrive(&empty[held]);
      held = s;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (held >= 0 && tid == 0) mbar_arrive(&empty[held]);
    // Epilogue: the previous tile's store has read cs; round into the
    // swizzled boxes; then one thread stores them.
    if (stored && tid == 0) tma_store_wait_read();
    named_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < kDwBN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * wq + gq + 8 * r;
        const int col = 8 * j + 2 * tq;
        *reinterpret_cast<uint32_t*>(cs + (col / 64) * kBox + sw128(row, (col % 64) * 2)) =
            Mma<T>::pack(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    fence_async_smem();
    named_sync(1 + wg, 128);
    if (tid == 0 && k0 + 64 * wg < p.k) {
#pragma unroll
      for (int b = 0; b < kDwYBoxes; ++b)
        if (n0 + 64 * b < p.n) tma_store_3d(&tdw, cs + b * kBox, n0 + 64 * b, k0 + 64 * wg, grp);
      tma_store_commit();
    }
    stored = true;
  }
  if (tid == 0) tma_store_wait_all();
}

template <typename T>
int launch_dw_wgmma(const DwParams& p, int grid, cudaStream_t stream) {
  const uint64_t tiles = static_cast<uint64_t>(p.m / p.block_m);
  const uint64_t bm = static_cast<uint64_t>(p.block_m);
  CUtensorMap tx, tdy, tdw;
  int err = tensor_map_3d<T>(&tx, p.x, p.k, bm, tiles, 2ull * p.k, 2ull * bm * p.k, 64);
  if (err) return err;
  err = tensor_map_3d<T>(&tdy, p.dy, p.n, bm, tiles, 2ull * p.n, 2ull * bm * p.n, 64);
  if (err) return err;
  err = tensor_map_3d<T>(&tdw, p.dw, p.n, p.k, p.g, 2ull * p.n, 2ull * p.k * p.n, 64);
  if (err) return err;
  static bool opted_in = false;  // once, for the most any G needs
  err = opt_in(gmm_dw_wgmma_kernel<T>, kDwSmem + 4 * kDwMaxGroups, opted_in);
  if (err) return err;
  gmm_dw_wgmma_kernel<T><<<grid, kDwThreads, kDwSmem + 4 * p.g, stream>>>(tx, tdy, tdw, p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// dx on wgmma: a persistent grid over (m-tile, 128-row chunk, K column tile)
// ---------------------------------------------------------------------------

constexpr int kDxBM = 128;                // rows a tile: one consumer warpgroup each 64
constexpr int kDxBK = 64;                 // columns of the contraction (N) a step
constexpr int kDxThreads = 2 * 128 + 32;  // two consumer warpgroups, one producer warp

// A tile of kDxBM rows by BN columns of K (BN 256 or 128, the plan's).
template <int BN>
struct DxShape {
  static constexpr int kStages = BN == 256 ? 3 : 4;
  static constexpr int kWBytes = BN * 128;                // w[g]'s [BN][64] box
  static constexpr int kStageBytes = 2 * kBox + kWBytes;  // dy's two [64][64] boxes, then w's
  static constexpr int kEpiBytes = 2 * (BN / 64) * kBox;  // each warpgroup's [64][BN] result
  static constexpr size_t kSmem =
      kStages * kStageBytes + kEpiBytes + 2 * kStages * sizeof(uint64_t) + 1024;
  static_assert(kSmem <= 232448, "a block's shared memory");
};

struct DxParams {
  const int* tile_groups;  // [M / block_m]
  int* err;                // [1], set to 1 for a bad group id (or null)
  int m, k, n, g, block_m;
  int chunks;     // kDxBM-row chunks an m-tile (the wrapper's plan)
  int col_tiles;  // BN-column tiles of K (the plan's)
};

// Tile `tile` of the walk -> (m-tile, first row in it, first column of K):
// the m-tile slowest, then its chunks, then the column tiles.
struct DxTile {
  int mt, row0, k0;
};

template <int BN>
__device__ __forceinline__ DxTile dx_tile(const DxParams& p, int tile) {
  const int per_mtile = p.chunks * p.col_tiles;
  const int mt = tile / per_mtile;
  const int rem = tile - mt * per_mtile;
  const int chunk = rem / p.col_tiles;
  return {mt, chunk * kDxBM, (rem - chunk * p.col_tiles) * BN};
}

// Block b takes tiles b, b + gridDim.x, ... (the grid is the wrapper's).
// Producer and consumers derive each tile's step count alike: ceil(N / 64),
// or 0 for a bad group id, so the ring's phases stay in step. The producer
// thread streams a step's dy boxes (the warpgroups' 64 rows each, read as
// [tile][block_m][N]; a warpgroup with no row left in the m-tile gets none)
// and w[g]'s [BN][64] box ([G][K][N]) through a kStages ring; each consumer
// warpgroup multiplies its dy box (K-major A) by the w box (K-major B, the
// transpose in place) into 64 x BN float32 accumulators, rounds them into
// its swizzled out tile and TMA-stores it into dx ([tile][block_m][K]),
// clipped to block_m and K, while the producer already loads the next tile.
template <typename T, int BN>
__global__ void __launch_bounds__(kDxThreads, 1)
gmm_dx_wgmma_kernel(const __grid_constant__ CUtensorMap tdy, const __grid_constant__ CUtensorMap tw,
                    const __grid_constant__ CUtensorMap tdx, const DxParams p) {
  using S = DxShape<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* epi = ring + S::kStages * S::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + S::kEpiBytes);
  uint64_t* empty = full + S::kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int total = (p.m / p.block_m) * p.chunks * p.col_tiles;
  const int steps_all = (p.n + kDxBK - 1) / kDxBK;
  const int warp = threadIdx.x >> 5;

  if (warp == 8) {  // producer: one thread issues every copy
    if (threadIdx.x != 8 * 32) return;
    int q = 0;  // steps so far over this block's tiles
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const DxTile t = dx_tile<BN>(p, tile);
      const int gid = p.tile_groups[t.mt];
      if (gid < 0 || gid >= p.g) continue;  // no step: no load leaves w
      const bool both = t.row0 + 64 < p.block_m;
      for (int st = 0; st < steps_all; ++st, ++q) {
        const int s = q % S::kStages;
        mbar_wait(&empty[s], ((q / S::kStages) & 1) ^ 1);
        unsigned char* ys = ring + s * S::kStageBytes;
        mbar_arrive_expect_tx(&full[s], (both ? 2 : 1) * kBox + S::kWBytes);
        tma_load_3d(ys, &tdy, &full[s], st * kDxBK, t.row0, t.mt);
        if (both) tma_load_3d(ys + kBox, &tdy, &full[s], st * kDxBK, t.row0 + 64, t.mt);
        tma_load_3d(ys + 2 * kBox, &tw, &full[s], st * kDxBK, t.k0, gid);
      }
    }
    return;
  }

  const int wg = warp >> 2;  // this warpgroup's rows: 64 wg .. 64 wg + 63 of the tile
  const int tid = threadIdx.x & 127;
  const int wq = tid >> 5;
  const int gq = (tid & 31) >> 2;
  const int tq = tid & 3;
  unsigned char* cs = epi + wg * (BN / 64) * kBox;
  int q = 0;
  bool stored = false;
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const DxTile t = dx_tile<BN>(p, tile);
    const int gid = p.tile_groups[t.mt];
    const bool ok = gid >= 0 && gid < p.g;
    if (!ok && wg == 0 && tid == 0 && p.err != nullptr) *p.err = 1;  // every writer stores 1
    const int steps = ok ? steps_all : 0;
    const int row = t.row0 + 64 * wg;  // this warpgroup's first row in the m-tile
    const bool live = row < p.block_m;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    // One step's products stay in flight while the next step's issue; a
    // stage is released once the products that read it are done.
    int held = -1;
    for (int st = 0; st < steps; ++st, ++q) {
      const int s = q % S::kStages;
      mbar_wait(&full[s], (q / S::kStages) & 1);
      if (live) {
        const unsigned char* ys = ring + s * S::kStageBytes + wg * kBox;
        const unsigned char* ws = ring + s * S::kStageBytes + 2 * kBox;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDxBK / 16; ++kk)
          Wgmma<T, BN>::template ss<0, 0>(acc, desc_kmajor(ys + kk * 32),
                                          desc_kmajor(ws + kk * 32), 1);
        wgmma_commit();
      }
      wgmma_wait<1>();
      if (held >= 0 && tid == 0) mbar_arrive(&empty[held]);
      held = s;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (held >= 0 && tid == 0) mbar_arrive(&empty[held]);
    if (!live) continue;
    // Epilogue: the previous tile's store has read cs; round into the
    // swizzled boxes; then one thread stores them.
    if (stored && tid == 0) tma_store_wait_read();
    named_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = 16 * wq + gq + 8 * r;
        const int col = 8 * j + 2 * tq;
        *reinterpret_cast<uint32_t*>(cs + (col / 64) * kBox + sw128(rr, (col % 64) * 2)) =
            Mma<T>::pack(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    fence_async_smem();
    named_sync(1 + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int b = 0; b < BN / 64; ++b)
        if (t.k0 + 64 * b < p.k) tma_store_3d(&tdx, cs + b * kBox, t.k0 + 64 * b, row, t.mt);
      tma_store_commit();
    }
    stored = true;
  }
  if (tid == 0) tma_store_wait_all();
}

template <typename T, int BN>
int launch_dx_wgmma(const DxParams& p, const void* dy, const void* w, void* dx, int grid,
                    cudaStream_t stream) {
  using S = DxShape<BN>;
  const uint64_t tiles = static_cast<uint64_t>(p.m / p.block_m);
  const uint64_t bm = static_cast<uint64_t>(p.block_m);
  CUtensorMap tdy, tw, tdx;
  int err = tensor_map_3d<T>(&tdy, dy, p.n, bm, tiles, 2ull * p.n, 2ull * bm * p.n, 64);
  if (err) return err;
  err = tensor_map_3d<T>(&tw, w, p.n, p.k, p.g, 2ull * p.n, 2ull * p.k * p.n, BN);
  if (err) return err;
  err = tensor_map_3d<T>(&tdx, dx, p.k, bm, tiles, 2ull * p.k, 2ull * bm * p.k, 64);
  if (err) return err;
  static bool opted_in = false;
  err = opt_in(gmm_dx_wgmma_kernel<T, BN>, S::kSmem, opted_in);
  if (err) return err;
  gmm_dx_wgmma_kernel<T, BN><<<grid, kDxThreads, S::kSmem, stream>>>(tdy, tw, tdx, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dx_width(const DxParams& p, const void* dy, const void* w, void* dx, int grid,
                    int tile_k, cudaStream_t stream) {
  return tile_k == 256 ? launch_dx_wgmma<T, 256>(p, dy, w, dx, grid, stream)
                       : launch_dx_wgmma<T, 128>(p, dy, w, dx, grid, stream);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32_shape<false>(p, s);
  return dtype == 1 ? launch_tc_shape<__nv_bfloat16>(p, s) : launch_tc_shape<__half>(p, s);
}

// dx [M, K] = each tile of dy [M, N] times its group's w [G, K, N]
// transposed (read in place); a tile whose group id lies outside [0, G)
// gets zeros and sets *err (err may be null: the forward has flagged the
// same ids). float32 runs the FMA kernel, one block a (BM rows, 64
// columns); bfloat16 and float16 the wgmma kernel on a persistent grid of
// `grid` blocks over tiles tile_k (256 or 128) columns wide, both from the
// wrapper's plan (K and N multiples of 8, dy, w and dx 16-byte aligned:
// the wrapper's copies see to it), or zero dx when N is 0. Returns as
// acs_grouped_matmul, or 1000 + libcuda's error when a tensor map cannot
// be encoded.
extern "C" int acs_grouped_matmul_dx(const void* dy, const void* w, const int* tile_groups,
                                     void* dx, int* err, int m, int k, int n, int g,
                                     int block_m, int dtype, int grid, int tile_k,
                                     void* stream) {
  if (dtype < 0 || dtype > 2 ||
      (dtype != 0 && (grid < 1 || (tile_k != 256 && tile_k != 128) || k % 8 != 0 ||
                      n % 8 != 0)))
    return -1;
  if (m == 0 || k == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0) {
    if (n == 0) return static_cast<int>(cudaMemsetAsync(dx, 0, static_cast<size_t>(m) * k * 2, s));
    DxParams p{};
    p.tile_groups = tile_groups;
    p.err = err;
    p.m = m;
    p.k = k;
    p.n = n;
    p.g = g;
    p.block_m = block_m;
    p.chunks = (block_m + kDxBM - 1) / kDxBM;
    p.col_tiles = (k + tile_k - 1) / tile_k;
    return dtype == 1 ? launch_dx_width<__nv_bfloat16>(p, dy, w, dx, grid, tile_k, s)
                      : launch_dx_width<__half>(p, dy, w, dx, grid, tile_k, s);
  }
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
  return launch_f32_shape<true>(p, s);
}

// dw [G, K, N]: for each group, the sum over its tiles (in index order) of
// x's tile transposed times dy's tile; 0 for a group no tile names.
// float32 runs the FMA kernel, one block a (group, K tile, N tile), after
// a one-block launch that writes the group -> tiles table into the scratch
// order ([M / block_m] int32) and offs ([G + 1] int32); bfloat16 and
// float16 run the wgmma kernel alone on a persistent grid of `grid` blocks
// (K and N multiples of 8, x, dy and dw 16-byte aligned, G <= 4096: the
// wrapper's copies see to it), which finds each group's tiles itself
// (order and offs may be null), or zero dw when M is 0. Returns as
// acs_grouped_matmul, or 1000 + libcuda's error when a tensor map cannot
// be encoded.
extern "C" int acs_grouped_matmul_dw(const void* x, const void* dy, const int* tile_groups,
                                     int* order, int* offs, void* dw, int m, int k, int n,
                                     int g, int block_m, int dtype, int grid, void* stream) {
  if (dtype < 0 || dtype > 2 ||
      (dtype != 0 && (grid < 1 || g > kDwMaxGroups || k % 8 != 0 || n % 8 != 0)))
    return -1;
  if (k == 0 || n == 0 || g == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && m == 0)
    return static_cast<int>(cudaMemsetAsync(dw, 0, static_cast<size_t>(g) * k * n * 2, s));
  if (dtype == 0) {
    gmm_tile_table_kernel<<<1, kTableThreads, 0, s>>>(tile_groups, m / block_m, g, order, offs);
    const int e = static_cast<int>(cudaGetLastError());
    if (e) return e;
  }
  DwParams p{};
  p.x = x;
  p.dy = dy;
  p.tile_groups = tile_groups;
  p.order = order;
  p.offs = offs;
  p.dw = dw;
  p.m = m;
  p.k = k;
  p.n = n;
  p.g = g;
  p.block_m = block_m;
  if (dtype == 0) return launch_dw_f32(p, s);
  return dtype == 1 ? launch_dw_wgmma<__nv_bfloat16>(p, grid, s)
                    : launch_dw_wgmma<__half>(p, grid, s);
}
