// Flash attention's backward on Hopper (sm_90a): dQ, dK and dV from q, k,
// v, the forward's output o, its row log-sum-exp lse and the output's
// gradient dO.
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
// contributes nothing. Dv == D, any D from 1 to 256 (padded in shared
// memory to 64, 128 or 256, as the forward pads it).
//
// Bound on this card: the bytes (q, k, v, o, dO read once, lse once, dQ,
// dK, dV written once, over 3.35 TB/s) or the operations (the five
// products S = Q K^T, dP, dV, dQ and dK over the visible (row, key) pairs,
// 2 * 5 * D each, over 989 TFLOP/s for bf16), whichever is larger. At
// minicpm-2b's training shape [4, 36, 512, 64] causal that is 75.8 MB
// (0.0226 ms) against 12.1 GFLOP (0.0122 ms): the bytes. This first
// version computes S and dP in both passes (seven products a pair) on
// mma.sync; wgmma and TMA are later work.
//
// Design, FlashAttention-2's backward in two passes, deterministic: there
// are no atomics and no split of a sum across blocks, so every sum runs in
// one fixed order and the same inputs give the same bits run after run.
// * Prologue: one warp a row computes Di in float32 (a butterfly sum).
// * Key-tile pass (dK, dV): a block of 4 warps owns 64 keys of one
//   (batch, kv head), 16 keys a warp; its k and v tiles stay in shared
//   memory while the query tiles of every query head of the group that
//   can see one of its keys stream through a 2-stage cp.async ring (q,
//   dO, and the rows' lse and Di). Per query tile: S^T = K Q^T and
//   dP^T = V dO^T on the tensor cores, P^T and dS^T in registers in the
//   accumulator layout, then dV += P^T dO and dK += dS^T Q with P^T and
//   dS^T rounded to bf16 (f16) as the A operands, as FlashAttention-2
//   rounds P in the forward.
// * Query-tile pass (dQ): a block of 4 warps owns 64 query rows of one
//   (batch, head) and streams the key tiles its rows can see, as the
//   forward does: S = Q K^T and dP = dO V^T, dS in registers, dQ += dS K.
// * bfloat16 / float16 products on mma.sync.m16n8k16 with float32
//   accumulators (ldmatrix and cp.async from sm90_tiles.cuh). Query tiles
//   of the key-tile pass are 64 rows at D <= 64 and 32 at D <= 128, which
//   keeps the four accumulator sets in registers.
// * D 256 (recurrentgemma-2b, paligemma-3b): a warp's dK and dV
//   accumulators over all 256 columns would be 256 float32 registers a
//   lane. Each pass instead splits its OUTPUT columns in two: a block
//   writes columns 0-127 or 128-255 of dQ (or of dK and dV), so it holds
//   the D-128 accumulator sets, and recomputes S and dP over the whole D
//   from shared memory (two blocks per tile do that work twice). The k and
//   v tiles are [64][264] and the streamed q and dO tiles [32][264] in two
//   stages: 133 KB in the key-tile pass, 198 KB in the query-tile pass
//   (dynamic shared memory, opted in).
//   recurrentgemma-2b's training shape [4, 10, 512, 256] causal over one
//   kv head moves ~46 MB (0.0138 ms) against 13.4 GFLOP (0.0136 ms).
// * float32 (the tolerance tests) on scalar FMAs, the forward's scalar
//   design with the roles of rows and keys swapped in the key-tile pass.

#include "sm90_tiles.cuh"

#include <cmath>
#include <cstddef>

namespace {

using namespace sm90;

#if !defined(ACS_FLASH_BWD_MAX_D)
#error "build through flash_attention.py, which defines the head widths"
#endif

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxD = ACS_FLASH_BWD_MAX_D;  // Dv == D up to this width
static_assert(kMaxD == 256, "the instantiations pad D to 64, 128 or 256");
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;     // [B, H, Sq, D]
  const void* k;     // [B, Hkv, Sk, D]
  const void* v;     // [B, Hkv, Sk, D]
  const void* o;     // [B, H, Sq, D]
  const void* dout;  // [B, H, Sq, D]
  const float* lse;  // [B, H, Sq]
  float* di;         // [B, H, Sq] scratch: rowsum(dO * O)
  void* dq;          // [B, H, Sq, D]
  void* dk;          // [B, Hkv, Sk, D]
  void* dv;          // [B, Hkv, Sk, D]
  int n_batch, n_heads, n_kv_heads, sq, sk, dim;
  int stride;  // f32 kernels: shared-memory row stride of the streamed tiles
  float scale;
  int causal;
  int has_window, window;
  int has_softcap;
  float softcap;
  int q_offset, prefix_len;
  int vec;  // 16-byte copies allowed: D % 8 == 0 and q, k, v, dO 16-byte aligned
};

// Whether the query at global position row sees key col.
__device__ __forceinline__ bool visible(const Params& p, int row, int col) {
  bool vis = true;
  if (p.causal) vis = col <= row;
  if (p.has_window) vis = vis && col > row - p.window;
  return (vis || col < p.prefix_len) && col < p.sk;
}

// A row's lse in the log2 domain; +inf for a row that sees no key, so that
// every P of the row is exp2(x - inf) = 0.
__device__ __forceinline__ float lse2_of(float lse) {
  return lse == -INFINITY ? INFINITY : lse * kLog2e;
}

// The raw score x -> its exponent in the log2 domain; fac receives the
// softcap's derivative factor 1 - tanh^2 (1 without softcap).
__device__ __forceinline__ float score2(const Params& p, float x, float& fac) {
  if (p.has_softcap) {
    const float th = tanhf(x * p.scale / p.softcap);
    fac = 1.0f - th * th;
    return p.softcap * th * kLog2e;
  }
  fac = 1.0f;
  return x * p.scale * kLog2e;
}

// ---------------------------------------------------------------------------
// Prologue: Di = rowsum(dO * O), one warp a row
// ---------------------------------------------------------------------------

constexpr int kDotThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kDotThreads) flash_bwd_dot_kernel(const Params p) {
  const size_t row = (static_cast<size_t>(blockIdx.x) * kDotThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<size_t>(p.n_batch) * p.n_heads * p.sq) return;  // warp-uniform
  const T* o = static_cast<const T*>(p.o) + row * p.dim;
  const T* d = static_cast<const T*>(p.dout) + row * p.dim;
  float acc = 0.0f;
  for (int c = lane; c < p.dim; c += 32) acc += to_f<T>(o[c]) * to_f<T>(d[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) p.di[row] = acc;
}

// ---------------------------------------------------------------------------
// bfloat16 / float16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcRows = kTcWarps * 16;  // query rows (dQ pass) or keys (dK/dV pass) a block
constexpr int kTcKeys = 64;             // keys per streamed tile of the dQ pass

// dst[r][c] = src[r * dim + c] for r < rows and c < dim, else 0.
template <typename T, int R, int DP, int LD>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int rows, int dim, bool vec) {
  stage<T, R, DP, LD, kTcThreads>(dst, src, static_cast<size_t>(dim), rows, dim, vec);
}

// Store a float32 accumulator set [16 rows x 8 DB] of one warp, times mul,
// as T into columns c0 .. c0 + 8 DB - 1: rows local < rows_here, columns
// < dim.
template <typename T, int DB>
__device__ __forceinline__ void store_acc(T* dst, const float (&acc)[DB][4], float mul,
                                          int warp_row0, int g, int t, int rows_here, int dim,
                                          int c0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int local = warp_row0 + g + 8 * r;
    if (local >= rows_here) continue;
    T* row = dst + static_cast<size_t>(local) * dim;
#pragma unroll
    for (int db = 0; db < DB; ++db) {
      const int col = c0 + db * 8 + 2 * t;
      if (col >= dim) continue;
      const float x0 = acc[db][2 * r] * mul;
      const float x1 = acc[db][2 * r + 1] * mul;
      if ((dim & 1) == 0) {
        *reinterpret_cast<uint32_t*>(row + col) = Mma<T>::pack(x0, x1);
      } else {
        row[col] = from_f<T>(x0);
        if (col + 1 < dim) row[col + 1] = from_f<T>(x1);
      }
    }
  }
}

// A [16 x 16] A-operand fragment from four accumulator blocks' worth of
// registers: columns 16 kk .. 16 kk + 15 of a [16 x 8 NB] accumulator set.
template <typename T, int NB>
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float (&x)[NB][4], int kk) {
  a[0] = Mma<T>::pack(x[2 * kk][0], x[2 * kk][1]);
  a[1] = Mma<T>::pack(x[2 * kk][2], x[2 * kk][3]);
  a[2] = Mma<T>::pack(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = Mma<T>::pack(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

// c[NB] += A (16 rows of a_s at row a_row) times B^T, B = NB * 8 rows of
// b_s: the Q K^T pattern, over the first d16 16-column steps.
template <typename T, int DP, int LD, int NB>
__device__ __forceinline__ void rows_times_rows(float (&c)[NB][4], const T* a_s, int a_row,
                                                const T* b_s, int d16, int lane) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    if (kk < d16) {
      uint32_t a[4];
      ldmatrix_x4(a, a_s + (a_row + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, b_s + (nb * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                           ((lane >> 3) & 1) * 8);
        Mma<T>::run(c[nb], a, b[0], b[1]);
        Mma<T>::run(c[nb + 1], a, b[2], b[3]);
      }
    }
  }
}

// acc[DB] += X (registers, [16 x 8 NB]) times columns c0 .. c0 + 8 DB - 1
// of the [8 NB x DP] tile b_s: the P V pattern (B through ldmatrix.trans),
// over the columns below dim.
template <typename T, int DP, int LD, int NB, int DB>
__device__ __forceinline__ void regs_times_tile(float (&acc)[DB][4], const float (&x)[NB][4],
                                                const T* b_s, int dim, int c0, int lane) {
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    uint32_t a[4];
    acc_to_a<T, NB>(a, x, kk);
#pragma unroll
    for (int db = 0; db < DB; db += 2) {
      if (c0 + db * 8 < dim) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, b_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                 c0 + db * 8 + (lane >> 4) * 8);
        Mma<T>::run(acc[db], a, b[0], b[1]);
        Mma<T>::run(acc[db + 1], a, b[2], b[3]);
      }
    }
  }
}

template <int DP> struct TcTile {
  static constexpr int LD = DP + 8;  // shared row stride, elements: no bank read twice
};

// dQ: a block owns kTcRows query rows of one (batch, head) and OC of dQ's
// columns (DP / OC blocks a tile).
template <typename T, int DP, int OC>
__global__ void __launch_bounds__(kTcThreads) flash_bwd_dq_kernel(const Params p) {
  constexpr int BN = kTcKeys;
  constexpr int LD = TcTile<DP>::LD;
  constexpr int NB = BN / 8;
  constexpr int DB = OC / 8;
  constexpr int kSplit = DP / OC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [kTcRows][LD]
  T* do_s = q_s + kTcRows * LD;             // [kTcRows][LD]
  T* k_s = do_s + kTcRows * LD;             // [2][BN][LD]
  T* v_s = k_s + 2 * BN * LD;               // [2][BN][LD]

  // Block -> (query tile, batch, head, column slice): the last query tiles
  // first.
  const int c0 = (static_cast<int>(blockIdx.x) % kSplit) * OC;
  const int blk = static_cast<int>(blockIdx.x) / kSplit;
  const int n_qt = (p.sq + kTcRows - 1) / kTcRows;
  const int bh = p.n_batch * p.n_heads;
  const int qt = n_qt - 1 - blk / bh;
  const int rem = blk - (n_qt - 1 - qt) * bh;
  const int bi = rem / p.n_heads;
  const int h = rem - bi * p.n_heads;
  const int hk = h / (p.n_heads / p.n_kv_heads);
  const int dim = p.dim;
  const int q0 = qt * kTcRows;
  const int rows_here = min(kTcRows, p.sq - q0);
  const size_t row_base = (static_cast<size_t>(bi) * p.n_heads + h) * p.sq + q0;
  const size_t kv_base = (static_cast<size_t>(bi) * p.n_kv_heads + hk) * p.sk * dim;
  const T* kg = static_cast<const T*>(p.k) + kv_base;
  const T* vg = static_cast<const T*>(p.v) + kv_base;

  // The key tiles the block's rows see, as the forward skips them.
  const int row_lo = p.q_offset + q0;
  const int row_hi = row_lo + rows_here - 1;
  const int n_kt = (p.sk + BN - 1) / BN;
  int kt_end = n_kt;
  if (p.causal) {
    const int last = max(row_hi, p.prefix_len - 1);
    kt_end = last < 0 ? 0 : min(n_kt, last / BN + 1);
  }
  const int prefix_tiles = (p.prefix_len + BN - 1) / BN;
  int window_tile = 0;
  if (p.has_window) {
    const int lo = row_lo - p.window + 1;
    window_tile = lo > 0 ? lo / BN : 0;
  }
  auto next_visible = [&](int kt) {
    return (kt >= prefix_tiles && kt < window_tile) ? window_tile : kt;
  };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int d16 = (dim + 15) >> 4;
  const int row0 = row_lo + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  float lse2[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int local = warp * 16 + g + 8 * r;
    lse2[r] = local < rows_here ? lse2_of(p.lse[row_base + local]) : INFINITY;
    di[r] = local < rows_here ? p.di[row_base + local] : 0.0f;
  }

  float acc[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  int kt = next_visible(0);
  if (kt < kt_end) {
    stage_rows<T, kTcRows, DP, LD>(q_s, static_cast<const T*>(p.q) + row_base * dim, rows_here,
                                   dim, p.vec);
    stage_rows<T, kTcRows, DP, LD>(do_s, static_cast<const T*>(p.dout) + row_base * dim,
                                   rows_here, dim, p.vec);
    stage_rows<T, BN, DP, LD>(k_s, kg + static_cast<size_t>(kt) * BN * dim, p.sk - kt * BN,
                              dim, p.vec);
    stage_rows<T, BN, DP, LD>(v_s, vg + static_cast<size_t>(kt) * BN * dim, p.sk - kt * BN,
                              dim, p.vec);
    cp_async_commit();
  }
  for (int stage = 0; kt < kt_end; stage ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt landed for every thread; the other stage is free
    const int nxt = next_visible(kt + 1);
    if (nxt < kt_end) {
      const size_t off = static_cast<size_t>(nxt) * BN * dim;
      stage_rows<T, BN, DP, LD>(k_s + (stage ^ 1) * BN * LD, kg + off, p.sk - nxt * BN, dim,
                                p.vec);
      stage_rows<T, BN, DP, LD>(v_s + (stage ^ 1) * BN * LD, vg + off, p.sk - nxt * BN, dim,
                                p.vec);
    }
    cp_async_commit();
    const T* ks = k_s + stage * BN * LD;
    const T* vs = v_s + stage * BN * LD;
    const int k0 = kt * BN;

    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
    }
    rows_times_rows<T, DP, LD, NB>(s, q_s, warp * 16, ks, d16, lane);   // S = Q K^T
    rows_times_rows<T, DP, LD, NB>(dp, do_s, warp * 16, vs, d16, lane);  // dP = dO V^T

    // dS = P * (dP - Di) * fac; element e of block nb is row row0 + 8 * (e / 2),
    // key k0 + 8 * nb + 2 * t + e % 2.
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float fac;
        const float x = score2(p, s[nb][e], fac);
        const int col = k0 + nb * 8 + 2 * t + (e & 1);
        const int r = e >> 1;
        const float pe = visible(p, row0 + 8 * r, col) ? exp2f(x - lse2[r]) : 0.0f;
        s[nb][e] = pe * (dp[nb][e] - di[r]) * fac;
      }
    }
    regs_times_tile<T, DP, LD, NB, DB>(acc, s, ks, dim, c0, lane);  // dQ += dS K
    kt = nxt;
  }
  store_acc<T, DB>(static_cast<T*>(p.dq) + row_base * dim, acc, p.scale, warp * 16, g, t,
                   rows_here, dim, c0);
}

// dK and dV: a block owns kTcRows keys of one (batch, kv head) and OC of
// their columns (DP / OC blocks a tile); query tiles of BM rows stream
// through.
template <typename T, int DP, int BM, int OC>
__global__ void __launch_bounds__(kTcThreads) flash_bwd_dkdv_kernel(const Params p) {
  constexpr int BN = kTcRows;  // keys a block: 16 a warp
  constexpr int LD = TcTile<DP>::LD;
  constexpr int NB = BM / 8;   // 8-query column blocks of S^T
  constexpr int DB = OC / 8;
  constexpr int kSplit = DP / OC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);         // [BN][LD]
  T* v_s = k_s + BN * LD;                          // [BN][LD]
  T* q_s = v_s + BN * LD;                          // [2][BM][LD]
  T* do_s = q_s + 2 * BM * LD;                     // [2][BM][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BM * LD);  // [2][BM], log2 domain
  float* di_s = lse_s + 2 * BM;                    // [2][BM]

  // Block -> (key tile, batch, kv head, column slice): under a causal mask
  // the first key tiles see the most rows, and they launch first.
  const int c0 = (static_cast<int>(blockIdx.x) % kSplit) * OC;
  const int blk = static_cast<int>(blockIdx.x) / kSplit;
  const int bh = p.n_batch * p.n_kv_heads;
  const int kt = blk / bh;
  const int rem = blk - kt * bh;
  const int bi = rem / p.n_kv_heads;
  const int hk = rem - bi * p.n_kv_heads;
  const int group = p.n_heads / p.n_kv_heads;
  const int dim = p.dim;
  const int k0 = kt * BN;
  const int keys_here = min(BN, p.sk - k0);
  const size_t kv_base = ((static_cast<size_t>(bi) * p.n_kv_heads + hk) * p.sk + k0) * dim;

  // The query tiles with a row that sees a key of this tile.
  const int n_qt = (p.sq + BM - 1) / BM;
  int qt_begin = 0, qt_end = n_qt;
  if (k0 >= p.prefix_len) {  // no prefix key here: the causal and window masks bound the rows
    if (p.causal) {
      const int lo = k0 - p.q_offset;  // the first local row that can see key k0
      qt_begin = lo > 0 ? min(n_qt, lo / BM) : 0;
    }
    if (p.has_window) {  // the last local row that can see the tile's last key
      const int hi = k0 + keys_here - 1 + p.window - 1 - p.q_offset;
      qt_end = hi < 0 ? 0 : min(n_qt, hi / BM + 1);
    }
  }
  const int n_q = max(0, qt_end - qt_begin);
  const int n_items = group * n_q;  // (query head, query tile) pairs, heads outermost

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int d16 = (dim + 15) >> 4;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8

  auto stage_item = [&](int it, int st) {
    const int h = hk * group + it / n_q;
    const int q0 = (qt_begin + it % n_q) * BM;
    const int rows = min(BM, p.sq - q0);
    const size_t base = (static_cast<size_t>(bi) * p.n_heads + h) * p.sq + q0;
    stage<T, BM, DP, LD, kTcThreads>(q_s + st * BM * LD, static_cast<const T*>(p.q) + base * dim,
                                     static_cast<size_t>(dim), rows, dim, p.vec);
    stage<T, BM, DP, LD, kTcThreads>(do_s + st * BM * LD,
                                     static_cast<const T*>(p.dout) + base * dim,
                                     static_cast<size_t>(dim), rows, dim, p.vec);
    for (int i = threadIdx.x; i < BM; i += kTcThreads) {
      lse_s[st * BM + i] = i < rows ? lse2_of(p.lse[base + i]) : INFINITY;
      di_s[st * BM + i] = i < rows ? p.di[base + i] : 0.0f;
    }
  };

  float dk[DB][4], dv[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.0f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.0f;
  }
  if (n_items > 0) {
    stage_rows<T, BN, DP, LD>(k_s, static_cast<const T*>(p.k) + kv_base, keys_here, dim, p.vec);
    stage_rows<T, BN, DP, LD>(v_s, static_cast<const T*>(p.v) + kv_base, keys_here, dim, p.vec);
    stage_item(0, 0);
    cp_async_commit();
  }
  for (int it = 0, st = 0; it < n_items; ++it, st ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // item it landed for every thread; the other stage is free
    if (it + 1 < n_items) stage_item(it + 1, st ^ 1);
    cp_async_commit();
    const T* qs = q_s + st * BM * LD;
    const T* dos = do_s + st * BM * LD;
    const float* ls = lse_s + st * BM;
    const float* ds = di_s + st * BM;
    const int row_base = p.q_offset + (qt_begin + it % n_q) * BM;  // global row of query 0

    float s[NB][4], dpt[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.0f;
    }
    rows_times_rows<T, DP, LD, NB>(s, k_s, warp * 16, qs, d16, lane);     // S^T = K Q^T
    rows_times_rows<T, DP, LD, NB>(dpt, v_s, warp * 16, dos, d16, lane);  // dP^T = V dO^T

    // Element e of block nb is key key0 + 8 * (e / 2), query nb * 8 + 2 * t + e % 2.
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float fac;
        const float x = score2(p, s[nb][e], fac);
        const int qi = nb * 8 + 2 * t + (e & 1);
        const float pe = visible(p, row_base + qi, key0 + 8 * (e >> 1)) ? exp2f(x - ls[qi])
                                                                         : 0.0f;
        s[nb][e] = pe;                                      // P^T
        dpt[nb][e] = pe * (dpt[nb][e] - ds[qi]) * fac;      // dS^T
      }
    }
    regs_times_tile<T, DP, LD, NB, DB>(dv, s, dos, dim, c0, lane);   // dV += P^T dO
    regs_times_tile<T, DP, LD, NB, DB>(dk, dpt, qs, dim, c0, lane);  // dK += dS^T Q
  }
  store_acc<T, DB>(static_cast<T*>(p.dk) + kv_base, dk, p.scale, warp * 16, g, t, keys_here,
                   dim, c0);
  store_acc<T, DB>(static_cast<T*>(p.dv) + kv_base, dv, 1.0f, warp * 16, g, t, keys_here, dim,
                   c0);
}

template <typename T, int DP, int BM, int OC>
int launch_tc(const Params& p, cudaStream_t stream) {
  constexpr int LD = TcTile<DP>::LD;
  constexpr int kSplit = DP / OC;
  const size_t smem_kv = sizeof(T) * (2 * kTcRows + 4 * BM) * LD + sizeof(float) * 4 * BM;
  static bool kv_opted = false;
  int err = opt_in(flash_bwd_dkdv_kernel<T, DP, BM, OC>, smem_kv, kv_opted);
  if (err) return err;
  const int n_kt = (p.sk + kTcRows - 1) / kTcRows;
  flash_bwd_dkdv_kernel<T, DP, BM, OC>
      <<<n_kt * p.n_batch * p.n_kv_heads * kSplit, kTcThreads, smem_kv, stream>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  const size_t smem_q = sizeof(T) * (2 * kTcRows + 4 * kTcKeys) * LD;
  static bool q_opted = false;
  err = opt_in(flash_bwd_dq_kernel<T, DP, OC>, smem_q, q_opted);
  if (err) return err;
  const int n_qt = (p.sq + kTcRows - 1) / kTcRows;
  flash_bwd_dq_kernel<T, DP, OC>
      <<<n_qt * p.n_batch * p.n_heads * kSplit, kTcThreads, smem_q, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tc_dim(const Params& p, cudaStream_t stream) {
  if (p.dim <= 64) return launch_tc<T, 64, 64, 64>(p, stream);
  if (p.dim <= 128) return launch_tc<T, 128, 32, 128>(p, stream);
  return launch_tc<T, 256, 32, 128>(p, stream);  // two column slices a tile
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
  const int dim = p.dim;
  float* q_s = reinterpret_cast<float*>(smem);  // [kBlockRows][dim]
  float* do_s = q_s + kBlockRows * dim;         // [kBlockRows][dim]
  float* k_s = do_s + kBlockRows * dim;         // [kTile][stride]
  float* v_s = k_s + kTile * p.stride;          // [kTile][stride]

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
  const size_t kv_base = (static_cast<size_t>(bi) * p.n_kv_heads + hk) * p.sk * dim;
  const float* kg = static_cast<const float*>(p.k) + kv_base;
  const float* vg = static_cast<const float*>(p.v) + kv_base;

  for (int i = threadIdx.x; i < kBlockRows * dim; i += kThreads) {
    const bool ok = i < rows_here * dim;
    q_s[i] = ok ? static_cast<const float*>(p.q)[row_base * dim + i] : 0.0f;
    do_s[i] = ok ? static_cast<const float*>(p.dout)[row_base * dim + i] : 0.0f;
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
      v_s[j * p.stride + i - j * dim] = vg[static_cast<size_t>(k0) * dim + i];
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
        const float dpv = dot_row(do_s + local * dim, v_s + lane * p.stride, dim);
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
  const int dim = p.dim;
  float* k_s = reinterpret_cast<float*>(smem);  // [kBlockRows][dim]
  float* v_s = k_s + kBlockRows * dim;          // [kBlockRows][dim]
  float* q_s = v_s + kBlockRows * dim;          // [kTile][stride]
  float* do_s = q_s + kTile * p.stride;         // [kTile][stride]
  float* lse_s = do_s + kTile * p.stride;       // [kTile]
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
  const size_t kv_base = ((static_cast<size_t>(bi) * p.n_kv_heads + hk) * p.sk + k0) * dim;

  for (int i = threadIdx.x; i < kBlockRows * dim; i += kThreads) {
    const bool ok = i < keys_here * dim;
    k_s[i] = ok ? static_cast<const float*>(p.k)[kv_base + i] : 0.0f;
    v_s[i] = ok ? static_cast<const float*>(p.v)[kv_base + i] : 0.0f;
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
      const float* dog = static_cast<const float*>(p.dout) + (head_base + q0) * dim;
      for (int i = threadIdx.x; i < nq * dim; i += kThreads) {
        const int j = i / dim;
        q_s[j * p.stride + i - j * dim] = qg[i];
        do_s[j * p.stride + i - j * dim] = dog[i];
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
          const float dpv = dot_row(do_s + lane * p.stride, v_s + local * dim, dim);
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
          const float* dorow = do_s + jj * p.stride;
#pragma unroll
          for (int c = 0; c < kColsPerLane; ++c) {
            const int d = lane + 32 * c;
            if (d < dim) {
              dv[r][c] += pv * dorow[d];
              dk[r][c] += dsv * qrow[d];
            }
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
      if (d < dim) {
        static_cast<float*>(p.dk)[kv_base + static_cast<size_t>(local) * dim + d] =
            dk[r][c] * p.scale;
        static_cast<float*>(p.dv)[kv_base + static_cast<size_t>(local) * dim + d] = dv[r][c];
      }
    }
  }
}

int launch_f32(Params p, cudaStream_t stream) {
  p.stride = p.dim | 1;  // odd word strides: lane j's read of row j in its own bank
  const size_t smem_kv =
      sizeof(float) * (2 * kBlockRows * p.dim + 2 * kTile * p.stride + 2 * kTile);
  const size_t smem_q = sizeof(float) * (2 * kBlockRows * p.dim + 2 * kTile * p.stride);
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

template <typename T>
int launch_dot(const Params& p, cudaStream_t stream) {
  const size_t rows = static_cast<size_t>(p.n_batch) * p.n_heads * p.sq;
  const size_t per_block = kDotThreads / 32;
  flash_bwd_dot_kernel<T><<<(rows + per_block - 1) / per_block, kDotThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; q, k, v, o, dout, dq, dk
// and dv share it and the head width dim (Dv == D); lse is the forward's
// float32 [B, H, Sq] output and di a float32 [B, H, Sq] scratch buffer.
// Launches the prologue, the key-tile pass and the query-tile pass on
// stream, in that order. Returns cudaGetLastError() after the first launch
// that fails (0 on success), or -1 for a dtype code or width it has no
// instantiation for.
extern "C" int acs_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const float* lse,
                                       float* di, void* dq, void* dk, void* dv, int n_batch,
                                       int n_heads, int n_kv_heads, int sq, int sk, int dim,
                                       int dtype, float scale, int causal, int has_window,
                                       int window, int has_softcap, float softcap,
                                       int q_offset, int prefix_len, void* stream) {
  if (dim < 1 || dim > kMaxD) return -1;
  const int vec = dim % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                  aligned16(dout);
  Params p{q, k, v, o, dout, lse, di, dq, dk, dv, n_batch, n_heads, n_kv_heads, sq, sk, dim,
           0, scale, causal, has_window, window, has_softcap, softcap, q_offset, prefix_len,
           vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    err = launch_dot<float>(p, s);
    return err ? err : launch_f32(p, s);
  }
  if (dtype == 1) {
    err = launch_dot<__nv_bfloat16>(p, s);
    return err ? err : launch_tc_dim<__nv_bfloat16>(p, s);
  }
  if (dtype == 2) {
    err = launch_dot<__half>(p, s);
    return err ? err : launch_tc_dim<__half>(p, s);
  }
  return -1;
}
