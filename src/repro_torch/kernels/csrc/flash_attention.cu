// Online-softmax attention (flash attention) on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention ->
// _flash_kernel (the Pallas kernel whose innermost key-block grid axis
// carries m, l and acc in VMEM scratch, over Sq and Sk padded to blocks).
//
// Semantics are the plain version's (kernels/ref.py attention_ref): GQA
// (query head h reads kv head h / (H / Hkv)), a causal mask at a global
// q_offset, a sliding window (key kept iff col > row - window), prefix_len
// keys visible to every row, a softcap softcap * tanh(s / softcap), a
// ragged Sk, any D from 1 to 256 and a value width Dv that is D, or, with
// D <= 192, any Dv up to 128 (MLA: q and k at 128 + 64 rope columns, v at
// 128), with no padding copy in device memory. A masked key contributes
// exactly 0, so a row that sees no key ends with l == 0 and writes 0.
// (The reference's Pallas kernel takes v's width from q's and leaves the
// columns past Dv undefined; this kernel follows attention_ref.)
// Given an lse pointer it also writes each row's log-sum-exp of its scaled
// (and softcapped) visible scores, float32 [B, H, Sq], -inf for a row that
// sees no key: what the backward (flash_attention_bwd.cu) recomputes P
// from. With a null pointer nothing else changes: the output's bits and
// the work are the same.
//
// Bound on this card: the larger of the bytes (q, k, v read once, o
// written once, over 3.35 TB/s) and the visible score and PV operations
// (2 * B * H * sum over rows of the keys each row sees * (D + Dv), over
// 989 TFLOP/s for bf16). At the serving prefills it is the bytes:
// granite-moe [1, 24, 512, 64] causal 0.00125 ms, recurrentgemma
// [1, 10, 512, 256] over one kv head 0.00172 ms, deepseek-v2's MLA
// (q, k [1, 128, 512, 192], v [1, 128, 512, 128], causal) 0.0250 ms: its
// 83.9 MB take that, its 10.8 GFLOP 0.0109 ms. The first two do not fill the
// card (192 and 80 blocks of 64 rows), so what sets the time is each
// block's latency: how fast one block streams its key tiles through the
// tensor cores.
//
// bfloat16 / float16 (the serving path), FlashAttention-2's design:
// * A block of 4 warps owns 64 query rows of one (batch, head), 16 rows a
//   warp. The query tile is loaded once; keys and values stream through a
//   2-stage ring of 64-key tiles filled by 16-byte cp.async copies, so the
//   next tile's load overlaps this one's products (at D = 256 the ring and
//   the query tile take 165 KB, one block an SM; 32-key tiles there, which
//   fit two, were 10 % slower on the card). Rows past Sk and columns past D land as zeros (src-size 0);
//   D and Dv are padded in shared memory only, to (64, 64), (128, 128),
//   (256, 256) or, where Dv differs from D, (192, 128): the Q K^T product
//   runs over the padded D and the P V product and the output tile over
//   the padded Dv (four instantiations a dtype).
//   Rows are 8 elements wider than the padded width, so ldmatrix reads no
//   bank twice. At (192, 128) the ring and the query tile take 109 KB,
//   two blocks an SM. Measured on an H100 80GB HBM3 at 700 W
//   (chip_smoke.py): the MLA prefill takes 0.126 ms of device time, 5x its
//   bound and 2.7x cuDNN's wgmma SDPA kernel back to back (0.046); its
//   168 registers spill 4 bytes.
// * S = Q K^T and O = P V run on the tensor cores: mma.sync.m16n8k16
//   with float32 accumulators, A and B fed by ldmatrix (.trans for V).
// * The online softmax stays in registers in the accumulator layout: each
//   thread holds two rows' scores, reduces their max across the 4 lanes of
//   its quad, and rescales its slice of O. P is rounded to bf16 (f16) in
//   registers and used directly as the A operand of the PV product, as
//   FlashAttention-2 does; the row sums l add the unrounded P in float32.
// * Masks cost only where they cut a tile: a key tile the block sees
//   whole takes no per-element test, a tile it cannot see is skipped
//   (causal tail, window head), and only tiles that straddle the causal
//   diagonal, the window edge, the prefix end or Sk are masked.
// * Blocks launch the heaviest query tiles first (the last ones under a
//   causal mask), and the query heads of one kv group are adjacent in the
//   grid, so their K and V tiles are read from L2.
// * No atomics and no split across blocks: every sum runs in one fixed
//   order, so the same inputs give the same bits run after run.
// D = 8, 24 or 120 and other sizes whose rows are not 16-byte multiples,
// or unaligned tensors, stage the same tiles with element loads.
//
// float32 (the tolerance tests only) keeps the first, scalar design: one
// block of 4 warps per 16 query rows, lane j scoring key j of a 32-key
// tile over the whole of D, butterfly shuffles for the max and the sum,
// each lane accumulating Dv / 32 output columns.

#include "sm90_tiles.cuh"

#include <cmath>
#include <cstddef>

namespace {

using namespace sm90;

#if !defined(ACS_FLASH_MAX_D) || !defined(ACS_FLASH_SPLIT_D) || !defined(ACS_FLASH_SPLIT_DV)
#error "build through flash_attention.py, which defines the head widths"
#endif

constexpr unsigned kFull = 0xffffffffu;
// The head widths, defined once, in flash_attention.py: Dv == D up to
// kMaxD, and the instantiation with Dv != D, D up to kMlaD with Dv up to
// kMlaDv.
constexpr int kMaxD = ACS_FLASH_MAX_D;
constexpr int kMlaD = ACS_FLASH_SPLIT_D;
constexpr int kMlaDv = ACS_FLASH_SPLIT_DV;
static_assert(kMaxD == 256 && kMlaD % 16 == 0 && kMlaD <= kMaxD && kMlaDv % 16 == 0 &&
                  kMlaDv <= kMaxD,
              "tile widths: the Dv == D path pads to 64, 128 or 256; the split one to 16s");
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;  // [B, H, Sq, D]
  const void* k;  // [B, Hkv, Sk, D]
  const void* v;  // [B, Hkv, Sk, Dv]
  void* o;        // [B, H, Sq, Dv]
  float* lse;     // [B, H, Sq] row log-sum-exp, or null
  int n_batch, n_heads, n_kv_heads, sq, sk, dim, dv;
  int k_stride, v_stride;  // f32 kernel: shared-memory row strides of the k and v tiles
  float scale;
  int causal;
  int has_window, window;
  int has_softcap;
  float softcap;
  int q_offset, prefix_len;
  int vec;  // 16-byte copies allowed: D % 8 == 0, Dv % 8 == 0, q, k, v 16-byte aligned
};

// ---------------------------------------------------------------------------
// bfloat16 / float16: tensor cores, cp.async ring
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcRows = kTcWarps * 16;  // query rows per block

constexpr int kTcKeys = 64;  // keys per tile

template <int DP, int DVP> struct TcTile {
  static constexpr int LD = DP + 8;    // shared row stride of q and k, elements
  static constexpr int LDV = DVP + 8;  // of v
  static constexpr int SMEM_ELEMS = (kTcRows + 2 * kTcKeys) * LD + 2 * kTcKeys * LDV;
};

// dst[r][c] = src[r * dim + c] for r < rows and c < dim, else 0, for
// r < R and c < DP: 16-byte cp.async copies (committed by the caller) when
// vec, else element loads.
template <typename T, int R, int DP, int LD>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int rows, int dim, bool vec) {
  if (vec) {
    constexpr int CH = DP / 8;
    for (int i = threadIdx.x; i < R * CH; i += kTcThreads) {
      const int r = i / CH;
      const int c = (i - r * CH) * 8;
      const bool ok = r < rows && c < dim;
      cp_async16(dst + r * LD + c, ok ? src + static_cast<size_t>(r) * dim + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < R * DP; i += kTcThreads) {
      const int r = i / DP;
      const int c = i - r * DP;
      dst[r * LD + c] =
          (r < rows && c < dim) ? src[static_cast<size_t>(r) * dim + c] : from_f<T>(0.0f);
    }
  }
}

template <typename T, int DP, int DVP>
__global__ void __launch_bounds__(kTcThreads) flash_tc_kernel(const Params p) {
  constexpr int BN = kTcKeys;
  constexpr int LD = TcTile<DP, DVP>::LD;
  constexpr int LDV = TcTile<DP, DVP>::LDV;
  constexpr int NB = BN / 8;   // 8-key column blocks of S
  constexpr int DB = DVP / 8;  // 8-wide column blocks of O
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [kTcRows][LD]
  T* k_s = q_s + kTcRows * LD;              // [2][BN][LD]
  T* v_s = k_s + 2 * BN * LD;               // [2][BN][LDV]

  // Block -> (query tile, batch, head): the last query tiles first, heads
  // fastest (a kv group's heads adjacent).
  const int n_qt = (p.sq + kTcRows - 1) / kTcRows;
  const int bh = p.n_batch * p.n_heads;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / bh;
  const int rem = static_cast<int>(blockIdx.x) - (n_qt - 1 - qt) * bh;
  const int bi = rem / p.n_heads;
  const int h = rem - bi * p.n_heads;
  const int hk = h / (p.n_heads / p.n_kv_heads);
  const int dim = p.dim;
  const int dv = p.dv;
  const int q0 = qt * kTcRows;
  const int rows_here = min(kTcRows, p.sq - q0);

  const T* qg = static_cast<const T*>(p.q) +
                ((static_cast<size_t>(bi) * p.n_heads + h) * p.sq + q0) * dim;
  const T* kg = static_cast<const T*>(p.k) +
                (static_cast<size_t>(bi) * p.n_kv_heads + hk) * p.sk * dim;
  const T* vg = static_cast<const T*>(p.v) +
                (static_cast<size_t>(bi) * p.n_kv_heads + hk) * p.sk * dv;
  T* og = static_cast<T*>(p.o) + ((static_cast<size_t>(bi) * p.n_heads + h) * p.sq + q0) * dv;
  const size_t lse_row0 = (static_cast<size_t>(bi) * p.n_heads + h) * p.sq + q0;

  // Which key tiles the block's rows (global positions row_lo..row_hi) see.
  const int row_lo = p.q_offset + q0;
  const int row_hi = row_lo + rows_here - 1;
  const int n_kt = (p.sk + BN - 1) / BN;
  int kt_end = n_kt;
  if (p.causal) {  // no row sees a key past max(row_hi, prefix_len - 1)
    const int last = max(row_hi, p.prefix_len - 1);
    kt_end = last < 0 ? 0 : min(n_kt, last / BN + 1);
  }
  const int prefix_tiles = (p.prefix_len + BN - 1) / BN;
  int window_tile = 0;  // tiles before it hold no key inside any row's window
  if (p.has_window) {
    const int lo = row_lo - p.window + 1;
    window_tile = lo > 0 ? lo / BN : 0;
  }
  auto next_visible = [&](int kt) {
    return (kt >= prefix_tiles && kt < window_tile) ? window_tile : kt;
  };
  // Every real row sees every key of the tile: no per-element mask.
  auto whole = [&](int k0) {
    const int c_hi = k0 + BN - 1;
    if (c_hi >= p.sk) return false;
    if (c_hi < p.prefix_len) return true;
    if (p.causal && c_hi > row_lo) return false;
    if (p.has_window && k0 <= row_hi - p.window) return false;
    return true;
  };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int d16 = (dim + 15) >> 4;  // 16-column steps of D that hold data
  const int row0 = row_lo + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const float qk_scale = p.scale * kLog2e;  // scores in the log2 domain

  float o[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.0f, 0.0f};

  int kt = next_visible(0);
  if (kt < kt_end) {
    stage_rows<T, kTcRows, DP, LD>(q_s, qg, rows_here, dim, p.vec);
    stage_rows<T, BN, DP, LD>(k_s, kg + static_cast<size_t>(kt) * BN * dim,
                              p.sk - kt * BN, dim, p.vec);
    stage_rows<T, BN, DVP, LDV>(v_s, vg + static_cast<size_t>(kt) * BN * dv,
                                p.sk - kt * BN, dv, p.vec);
    cp_async_commit();
  }
  for (int stage = 0; kt < kt_end; stage ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt landed for every thread; the other stage is free
    const int nxt = next_visible(kt + 1);
    if (nxt < kt_end) {
      const size_t row = static_cast<size_t>(nxt) * BN;
      stage_rows<T, BN, DP, LD>(k_s + (stage ^ 1) * BN * LD, kg + row * dim, p.sk - nxt * BN,
                                dim, p.vec);
      stage_rows<T, BN, DVP, LDV>(v_s + (stage ^ 1) * BN * LDV, vg + row * dv, p.sk - nxt * BN,
                                  dv, p.vec);
    }
    cp_async_commit();
    const T* ks = k_s + stage * BN * LD;
    const T* vs = v_s + stage * BN * LDV;
    const int k0 = kt * BN;

    // S = Q K^T for the warp's 16 rows and the tile's BN keys.
    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      if (kk < d16) {
        uint32_t a[4];
        ldmatrix_x4(a, q_s + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nb = 0; nb < NB; nb += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, ks + (nb * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                             ((lane >> 3) & 1) * 8);
          Mma<T>::run(s[nb], a, b[0], b[1]);
          Mma<T>::run(s[nb + 1], a, b[2], b[3]);
        }
      }
    }

    // Scale, softcap and mask; element e of block nb is row row0 + 8 * (e / 2),
    // key k0 + 8 * nb + 2 * t + e % 2.
    const bool masked = !whole(k0);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e];
        x = p.has_softcap ? p.softcap * tanhf(x * p.scale / p.softcap) * kLog2e : x * qk_scale;
        if (masked) {
          const int col = k0 + nb * 8 + 2 * t + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          bool vis = true;
          if (p.causal) vis = col <= row;
          if (p.has_window) vis = vis && col > row - p.window;
          vis = (vis || col < p.prefix_len) && col < p.sk;
          if (!vis) x = -INFINITY;
        }
        s[nb][e] = x;
      }
    }

    // Online softmax: the quad's row max, rescale, P = 2^(s - m).
    float mu[2], alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) mx = fmaxf(mx, fmaxf(s[nb][2 * r], s[nb][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m_r[r], mx);
      mu[r] = m_new == -INFINITY ? 0.0f : m_new;  // no key seen yet: every P is 0
      alpha[r] = exp2f(m_r[r] - mu[r]);           // 0 while m_r is -inf
      m_r[r] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[nb][e] - mu[e >> 1]);
        s[nb][e] = pe;
        sum[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + sum[r];
#pragma unroll
    for (int j = 0; j < DB; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V: P from registers as the A operand, V through ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a[0] = Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]);
      a[1] = Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]);
      a[2] = Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int db = 0; db < DB; db += 2) {
        if (db * 8 < dv) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV +
                                   db * 8 + (lane >> 4) * 8);
          Mma<T>::run(o[db], a, b[0], b[1]);
          Mma<T>::run(o[db + 1], a, b[2], b[3]);
        }
      }
    }
    kt = nxt;
  }

  // l over the quad, then O / l (0 for a row that saw no key).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(kFull, l, 1);
    l += __shfl_xor_sync(kFull, l, 2);
    const float inv = l > 0.0f ? 1.0f / l : 0.0f;
    const int local = warp * 16 + g + 8 * r;
    if (local >= rows_here) continue;
    if (p.lse != nullptr && t == 0)  // m_r is in the log2 domain, shared by the quad
      p.lse[lse_row0 + local] = l > 0.0f ? (m_r[r] + log2f(l)) * kLn2 : -INFINITY;
    T* orow = og + static_cast<size_t>(local) * dv;
#pragma unroll
    for (int db = 0; db < DB; ++db) {
      const int col = db * 8 + 2 * t;
      if (col >= dv) continue;
      const float x0 = o[db][2 * r] * inv;
      const float x1 = o[db][2 * r + 1] * inv;
      if ((dv & 1) == 0) {
        *reinterpret_cast<uint32_t*>(orow + col) = Mma<T>::pack(x0, x1);
      } else {
        orow[col] = from_f<T>(x0);
        if (col + 1 < dv) orow[col + 1] = from_f<T>(x1);
      }
    }
  }
}

template <typename T, int DP, int DVP>
int launch_tc(Params p, cudaStream_t stream) {
  const size_t smem = sizeof(T) * TcTile<DP, DVP>::SMEM_ELEMS;
  static bool opted_in = false;  // above 48 KB once per instantiation
  if (smem > 48 * 1024 && !opted_in) {
    cudaError_t e = cudaFuncSetAttribute(flash_tc_kernel<T, DP, DVP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const int n_qt = (p.sq + kTcRows - 1) / kTcRows;
  const int blocks = p.n_batch * p.n_heads * n_qt;
  flash_tc_kernel<T, DP, DVP><<<blocks, kTcThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Whether an instantiation takes q and k of width dim and v of width dv.
bool tc_widths(int dim, int dv) {
  return dv == dim ? (dim >= 1 && dim <= kMaxD)
                   : (dim >= 1 && dim <= kMlaD && dv >= 1 && dv <= kMlaDv);
}

template <typename T>
int launch_tc_dim(Params p, cudaStream_t stream) {
  if (p.dv != p.dim) return launch_tc<T, kMlaD, kMlaDv>(p, stream);
  if (p.dim <= 64) return launch_tc<T, 64, 64>(p, stream);
  if (p.dim <= 128) return launch_tc<T, 128, 128>(p, stream);
  return launch_tc<T, kMaxD, kMaxD>(p, stream);
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs (the tolerance tests' path)
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // 16 query rows per block
constexpr int kBlockK = 32;                     // keys per tile: one per lane
constexpr int kColsPerLane = kMaxD / 32;  // output columns a lane holds: Dv <= kMaxD

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

__global__ void __launch_bounds__(kThreads) flash_f32_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dim = p.dim;
  const int dv = p.dv;
  float* q_s = reinterpret_cast<float*>(smem);  // [kBlockQ][dim]
  float* k_s = q_s + kBlockQ * dim;              // [kBlockK][k_stride]
  float* v_s = k_s + static_cast<size_t>(kBlockK) * p.k_stride;  // [kBlockK][v_stride]

  const int n_qt = (p.sq + kBlockQ - 1) / kBlockQ;
  int blk = blockIdx.x;
  const int qt = blk % n_qt;
  blk /= n_qt;
  const int h = blk % p.n_heads;
  const int bi = blk / p.n_heads;
  const int hk = h / (p.n_heads / p.n_kv_heads);
  const int q0 = qt * kBlockQ;
  const int rows_here = min(kBlockQ, p.sq - q0);

  const float* qg = static_cast<const float*>(p.q) +
                    ((static_cast<size_t>(bi) * p.n_heads + h) * p.sq + q0) * dim;
  const float* kg = static_cast<const float*>(p.k) +
                    (static_cast<size_t>(bi) * p.n_kv_heads + hk) * p.sk * dim;
  const float* vg = static_cast<const float*>(p.v) +
                    (static_cast<size_t>(bi) * p.n_kv_heads + hk) * p.sk * dv;
  float* og =
      static_cast<float*>(p.o) + ((static_cast<size_t>(bi) * p.n_heads + h) * p.sq + q0) * dv;

  for (int i = threadIdx.x; i < kBlockQ * dim; i += kThreads)
    q_s[i] = i < rows_here * dim ? qg[i] : 0.0f;

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
      k_s[j * p.k_stride + i - j * dim] = kg[static_cast<size_t>(k0) * dim + i];
    }
    for (int i = threadIdx.x; i < nk * dv; i += kThreads) {
      const int j = i / dv;
      v_s[j * p.v_stride + i - j * dv] = vg[static_cast<size_t>(k0) * dv + i];
    }
    __syncthreads();

    // Lane j scores key k0 + j against the warp's rows.
    const int col = k0 + lane;
    const bool key_ok = lane < nk;
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.0f;
    if (key_ok) {
      const float* krow = k_s + lane * p.k_stride;
      for (int d = 0; d < dim; ++d) {
        const float kd = krow[d];
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
        const float* vrow = v_s + jj * p.v_stride;
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) {
          const int d = lane + 32 * c;
          if (d < dv) acc[r][c] += pv * vrow[d];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int local = warp * kRowsPerWarp + r;
    if (local >= rows_here) break;
    const float inv = l[r] > 0.0f ? 1.0f / l[r] : 0.0f;
    if (p.lse != nullptr && lane == 0)
      p.lse[(static_cast<size_t>(bi) * p.n_heads + h) * p.sq + q0 + local] =
          l[r] > 0.0f ? m[r] + logf(l[r]) : -INFINITY;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < dv) og[static_cast<size_t>(local) * dv + d] = acc[r][c] * inv;
    }
  }
}

int launch_f32(Params p, cudaStream_t stream) {
  p.k_stride = p.dim | 1;  // odd word strides: lane j's read of row j in its own bank
  p.v_stride = p.dv | 1;
  const size_t smem = sizeof(float) * (kBlockQ * p.dim + kBlockK * (p.k_stride + p.v_stride));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_qt = (p.sq + kBlockQ - 1) / kBlockQ;
  const int blocks = p.n_batch * p.n_heads * n_qt;
  flash_f32_kernel<<<blocks, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. dim is q's and k's head
// width, dv v's and o's. has_window/has_softcap select the optional
// masks. lse, when not null, receives the rows' log-sum-exp. Returns
// cudaGetLastError() after the launch (0 on success), or -1 for a dtype
// code or (dim, dv) it has no instantiation for.
extern "C" int acs_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   float* lse,
                                   int n_batch, int n_heads, int n_kv_heads, int sq, int sk,
                                   int dim, int dv, int dtype, float scale, int causal,
                                   int has_window, int window, int has_softcap,
                                   float softcap, int q_offset, int prefix_len,
                                   void* stream) {
  if (!tc_widths(dim, dv)) return -1;
  const int vec = dim % 8 == 0 && dv % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  Params p{q, k, v, o, lse, n_batch, n_heads, n_kv_heads, sq, sk, dim, dv, 0, 0, scale, causal,
           has_window, window, has_softcap, softcap, q_offset, prefix_len, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(p, s);
  if (dtype == 1) return launch_tc_dim<__nv_bfloat16>(p, s);
  if (dtype == 2) return launch_tc_dim<__half>(p, s);
  return -1;
}
