// Flash attention's backward on Hopper (sm_90a) on wgmma, fed by TMA: dQ,
// dK and dV from q, k, v, the forward's output o, its row log-sum-exp lse
// and the output's gradient dO, in bfloat16 and float16. TMA must be able
// to address the rows (D % 8 == 0, every pointer 16-byte aligned): where
// the tensors themselves are not so, the wrapper (flash_attention.py
// backward_path, "wgmma_padded") passes aligned copies zero-padded to a
// multiple of 8 columns. flash_attention_bwd.cu holds the float32 path and
// says what this computes:
// the plain version's semantics (kernels/ref.py attention_bwd_ref), which
// the reference reaches through XLA's derivative of its oracle (no Pallas
// kernel of the reference has a backward).
//
// Bound on this card: the bytes (q, k, v, o, dO read once, lse once, dQ,
// dK, dV written once, over 3.35 TB/s) or the operations (the five
// products S = Q K^T, dP, dV, dQ and dK over the visible (row, key) pairs,
// 2 * 5 * D each, over 989 TFLOP/s for bf16), whichever is larger. At
// minicpm-2b's training shape [4, 36, 512, 64] causal that is 75.8 MB
// (0.0226 ms) against 12.1 GFLOP (0.0122 ms): the bytes. At
// recurrentgemma-2b's [4, 10, 512, 256] causal over one kv head, ~46 MB
// (0.0138 ms) against 13.4 GFLOP (0.0136 ms).
//
// Design, FlashAttention-2/3's backward in two passes, deterministic: no
// atomics, and every sum in one fixed order, so the same inputs give the
// same bits run after run.
// * Each pass is warp-specialised: two consumer warpgroups run the
//   products on wgmma with float32 accumulators in registers, and a
//   producer warp feeds them by TMA (3-D
//   tensor maps [planes][rows][D], 128-byte swizzle, rows past the tensor
//   and columns past D landing as 0) through an mbarrier ring (2 stages at
//   D 256, 4 below); setmaxnreg gives the producer warpgroup's registers
//   to the consumers (232 each), so the 128-register accumulators do not
//   spill. Building blocks: sm90_wgmma.cuh.
//   - Prologue: Di = rowsum(dO * O), 8 lanes a row, 16-byte loads, and
//     lse in the log2 domain beside it (one pass over o and dO).
//   - Key-tile pass (dK, dV): the wrapper's plan (backward_plan) gives
//     each block a key tile of one (batch, kv head) and a run of its items
//     (query head, 64-row query tile), so that the grid fills the SMs:
//     recurrentgemma-2b's 10 heads over one kv head give 252 blocks where
//     one block a key tile gave 64. S^T = K Q^T and dP^T = V dO^T are
//     computed once per (key tile, query tile). At D <= 128 each consumer
//     warpgroup owns 64 of the block's 128 keys and keeps P^T and dS^T in
//     registers as the A operands of dV += P^T dO and dK += dS^T Q; at D
//     256 the two share 64 keys, each computes S^T and dP^T for half the
//     queries and writes P^T and dS^T (rounded to bf16 / f16) to shared
//     memory, and warpgroup 0 accumulates dV, warpgroup 1 dK, all 256
//     columns each. A key tile split over several blocks leaves float32
//     partial sums in a workspace, which a reduction adds in slot order;
//     a key tile's only block writes dK and dV itself.
//   - Query-tile pass (dQ): a block owns 128 query rows of one (batch,
//     head), 64 a consumer warpgroup, and streams the key tiles they see
//     (64 keys; 32 at D 256): S = Q K^T and dP = dO V^T on wgmma, dS in
//     registers, dQ += dS K with dS as the register A operand.
//   - MLA's widths, persistent: with 128 heads over 128, a key tile's
//     items are its query tiles only (1-8), so a block a unit ran 4,096
//     short blocks whose set-up, k / v landing and epilogue nothing hid.
//     Both passes run one block an SM instead, each walking a list of units
//     (plan rows; dQ units of 128 rows) that the wrapper splits by
//     longest-processing-time first (lpt_split, deterministic). In the
//     key-tile pass a second producer warp lands the next row's k and v in
//     a second buffer while this row's items run, an item's dV / dK
//     product stays in flight under the next item's S^T and dP^T, and the
//     results leave by TMA stores out of the row's own k / v buffer; the dQ
//     pass streams 64-key tiles through a 3-stage ring, each consumer
//     warpgroup frees its dO buffer after its unit's last S and dP (the
//     next unit's dO lands while dQ finishes), and dQ leaves by a TMA store
//     out of the warpgroup's q tile. mbarrier phases run on across units.
//     A split key tile still leaves float32 partials for the slot-ordered
//     reduction: no atomics anywhere.
//   - The elementwise step skips the per-pair mask where a whole tile is
//     visible, and is specialised on the softcap: one compact loop runs a
//     step (one loop that branched on both per pair spread its code over
//     tens of kilobytes, more than the instruction cache holds;
//     kernels/bwd_trace.py times a block's steps on the card).
// Tiles are templated on two padded widths, DK for q, k, dQ and dK and DV
// for v, o, dO and dV: (64, 64), (128, 128), (256, 256), and MLA's (192,
// 128), whose products run over their own widths (S and dQ, dK over 192;
// dP and dV over 128: 192 is a legal wgmma N, three 64-column boxes). At
// deepseek-v2's training shape [4, 128, 512, 192], v [.., 128], causal:
// q, k, dQ, dK 100.7 MB each, v, o, dO, dV 67.1 MB each, ~671 MB (0.200
// ms at 3.35 TB/s) against 67.2 M visible pairs x 2 x (3 x 192 + 2 x 128)
// = 111.9 GFLOP (0.113 ms): the bytes. On an H100 80GB HBM3 at 700 W
// (kernels/bwd_times.py) the persistent passes take 0.67 ms of device
// time there, a block a unit took 0.84.

#include "flash_attention_bwd.cuh"
#include "sm90_tiles.cuh"
#include "sm90_wgmma.cuh"

#include <cmath>
#include <cstddef>
#include <type_traits>

namespace {

using namespace flash_bwd;
using namespace sm90;

#if !defined(ACS_FLASH_BWD_MAX_D)
#error "build through flash_attention.py, which defines the head widths"
#endif

#if !defined(ACS_FLASH_SPLIT_D) || !defined(ACS_FLASH_SPLIT_DV)
#error "build through flash_attention.py, which defines the head widths"
#endif

constexpr int kMaxD = ACS_FLASH_BWD_MAX_D;  // Dv == D up to this width
static_assert(kMaxD == 256, "the instantiations pad D to 64, 128 or 256");
// Dv != D: D up to kSplitD with Dv up to kSplitDv (MLA's 192 and 128), on
// one instantiation at those widths.
constexpr int kSplitD = ACS_FLASH_SPLIT_D, kSplitDv = ACS_FLASH_SPLIT_DV;
static_assert(kSplitD % 64 == 0 && kSplitDv % 64 == 0 && kSplitD <= 256 && kSplitDv <= kSplitD,
              "the split widths are whole 64-column boxes");

// ---------------------------------------------------------------------------
// bfloat16 / float16 on wgmma, fed by TMA (the wgmma path)
// ---------------------------------------------------------------------------

// Every wgmma kernel runs two consumer warpgroups and a producer
// warpgroup whose warp 8 issues the copies (warps 9-11 only give their
// registers back): 384 threads compile to 168 registers each, which
// would spill the dK / dV / dQ accumulators, so setmaxnreg drops the
// producer to 40 and lifts the consumers to 232. One block an SM.
constexpr int kWgThreads = 3 * 128;
constexpr int kProducerRegs = 40;   // (168 - 40) x 128 registers given back
constexpr int kConsumerRegs = 232;  // (232 - 168) x 256 taken
constexpr int kWgRows = 64;         // query rows an item; a warpgroup's rows in the dQ pass
constexpr int kBox = 64 * 64 * 2;   // one [64][64] box of 16-bit elements

// The tiles at padded widths DK (q, k, dQ, dK) and DV (v, o, dO, dV).
template <int DK, int DV> struct WgShape {
  // Key-tile pass: at DK, DV <= 128 each consumer warpgroup owns 64 keys
  // and every column of their dK and dV (P^T and dS^T stay in registers as
  // the A operands); wider (DK 256: 128 accumulator registers for one of dK
  // or dV; MLA's DK 192, DV 128) the two share 64 keys, one accumulating dV,
  // the other dK.
  static constexpr bool kRowSplit = DK <= 128 && DV <= 128;
  static constexpr int kKeys = kRowSplit ? 128 : 64;       // keys a block of the key-tile pass
  static constexpr int kStages = DK > 128 ? 2 : 4;         // both passes' rings (one block a unit)
  // MLA's (192, 128) runs both passes persistent (see the kernels below),
  // with rings of kPersistStages and 64-key tiles in the dQ pass; D 256
  // streams 32-key tiles there (its dQ accumulator takes 128 registers).
  static constexpr bool kPersistent = DK != DV;
  static constexpr int kPersistStages = 3;
  static constexpr int kDqKeys = DK == 256 ? 32 : 64;      // keys a streamed tile of the dQ pass
  static constexpr int kTileK = (DK / 64) * kBox;          // bytes of a [64][DK] tile
  static constexpr int kTileV = (DV / 64) * kBox;          // bytes of a [64][DV] tile
  static constexpr int kWs = DK > DV ? DK : DV;            // a workspace row's floats
};

// Di = rowsum(dO * O) at the bytes' pace: 8 lanes a row, 16-byte loads, a
// fixed-order butterfly inside each 8-lane group (Dv % 8 == 0, aligned).
template <typename T>
__global__ void __launch_bounds__(kDotThreads) flash_bwd_dot16_kernel(const Params p) {
  const size_t row = (static_cast<size_t>(blockIdx.x) * kDotThreads + threadIdx.x) >> 3;
  const int sub = threadIdx.x & 7;
  const bool live = row < static_cast<size_t>(p.n_batch) * p.n_heads * p.sq;
  float acc = 0.0f;
  if (live) {
    const uint4* o = reinterpret_cast<const uint4*>(static_cast<const T*>(p.o) + row * p.dim_v);
    const uint4* d =
        reinterpret_cast<const uint4*>(static_cast<const T*>(p.dout) + row * p.dim_v);
    for (int c = sub; c < p.dim_v / 8; c += 8) {
      const uint4 a = o[c];
      const uint4 b = d[c];
      const T* ae = reinterpret_cast<const T*>(&a);
      const T* be = reinterpret_cast<const T*>(&b);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc += to_f<T>(ae[e]) * to_f<T>(be[e]);
    }
  }
  acc += __shfl_xor_sync(kFull, acc, 4);
  acc += __shfl_xor_sync(kFull, acc, 2);
  acc += __shfl_xor_sync(kFull, acc, 1);
  if (live && sub == 0) {
    p.di[row] = acc;
    p.lse2[row] = lse2_of(p.lse[row]);
  }
}

// Whether every (row, key) pair of rows r_lo .. r_hi and keys c_lo ..
// c_hi is visible (then the elementwise step skips the per-pair mask).
__device__ __forceinline__ bool all_visible(const Params& p, int r_lo, int r_hi, int c_lo,
                                            int c_hi) {
  if (c_hi >= p.sk) return false;
  if (c_hi < p.prefix_len) return true;
  if (p.causal && c_hi > r_lo) return false;
  return !(p.has_window && c_lo <= r_hi - p.window);
}

// The elementwise step's constants: the score's scale in the log2 domain;
// with a softcap, the tanh argument's scale and the cap in the log2 domain.
struct PairConsts {
  float scale2, cap_in, cap2;
  __device__ explicit PairConsts(const Params& p)
      : scale2(p.scale * kLog2e),
        cap_in(p.has_softcap ? p.scale / p.softcap : 0.0f),
        cap2(p.softcap * kLog2e) {}
};

// P and dS of one pair: s the raw score, lse2 the row's lse in the log2
// domain, dp the pair's dP, di the row's Di; a pair not visible gets 0.
template <bool kSoftcap>
__device__ __forceinline__ void pair_grad(const PairConsts& c, float s, float lse2, float dp,
                                          float di, bool vis, float& pe, float& ds) {
  if constexpr (kSoftcap) {
    const float th = tanhf(s * c.cap_in);
    pe = vis ? exp2f(fmaf(c.cap2, th, -lse2)) : 0.0f;
    ds = pe * (dp - di) * (1.0f - th * th);
  } else {
    pe = vis ? exp2f(fmaf(s, c.scale2, -lse2)) : 0.0f;
    ds = pe * (dp - di);
  }
}

// Run the elementwise body once, specialised on whether every pair is
// visible and on the softcap: four straight-line loops, one of which runs
// a step (a loop that branched on both per pair spread its code over tens
// of kilobytes and ran from an instruction cache that could not hold it).
template <typename F>
__device__ __forceinline__ void with_pair_kind(bool all, bool softcap, F&& body) {
  using Y = std::true_type;
  using N = std::false_type;
  if (softcap) {
    if (all) body(Y{}, Y{}); else body(N{}, Y{});
  } else {
    if (all) body(Y{}, N{}); else body(N{}, N{});
  }
}

// The key-tile pass's shared memory and barriers.
template <int DK, int DV>
struct DkdvSmem {
  using S = WgShape<DK, DV>;
  unsigned char* k_s;  // [kKeys / 64] tiles
  unsigned char* v_s;
  unsigned char* q_s;  // [stage] tiles
  unsigned char* do_s;
  unsigned char* pt_s;   // wide: P^T [64 keys][64 queries], swizzled
  unsigned char* dst_s;  // wide: dS^T
  float* lse_s;          // [stage][64], log2 domain (0 past Sq)
  float* di_s;           // [stage][64]
  uint64_t* kv_full;
  uint64_t* full;   // [stage]: the producer warp's 32 lanes and its bytes (33 arrivals)
  uint64_t* empty;  // [stage]: one thread of each consumer warpgroup

  static constexpr int kKvTiles = S::kKeys / 64;
  static constexpr size_t bytes() {
    return 1024 + (kKvTiles + S::kStages) * static_cast<size_t>(S::kTileK + S::kTileV) +
           (S::kRowSplit ? 0 : 2 * kBox) + 2 * S::kStages * kWgRows * sizeof(float) +
           (1 + 2 * S::kStages) * 8;
  }
  __device__ explicit DkdvSmem(unsigned char* raw) {
    k_s = align1024(raw);
    v_s = k_s + kKvTiles * S::kTileK;
    q_s = v_s + kKvTiles * S::kTileV;
    do_s = q_s + S::kStages * S::kTileK;
    pt_s = do_s + S::kStages * S::kTileV;
    dst_s = pt_s + kBox;
    lse_s = reinterpret_cast<float*>(S::kRowSplit ? pt_s : dst_s + kBox);
    di_s = lse_s + S::kStages * kWgRows;
    kv_full = reinterpret_cast<uint64_t*>(di_s + S::kStages * kWgRows);
    full = kv_full + 1;
    empty = full + S::kStages;
  }
};

// The key-tile pass's q / dO ring: kStages stages of q and dO tiles and
// their rows' lse (log2 domain) and Di, the stages' barriers, and (the
// wide arrangement) the P^T and dS^T hand-off tiles.
struct ItemRing {
  unsigned char* q_s;
  unsigned char* do_s;
  unsigned char* pt_s;
  unsigned char* dst_s;
  float* lse_s;
  float* di_s;
  uint64_t* full;   // [stage]: the producer warp's 32 lanes and its bytes (33 arrivals)
  uint64_t* empty;  // [stage]: one thread of each consumer warpgroup
};

// One plan row's items into the ring (the producer warp's 32 lanes): the
// q and dO tiles by TMA and the rows' lse and Di by 4-byte cp.async copies,
// each lane arriving when its copies land, nothing of it waiting on a
// load. Ring positions i0 .. i0 + n_items - 1.
template <int DK, int DV, int kStages>
__device__ __forceinline__ void produce_items(const Params& p, const ItemRing& r,
                                              const CUtensorMap* map_q, const CUtensorMap* map_do,
                                              int bh0, int qt_begin, int n_q, int it_lo,
                                              int n_items, int i0, int lane) {
  using S = WgShape<DK, DV>;
  constexpr int NBK = DK / 64, NBV = DV / 64;
  for (int i = i0; i < i0 + n_items; ++i) {
    const int s = i % kStages;
    mbar_wait(&r.empty[s], ((i / kStages) & 1) ^ 1);
    const int it = it_lo + i - i0;
    const int bh = bh0 + it / n_q;
    const int q0 = (qt_begin + it % n_q) * kWgRows;
    if (lane == 0) {
      mbar_arrive_expect_tx(&r.full[s], S::kTileK + S::kTileV);
#pragma unroll
      for (int b = 0; b < NBK; ++b)
        tma_load_3d(r.q_s + s * S::kTileK + b * kBox, map_q, &r.full[s], 64 * b, q0, bh);
#pragma unroll
      for (int b = 0; b < NBV; ++b)
        tma_load_3d(r.do_s + s * S::kTileV + b * kBox, map_do, &r.full[s], 64 * b, q0, bh);
    }
    // Rows past Sq land as 0: their q and dO rows are 0 too, so P = 1
    // there multiplies zeros and dS = 0.
    const size_t rows = static_cast<size_t>(bh) * p.sq + q0;
#pragma unroll
    for (int rr = lane; rr < kWgRows; rr += 32) {
      const bool ok = q0 + rr < p.sq;
      cp_async4(&r.lse_s[s * kWgRows + rr], p.lse2 + (ok ? rows + rr : 0), ok);
      cp_async4(&r.di_s[s * kWgRows + rr], p.di + (ok ? rows + rr : 0), ok);
    }
    cp_async_mbar_arrive(&r.full[s]);
  }
}

// The k and v tiles of keys k0 .. k0 + 64 * tiles - 1 into k_s and v_s
// (one thread), announced on bar.
template <int DK, int DV>
__device__ __forceinline__ void load_kv(unsigned char* k_s, unsigned char* v_s, uint64_t* bar,
                                        const CUtensorMap* map_k, const CUtensorMap* map_v,
                                        int k0, int bhk, int tiles) {
  using S = WgShape<DK, DV>;
  mbar_arrive_expect_tx(bar, tiles * (S::kTileK + S::kTileV));
  for (int w = 0; w < tiles; ++w) {
#pragma unroll
    for (int b = 0; b < DK / 64; ++b)
      tma_load_3d(k_s + w * S::kTileK + b * kBox, map_k, bar, 64 * b, k0 + 64 * w, bhk);
#pragma unroll
    for (int b = 0; b < DV / 64; ++b)
      tma_load_3d(v_s + w * S::kTileV + b * kBox, map_v, bar, 64 * b, k0 + 64 * w, bhk);
  }
}

template <int DK, int DV>
__device__ __forceinline__ ItemRing ring_of(const DkdvSmem<DK, DV>& sm) {
  return {sm.q_s, sm.do_s, sm.pt_s, sm.dst_s, sm.lse_s, sm.di_s, sm.full, sm.empty};
}

// The key-tile pass's producer warp: the block's k and v tiles once, then
// each item's tiles through the ring.
template <int DK, int DV>
__device__ __forceinline__ void dkdv_produce(const Params& p, const DkdvSmem<DK, DV>& sm,
                                             const CUtensorMap* map_q, const CUtensorMap* map_k,
                                             const CUtensorMap* map_v, const CUtensorMap* map_do,
                                             int k0, int bhk, int bh0, int qt_begin, int n_q,
                                             int it_lo, int n_items, int lane) {
  if (lane == 0 && n_items > 0)
    load_kv<DK, DV>(sm.k_s, sm.v_s, sm.kv_full, map_k, map_v, k0, bhk,
                    DkdvSmem<DK, DV>::kKvTiles);
  produce_items<DK, DV, WgShape<DK, DV>::kStages>(p, ring_of(sm), map_q, map_do, bh0, qt_begin,
                                                  n_q, it_lo, n_items, 0, lane);
}

// A consumer warpgroup's dK (which 0, W = DK, times scale) or dV (which 1,
// W = DV) accumulators for rows row0 .. row0 + 63 of the block's keys: into
// the workspace at slot (a split key tile; rows of kWs floats), or rounded
// to T into dk / dv.
template <typename T, int W, int DK, int DV>
__device__ __forceinline__ void dkdv_store(const Params& p, const float (&acc)[W / 2], int which,
                                           int slot, int bhk, int k0, int row0, int tid) {
  using S = WgShape<DK, DV>;
  constexpr int KEYS = S::kKeys;
  const int wq = tid >> 5, gq = (tid & 31) >> 2, tq = tid & 3;
  if (slot >= 0) {
    float* ws = p.ws + (static_cast<size_t>(which) * p.n_slots + slot) * KEYS * S::kWs;
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(ws + (row0 + 16 * wq + gq + 8 * r) * S::kWs + 8 * j + 2 * tq) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    return;
  }
  const int width = which ? p.dim_v : p.dim;
  T* out = static_cast<T*>(which ? p.dv : p.dk) + (static_cast<size_t>(bhk) * p.sk + k0) * width;
  const float mul = which ? 1.0f : p.scale;
  const int keys_here = min(KEYS, p.sk - k0);
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * wq + gq + 8 * r;
      const int col = 8 * j + 2 * tq;
      if (row < keys_here && col < width)
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * width + col) =
            Mma<T>::pack(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
    }
}

// The persistent key-tile pass (MLA's widths) of one consumer warpgroup
// over one plan row's items, ring positions i0 .. i0 + n_items - 1 (the two
// warpgroups share the row's 64 keys, k_s and v_s): for each item, S^T = K
// Q^T over DK and dP^T = V dO^T over DV for its 32 queries, P^T and dS^T
// rounded to T into the shared swizzled tiles, then warpgroup 0 adds P^T
// dO to dV (W = DV) and warpgroup 1 dS^T Q to dK (W = DK), both operands in
// shared memory. An item's dV / dK product stays in flight while the next
// item's S^T and dP^T are issued; every product is complete when this
// returns.
template <typename T, int W, int DK, int DV, int kStages>
__device__ __forceinline__ void dkdv_wide_items(const Params& p, const ItemRing& ring,
                                                const unsigned char* k_s,
                                                const unsigned char* v_s, const PairConsts& pc,
                                                int wg, int tid, int k0, int qt_begin, int it_lo,
                                                int n_q, int n_items, int i0,
                                                float (&acc)[W / 2]) {
  using S = WgShape<DK, DV>;
  const int wq = tid >> 5, gq = (tid & 31) >> 2, tq = tid & 3;
  const unsigned char* a_s = wg == 0 ? ring.pt_s : ring.dst_s;  // dV += P^T dO; dK += dS^T Q
  const int key0 = k0 + 16 * wq + gq;
  int held = -1;  // the stage the product in flight reads
  for (int i = i0; i < i0 + n_items; ++i) {
    const int s = i % kStages;
    mbar_wait(&ring.full[s], (i / kStages) & 1);
    const int row0 = p.q_offset + (qt_begin + (it_lo + i - i0) % n_q) * kWgRows;
    const unsigned char* qs = ring.q_s + s * S::kTileK + wg * 32 * 128;  // this warpgroup's 32 queries
    const unsigned char* dos = ring.do_s + s * S::kTileV + wg * 32 * 128;
    float st[16], dpt[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {  // S^T = K Q^T
      const int off = (kk >> 2) * kBox + (kk & 3) * 32;
      Wgmma<T, 32>::template ss<0, 0>(st, desc_kmajor(k_s + off), desc_kmajor(qs + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {  // dP^T = V dO^T
      const int off = (kk >> 2) * kBox + (kk & 3) * 32;
      Wgmma<T, 32>::template ss<0, 0>(dpt, desc_kmajor(v_s + off), desc_kmajor(dos + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the last item's product is done
    fence_regs(acc);
    if (held >= 0 && tid == 0) mbar_arrive(&ring.empty[held]);
    wgmma_wait<0>();  // this item's S^T and dP^T
    fence_regs(st);
    fence_regs(dpt);
    const float* ls = ring.lse_s + s * kWgRows;
    const float* ds = ring.di_s + s * kWgRows;
    with_pair_kind(all_visible(p, row0 + 32 * wg, row0 + 32 * wg + 31, k0, k0 + 63),
                   p.has_softcap, [&](auto all, auto cap) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int qi = 32 * wg + 8 * (e >> 2) + 2 * tq + (e & 1);
        const bool vis = decltype(all)::value || visible(p, row0 + qi, key0 + 8 * ((e >> 1) & 1));
        pair_grad<decltype(cap)::value>(pc, st[e], ls[qi], dpt[e], ds[qi], vis, st[e], dpt[e]);
      }
    });
    named_sync(1, 256);  // both warpgroups' last products are done: pt_s, dst_s are free
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t off = sw128(16 * wq + gq + 8 * r, (32 * wg + 8 * j + 2 * tq) * 2);
        *reinterpret_cast<uint32_t*>(ring.pt_s + off) =
            Mma<T>::pack(st[4 * j + 2 * r], st[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(ring.dst_s + off) =
            Mma<T>::pack(dpt[4 * j + 2 * r], dpt[4 * j + 2 * r + 1]);
      }
    fence_async_smem();
    named_sync(1, 256);
    const unsigned char* bs = wg == 0 ? ring.do_s + s * S::kTileV : ring.q_s + s * S::kTileK;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgRows / 16; ++kk)
      Wgmma<T, W>::template ss<0, 1>(acc, desc_kmajor(a_s + kk * 32),
                                     desc_mnmajor(bs + kk * 2048, kBox), 1);
    wgmma_commit();
    held = s;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (held >= 0 && tid == 0) mbar_arrive(&ring.empty[held]);
}

// The wide key-tile pass of one consumer warpgroup (the two share the
// block's 64 keys): for each item, S^T = K Q^T over DK and dP^T = V dO^T
// over DV for its 32 queries, P^T and dS^T rounded to T into the shared
// swizzled tiles, then warpgroup 0 adds P^T dO to dV (W = DV) and
// warpgroup 1 dS^T Q to dK (W = DK), both operands in shared memory.
template <typename T, int W, int DK, int DV>
__device__ __forceinline__ void dkdv_wide(const Params& p, const DkdvSmem<DK, DV>& sm,
                                          const PairConsts& pc, int wg, int tid, int k0,
                                          int qt_begin, int it_lo, int n_q, int n_items,
                                          int slot, int bhk) {
  using S = WgShape<DK, DV>;
  const int wq = tid >> 5, gq = (tid & 31) >> 2, tq = tid & 3;
  const unsigned char* a_s = wg == 0 ? sm.pt_s : sm.dst_s;  // dV += P^T dO; dK += dS^T Q
  const int key0 = k0 + 16 * wq + gq;
  float acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.0f;
  for (int i = 0; i < n_items; ++i) {
    const int s = i % S::kStages;
    mbar_wait(&sm.full[s], (i / S::kStages) & 1);
    const int row0 = p.q_offset + (qt_begin + (it_lo + i) % n_q) * kWgRows;
    const unsigned char* qs = sm.q_s + s * S::kTileK + wg * 32 * 128;  // this warpgroup's 32 queries
    const unsigned char* dos = sm.do_s + s * S::kTileV + wg * 32 * 128;
    float st[16], dpt[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) st[e] = dpt[e] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {  // S^T = K Q^T
      const int off = (kk >> 2) * kBox + (kk & 3) * 32;
      Wgmma<T, 32>::template ss<0, 0>(st, desc_kmajor(sm.k_s + off), desc_kmajor(qs + off), 1);
    }
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {  // dP^T = V dO^T
      const int off = (kk >> 2) * kBox + (kk & 3) * 32;
      Wgmma<T, 32>::template ss<0, 0>(dpt, desc_kmajor(sm.v_s + off), desc_kmajor(dos + off), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    const float* ls = sm.lse_s + s * kWgRows;
    const float* ds = sm.di_s + s * kWgRows;
    with_pair_kind(all_visible(p, row0 + 32 * wg, row0 + 32 * wg + 31, k0, k0 + 63),
                   p.has_softcap, [&](auto all, auto cap) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int qi = 32 * wg + 8 * (e >> 2) + 2 * tq + (e & 1);
        const bool vis = decltype(all)::value || visible(p, row0 + qi, key0 + 8 * ((e >> 1) & 1));
        pair_grad<decltype(cap)::value>(pc, st[e], ls[qi], dpt[e], ds[qi], vis, st[e], dpt[e]);
      }
    });
    named_sync(1, 256);  // both warpgroups are past the last item's reads of pt_s, dst_s
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t off = sw128(16 * wq + gq + 8 * r, (32 * wg + 8 * j + 2 * tq) * 2);
        *reinterpret_cast<uint32_t*>(sm.pt_s + off) =
            Mma<T>::pack(st[4 * j + 2 * r], st[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(sm.dst_s + off) =
            Mma<T>::pack(dpt[4 * j + 2 * r], dpt[4 * j + 2 * r + 1]);
      }
    fence_async_smem();
    named_sync(1, 256);
    const unsigned char* bs = wg == 0 ? sm.do_s + s * S::kTileV : sm.q_s + s * S::kTileK;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgRows / 16; ++kk)
      Wgmma<T, W>::template ss<0, 1>(acc, desc_kmajor(a_s + kk * 32),
                                     desc_mnmajor(bs + kk * 2048, kBox), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (tid == 0) mbar_arrive(&sm.empty[s]);
  }
  dkdv_store<T, W, DK, DV>(p, acc, wg == 0 ? 1 : 0, slot, bhk, k0, 0, tid);
}

// dK and dV: block b runs row b of the wrapper's plan, items it_lo ..
// it_hi - 1 of key tile kt (kKeys keys) of (batch, kv head) bhk, an item
// being (query head, query tile) with heads outermost. Its k and v tiles
// land once; the producer streams the items' q and dO tiles and lse and Di
// through a kStages ring.
// * DK, DV <= 128: warpgroup wg owns keys 64 wg .. 64 wg + 63. Per item it
//   computes S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries, once
//   each), P^T and dS^T in registers, and adds P^T dO to dV and dS^T Q to
//   dK with P^T and dS^T rounded to T as the register A operands (dO and Q
//   read MN-major).
// * Wider: dkdv_wide.
// A split key tile's blocks store float32 partial sums into ws at their
// slot; a key tile's only block stores dK (times scale) and dV in T.
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __grid_constant__ CUtensorMap map_do, const Params p) {
  using S = WgShape<DK, DV>;
  extern __shared__ unsigned char smem_raw[];
  const DkdvSmem<DK, DV> sm(smem_raw);

  const int* plan = p.plan + 8 * blockIdx.x;
  const int kt = plan[0], bhk = plan[1], qt_begin = plan[2], n_q = plan[3];
  const int it_lo = plan[4], n_items = plan[5] - plan[4], slot = plan[6];
  const int group = p.n_heads / p.n_kv_heads;
  const int bi = bhk / p.n_kv_heads;
  const int bh0 = bi * p.n_heads + (bhk - bi * p.n_kv_heads) * group;  // the group's first head
  const int k0 = kt * S::kKeys;

  if (threadIdx.x == 0) {
    mbar_init(sm.kv_full, 1);
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&sm.full[s], 33);
      mbar_init(&sm.empty[s], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;

  if (warp >= 8) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 8)
      dkdv_produce<DK, DV>(p, sm, &map_q, &map_k, &map_v, &map_do, k0, bhk, bh0, qt_begin, n_q,
                           it_lo, n_items, threadIdx.x & 31);
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2;
  const int tid = threadIdx.x & 127;
  const int wq = tid >> 5;
  const int gq = (tid & 31) >> 2;
  const int tq = tid & 3;
  const PairConsts pc(p);
  if (n_items > 0) mbar_wait(sm.kv_full, 0);

  if constexpr (S::kRowSplit) {
    const unsigned char* ks = sm.k_s + wg * S::kTileK;
    const unsigned char* vs = sm.v_s + wg * S::kTileV;
    const int key0 = k0 + 64 * wg + 16 * wq + gq;  // this thread's keys: key0, key0 + 8
    float dk[DK / 2], dv[DV / 2];
#pragma unroll
    for (int i = 0; i < DK / 2; ++i) dk[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dv[i] = 0.0f;
    for (int i = 0; i < n_items; ++i) {
      const int s = i % S::kStages;
      mbar_wait(&sm.full[s], (i / S::kStages) & 1);
      const int row0 = p.q_offset + (qt_begin + (it_lo + i) % n_q) * kWgRows;  // query 0's position
      const unsigned char* qs = sm.q_s + s * S::kTileK;
      const unsigned char* dos = sm.do_s + s * S::kTileV;
      float st[32], dpt[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {  // S^T = K Q^T
        const int off = (kk >> 2) * kBox + (kk & 3) * 32;
        Wgmma<T, 64>::template ss<0, 0>(st, desc_kmajor(ks + off), desc_kmajor(qs + off), 1);
      }
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {  // dP^T = V dO^T
        const int off = (kk >> 2) * kBox + (kk & 3) * 32;
        Wgmma<T, 64>::template ss<0, 0>(dpt, desc_kmajor(vs + off), desc_kmajor(dos + off), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      const float* ls = sm.lse_s + s * kWgRows;
      const float* ds = sm.di_s + s * kWgRows;
      const int c_lo = k0 + 64 * wg;
      with_pair_kind(all_visible(p, row0, row0 + kWgRows - 1, c_lo, c_lo + 63), p.has_softcap,
                     [&](auto all, auto cap) {  // P^T and dS^T in place
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int qi = 8 * (e >> 2) + 2 * tq + (e & 1);
          const bool vis = decltype(all)::value || visible(p, row0 + qi, key0 + 8 * ((e >> 1) & 1));
          pair_grad<decltype(cap)::value>(pc, st[e], ls[qi], dpt[e], ds[qi], vis, st[e], dpt[e]);
        }
      });
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgRows / 16; ++kk) {  // dV += P^T dO
        uint32_t a[4];
        acc_to_a16<T>(a, st, kk);
        Wgmma<T, DV>::template rs<1>(dv, a, desc_mnmajor(dos + kk * 2048, kBox), 1);
      }
#pragma unroll
      for (int kk = 0; kk < kWgRows / 16; ++kk) {  // dK += dS^T Q
        uint32_t a[4];
        acc_to_a16<T>(a, dpt, kk);
        Wgmma<T, DK>::template rs<1>(dk, a, desc_mnmajor(qs + kk * 2048, kBox), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      if (tid == 0) mbar_arrive(&sm.empty[s]);
    }
    dkdv_store<T, DK, DK, DV>(p, dk, 0, slot, bhk, k0, 64 * wg, tid);
    dkdv_store<T, DV, DK, DV>(p, dv, 1, slot, bhk, k0, 64 * wg, tid);
  } else if (wg == 0) {
    dkdv_wide<T, DV, DK, DV>(p, sm, pc, wg, tid, k0, qt_begin, it_lo, n_q, n_items, slot, bhk);
  } else {
    dkdv_wide<T, DK, DK, DV>(p, sm, pc, wg, tid, k0, qt_begin, it_lo, n_q, n_items, slot, bhk);
  }
}

// The persistent key-tile pass's shared memory (MLA's widths): two k / v
// buffers (a plan row's and the next one's), a kPersistStages q / dO ring
// with its rows' lse and Di, and the P^T / dS^T hand-off tiles. At (192,
// 128): 2 x 40 KB + 3 x 40 KB + 16 KB, ~219 KB.
template <int DK, int DV>
struct PersistSmem {
  using S = WgShape<DK, DV>;
  static constexpr int kStages = S::kPersistStages;
  unsigned char* kv_s;  // [2][k tile, v tile]
  ItemRing ring;
  uint64_t* kv_full;   // [2]: the producer's copies
  uint64_t* kv_empty;  // [2]: one thread of each consumer warpgroup

  static constexpr size_t bytes() {
    return 1024 + (2 + kStages) * static_cast<size_t>(S::kTileK + S::kTileV) + 2 * kBox +
           2 * kStages * kWgRows * sizeof(float) + (4 + 2 * kStages) * 8;
  }
  __device__ explicit PersistSmem(unsigned char* raw) {
    kv_s = align1024(raw);
    ring.q_s = kv_s + 2 * (S::kTileK + S::kTileV);
    ring.do_s = ring.q_s + kStages * S::kTileK;
    ring.pt_s = ring.do_s + kStages * S::kTileV;
    ring.dst_s = ring.pt_s + kBox;
    ring.lse_s = reinterpret_cast<float*>(ring.dst_s + kBox);
    ring.di_s = ring.lse_s + kStages * kWgRows;
    kv_full = reinterpret_cast<uint64_t*>(ring.di_s + kStages * kWgRows);
    kv_empty = kv_full + 2;
    ring.full = kv_empty + 2;
    ring.empty = ring.full + kStages;
  }
  __device__ unsigned char* k_of(int buf) const { return kv_s + buf * (S::kTileK + S::kTileV); }
  __device__ unsigned char* v_of(int buf) const { return k_of(buf) + S::kTileK; }
};

// A plan row as the kernels read it.
struct PlanRow {
  int kt, bhk, qt_begin, n_q, it_lo, n_items, slot, bh0;
  __device__ PlanRow(const Params& p, int row) {
    const int* r = p.plan + 8 * row;
    kt = r[0];
    bhk = r[1];
    qt_begin = r[2];
    n_q = r[3];
    it_lo = r[4];
    n_items = r[5] - r[4];
    slot = r[6];
    const int group = p.n_heads / p.n_kv_heads;
    const int bi = bhk / p.n_kv_heads;
    bh0 = bi * p.n_heads + (bhk - bi * p.n_kv_heads) * group;  // the group's first head
  }
};

// One consumer warpgroup of the persistent key-tile pass: for each of its
// block's plan rows, the items (dkdv_wide_items) on that row's k / v
// buffer, then its dV (warpgroup 0, W = DV) or dK times scale (warpgroup
// 1, W = DK) out. A key tile's only block rounds it into the buffer's own
// k (dK) or v (dV) tile, which no product reads any more, and one thread
// TMA-stores it (clipped to Sk and the width) and frees the buffer once
// the store has read it, while the other warps start the next row; a split
// key tile's blocks write their float32 partial sums to the workspace.
template <typename T, int W, int DK, int DV>
__device__ __forceinline__ void dkdv_persistent_rows(const Params& p, const PersistSmem<DK, DV>& sm,
                                                     const CUtensorMap* map_out, int wg, int tid,
                                                     int row_lo, int row_hi) {
  const PairConsts pc(p);
  const int wq = tid >> 5, gq = (tid & 31) >> 2, tq = tid & 3;
  const float mul = wg == 0 ? 1.0f : p.scale;
  int i0 = 0;
  for (int row = row_lo, c = 0; row < row_hi; ++row, ++c) {
    const PlanRow u(p, row);
    const int buf = c & 1;
    const int k0 = u.kt * 64;
    mbar_wait(&sm.kv_full[buf], (c >> 1) & 1);
    float acc[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) acc[i] = 0.0f;
    dkdv_wide_items<T, W, DK, DV, PersistSmem<DK, DV>::kStages>(
        p, sm.ring, sm.k_of(buf), sm.v_of(buf), pc, wg, tid, k0, u.qt_begin, u.it_lo, u.n_q,
        u.n_items, i0, acc);
    i0 += u.n_items;
    if (u.slot >= 0) {
      dkdv_store<T, W, DK, DV>(p, acc, wg == 0 ? 1 : 0, u.slot, u.bhk, k0, 0, tid);
      if (tid == 0) mbar_arrive(&sm.kv_empty[buf]);
    } else {
      // Both warpgroups are past this row's last reads of k and v (the
      // item's second named barrier), so its tiles take the results.
      unsigned char* out_s = wg == 0 ? sm.v_of(buf) : sm.k_of(buf);
#pragma unroll
      for (int j = 0; j < W / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int col = 8 * j + 2 * tq;
          *reinterpret_cast<uint32_t*>(out_s + (col / 64) * kBox +
                                       sw128(16 * wq + gq + 8 * r, (col % 64) * 2)) =
              Mma<T>::pack(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
        }
      fence_async_smem();
      named_sync(2 + wg, 128);
      if (tid == 0) {
        const int width = wg == 0 ? p.dim_v : p.dim;
#pragma unroll
        for (int b = 0; b < W / 64; ++b)
          if (64 * b < width) tma_store_3d(map_out, out_s + b * kBox, 64 * b, k0, u.bhk);
        tma_store_commit();
        tma_store_wait_read();
        mbar_arrive(&sm.kv_empty[buf]);
      }
    }
  }
  if (tid == 0) tma_store_wait_all();
}

// dK and dV at MLA's widths, persistent: block b runs plan rows starts[b]
// .. starts[b + 1] - 1 (the wrapper's longest-processing-time split of the
// rows over the grid, by items). Warp 8 streams every row's items through
// the q / dO ring, warp 9 each row's k and v into the buffer the row
// before last has freed (the next row's tiles land while this one's items
// run), and the two consumer warpgroups run dkdv_persistent_rows. The
// mbarrier phases run on across rows: ring position i counts the block's
// items, buffer c & 1 its rows.
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_persistent_kernel(const __grid_constant__ CUtensorMap map_q,
                                 const __grid_constant__ CUtensorMap map_k,
                                 const __grid_constant__ CUtensorMap map_v,
                                 const __grid_constant__ CUtensorMap map_do,
                                 const __grid_constant__ CUtensorMap map_dk,
                                 const __grid_constant__ CUtensorMap map_dv, const Params p) {
  using M = PersistSmem<DK, DV>;
  extern __shared__ unsigned char smem_raw[];
  const M sm(smem_raw);
  const int row_lo = p.starts[blockIdx.x], row_hi = p.starts[blockIdx.x + 1];
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&sm.kv_full[b], 1);
      mbar_init(&sm.kv_empty[b], 2);
    }
    for (int s = 0; s < M::kStages; ++s) {
      mbar_init(&sm.ring.full[s], 33);
      mbar_init(&sm.ring.empty[s], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp >= 8) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 8) {
      for (int row = row_lo, i0 = 0; row < row_hi; ++row) {
        const PlanRow u(p, row);
        produce_items<DK, DV, M::kStages>(p, sm.ring, &map_q, &map_do, u.bh0, u.qt_begin, u.n_q,
                                          u.it_lo, u.n_items, i0, lane);
        i0 += u.n_items;
      }
    } else if (warp == 9 && lane == 0) {
      for (int row = row_lo, c = 0; row < row_hi; ++row, ++c) {
        const PlanRow u(p, row);
        mbar_wait(&sm.kv_empty[c & 1], ((c >> 1) & 1) ^ 1);
        load_kv<DK, DV>(sm.k_of(c & 1), sm.v_of(c & 1), &sm.kv_full[c & 1], &map_k, &map_v,
                        u.kt * 64, u.bhk, 1);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2;
  const int tid = threadIdx.x & 127;
  if (wg == 0)
    dkdv_persistent_rows<T, DV, DK, DV>(p, sm, &map_dv, wg, tid, row_lo, row_hi);
  else
    dkdv_persistent_rows<T, DK, DK, DV>(p, sm, &map_dk, wg, tid, row_lo, row_hi);
}

// A split key tile's dK (times scale) and dV: the sum of its blocks'
// partial sums in slot order. Row r of the wrapper's red table is spread
// over kChunks blocks of 256 threads, a float4 of a workspace row a
// thread; a row with no slots (a key tile no query sees) writes zeros.
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(256) flash_bwd_reduce_kernel(const Params p) {
  using S = WgShape<DK, DV>;
  constexpr int KEYS = S::kKeys;
  constexpr int C4 = S::kWs / 4;
  constexpr int kChunks = KEYS * C4 / 256;
  const int* red = p.red + 4 * (blockIdx.x / kChunks);
  const int k0 = red[0] * KEYS;
  const int bhk = red[1], lo = red[2], hi = red[3];
  const int e = (blockIdx.x % kChunks) * 256 + threadIdx.x;
  const int r = e / C4;
  const int c = (e - r * C4) * 4;
  if (r >= min(KEYS, p.sk - k0) || (c >= p.dim && c >= p.dim_v)) return;
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
  for (int sl = lo; sl < hi; ++sl) {
    const float4 x = *reinterpret_cast<const float4*>(
        p.ws + (static_cast<size_t>(sl) * KEYS + r) * S::kWs + c);
    const float4 y = *reinterpret_cast<const float4*>(
        p.ws + (static_cast<size_t>(p.n_slots + sl) * KEYS + r) * S::kWs + c);
    a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    b.x += y.x; b.y += y.y; b.z += y.z; b.w += y.w;
  }
  const size_t row = static_cast<size_t>(bhk) * p.sk + k0 + r;
  if (c < p.dim)
    *reinterpret_cast<uint2*>(static_cast<T*>(p.dk) + row * p.dim + c) =
        make_uint2(Mma<T>::pack(a.x * p.scale, a.y * p.scale),
                   Mma<T>::pack(a.z * p.scale, a.w * p.scale));
  if (c < p.dim_v)
    *reinterpret_cast<uint2*>(static_cast<T*>(p.dv) + row * p.dim_v + c) =
        make_uint2(Mma<T>::pack(b.x, b.y), Mma<T>::pack(b.z, b.w));
}

// dQ: a block owns 128 query rows of one (batch, head), 64 a consumer
// warpgroup (the last query tiles first), its q and dO tiles landing once;
// the producer warp streams the key tiles its rows see (kDqKeys keys, k
// and v) through a kStages ring. Per key tile a warpgroup computes S =
// Q K^T over DK and dP = dO V^T over DV, dS in registers, and adds dS K
// to dQ with dS as the register A operand and K read MN-major.
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do, const Params p) {
  using S = WgShape<DK, DV>;
  constexpr int NBK = DK / 64, NBV = DV / 64;
  constexpr int BN = S::kDqKeys;
  constexpr int KBOX = BN * 128;   // a [BN][64] box
  constexpr int KTK = NBK * KBOX;  // a [BN][DK] tile
  constexpr int KTV = NBV * KBOX;  // a [BN][DV] tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = align1024(smem_raw);  // [warpgroup] tiles
  unsigned char* do_s = q_s + 2 * S::kTileK;
  unsigned char* k_s = do_s + 2 * S::kTileV;  // [stage] tiles
  unsigned char* v_s = k_s + S::kStages * KTK;
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(v_s + S::kStages * KTV);
  uint64_t* full = qd_full + 1;
  uint64_t* empty = full + S::kStages;

  const int n_bh = p.n_batch * p.n_heads;
  const int n_qt = (p.sq + 2 * kWgRows - 1) / (2 * kWgRows);
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / n_bh;
  const int bh = static_cast<int>(blockIdx.x) % n_bh;
  const int bi = bh / p.n_heads;
  const int bhk = bi * p.n_kv_heads + (bh - bi * p.n_heads) / (p.n_heads / p.n_kv_heads);
  const int q0 = qt * 2 * kWgRows;

  // The key tiles the block's rows see (the wrapper's dq_span).
  const int prefix_tiles = p.dq_span[3 * qt];
  const int window_tile = p.dq_span[3 * qt + 1];
  const int kt_end = p.dq_span[3 * qt + 2];
  auto next_visible = [&](int kt) {
    return (kt >= prefix_tiles && kt < window_tile) ? window_tile : kt;
  };

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;

  if (warp >= 8) {  // producer: one thread
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != 8 * 32) return;
    mbar_arrive_expect_tx(qd_full, 2 * (S::kTileK + S::kTileV));
#pragma unroll
    for (int w = 0; w < 2; ++w) {
#pragma unroll
      for (int b = 0; b < NBK; ++b)
        tma_load_3d(q_s + w * S::kTileK + b * kBox, &map_q, qd_full, 64 * b, q0 + w * kWgRows, bh);
#pragma unroll
      for (int b = 0; b < NBV; ++b)
        tma_load_3d(do_s + w * S::kTileV + b * kBox, &map_do, qd_full, 64 * b, q0 + w * kWgRows,
                    bh);
    }
    int i = 0;
    for (int kt = next_visible(0); kt < kt_end; kt = next_visible(kt + 1), ++i) {
      const int s = i % S::kStages;
      mbar_wait(&empty[s], ((i / S::kStages) & 1) ^ 1);
      mbar_arrive_expect_tx(&full[s], KTK + KTV);
#pragma unroll
      for (int b = 0; b < NBK; ++b)
        tma_load_3d(k_s + s * KTK + b * KBOX, &map_k, &full[s], 64 * b, kt * BN, bhk);
#pragma unroll
      for (int b = 0; b < NBV; ++b)
        tma_load_3d(v_s + s * KTV + b * KBOX, &map_v, &full[s], 64 * b, kt * BN, bhk);
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2;
  const int tid = threadIdx.x & 127;
  const int gq = (tid & 31) >> 2;
  const int tq = tid & 3;
  const PairConsts pc(p);
  const int local0 = q0 + wg * kWgRows + 16 * (tid >> 5) + gq;  // this thread's rows: +0, +8
  const size_t row_base = static_cast<size_t>(bh) * p.sq;
  float lse2[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int local = local0 + 8 * r;
    lse2[r] = local < p.sq ? p.lse2[row_base + local] : INFINITY;
    di[r] = local < p.sq ? p.di[row_base + local] : 0.0f;
  }
  const int row_wg = p.q_offset + q0 + wg * kWgRows;  // the warpgroup's first row's position
  float acc[DK / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) acc[i] = 0.0f;
  const unsigned char* qs = q_s + wg * S::kTileK;
  const unsigned char* dos = do_s + wg * S::kTileV;
  mbar_wait(qd_full, 0);  // also when no key tile follows: the copies land before exit

  int i = 0;
  for (int kt = next_visible(0); kt < kt_end; kt = next_visible(kt + 1), ++i) {
    const int s = i % S::kStages;
    mbar_wait(&full[s], (i / S::kStages) & 1);
    const unsigned char* ks = k_s + s * KTK;
    const unsigned char* vs = v_s + s * KTV;
    float sa[BN / 2], dp[BN / 2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) sa[e] = dp[e] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)  // S = Q K^T
      Wgmma<T, BN>::template ss<0, 0>(sa, desc_kmajor(qs + (kk >> 2) * kBox + (kk & 3) * 32),
                                      desc_kmajor(ks + (kk >> 2) * KBOX + (kk & 3) * 32), 1);
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk)  // dP = dO V^T
      Wgmma<T, BN>::template ss<0, 0>(dp, desc_kmajor(dos + (kk >> 2) * kBox + (kk & 3) * 32),
                                      desc_kmajor(vs + (kk >> 2) * KBOX + (kk & 3) * 32), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sa);
    fence_regs(dp);
    with_pair_kind(all_visible(p, row_wg, row_wg + kWgRows - 1, kt * BN, kt * BN + BN - 1),
                   p.has_softcap, [&](auto all, auto cap) {  // dS in place of S
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const int r = (e >> 1) & 1;
        const bool vis = decltype(all)::value ||
                         visible(p, p.q_offset + local0 + 8 * r, kt * BN + 8 * (e >> 2) + 2 * tq + (e & 1));
        float pe;
        pair_grad<decltype(cap)::value>(pc, sa[e], lse2[r], dp[e], di[r], vis, pe, sa[e]);
      }
    });
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {  // dQ += dS K
      uint32_t a[4];
      acc_to_a16<T>(a, sa, kk);
      Wgmma<T, DK>::template rs<1>(acc, a, desc_mnmajor(ks + kk * 2048, KBOX), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (tid == 0) mbar_arrive(&empty[s]);
  }

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int j = 0; j < DK / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int local = local0 + 8 * r;
      const int col = 8 * j + 2 * tq;
      if (local < p.sq && col < p.dim)
        *reinterpret_cast<uint32_t*>(dq + (row_base + local) * p.dim + col) =
            Mma<T>::pack(acc[4 * j + 2 * r] * p.scale, acc[4 * j + 2 * r + 1] * p.scale);
    }
}

// dQ at MLA's widths, persistent: block b runs the units dq_units[
// dq_starts[b] .. dq_starts[b + 1] - 1] (the wrapper's longest-processing-
// time split of the one-block-a-unit grid by key tiles), a unit being 128
// query rows of one (batch, head), 64 a consumer warpgroup, as
// flash_bwd_dq_wgmma_kernel's block. Warp 8 streams every unit's 64-key k
// and v tiles through a kPersistStages ring; warp 9 loads each warpgroup's
// dO and q tiles into its buffers once the warpgroup has freed them: dO as
// soon as its unit's last S and dP products are done, so the next unit's
// dO lands while it finishes, q once dQ has left through that q tile by a
// TMA store (clipped to Sq and D). The phases run on across units.
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_persistent_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               const __grid_constant__ CUtensorMap map_do,
                               const __grid_constant__ CUtensorMap map_dq, const Params p) {
  using S = WgShape<DK, DV>;
  constexpr int NBK = DK / 64, NBV = DV / 64;
  constexpr int BN = S::kDqKeys;
  constexpr int kSt = S::kPersistStages;
  constexpr int KBOX = BN * 128;   // a [BN][64] box
  constexpr int KTK = NBK * KBOX;  // a [BN][DK] tile
  constexpr int KTV = NBV * KBOX;  // a [BN][DV] tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = align1024(smem_raw);  // [warpgroup] tiles
  unsigned char* do_s = q_s + 2 * S::kTileK;
  unsigned char* k_s = do_s + 2 * S::kTileV;  // [stage] tiles
  unsigned char* v_s = k_s + kSt * KTK;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kSt * KTV);  // [warpgroup]
  uint64_t* q_empty = q_full + 2;
  uint64_t* d_full = q_empty + 2;  // dO
  uint64_t* d_empty = d_full + 2;
  uint64_t* full = d_empty + 2;
  uint64_t* empty = full + kSt;

  const int n_bh = p.n_batch * p.n_heads;
  const int n_qt = (p.sq + 2 * kWgRows - 1) / (2 * kWgRows);
  const int u_lo = p.dq_starts[blockIdx.x], u_hi = p.dq_starts[blockIdx.x + 1];
  // Unit idx of the one-block-a-unit grid: query tile n_qt - 1 - idx / (B
  // H) of (batch, head) idx % (B H), and the key tiles its rows see.
  struct Unit {
    int bh, bhk, q0, prefix_tiles, window_tile, kt_end;
  };
  auto unit = [&](int u) {
    const int idx = p.dq_units[u];
    const int qt = n_qt - 1 - idx / n_bh;
    const int bh = idx % n_bh;
    const int bi = bh / p.n_heads;
    return Unit{bh, bi * p.n_kv_heads + (bh - bi * p.n_heads) / (p.n_heads / p.n_kv_heads),
                qt * 2 * kWgRows, p.dq_span[3 * qt], p.dq_span[3 * qt + 1],
                p.dq_span[3 * qt + 2]};
  };
  auto next_visible = [](const Unit& t, int kt) {
    return (kt >= t.prefix_tiles && kt < t.window_tile) ? t.window_tile : kt;
  };

  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w) {
      mbar_init(&q_full[w], 1);
      mbar_init(&q_empty[w], 1);
      mbar_init(&d_full[w], 1);
      mbar_init(&d_empty[w], 1);
    }
    for (int s = 0; s < kSt; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;

  if (warp >= 8) {  // producers: one thread each
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 8 * 32) {  // k and v
      int i = 0;
      for (int u = u_lo; u < u_hi; ++u) {
        const Unit t = unit(u);
        for (int kt = next_visible(t, 0); kt < t.kt_end; kt = next_visible(t, kt + 1), ++i) {
          const int s = i % kSt;
          mbar_wait(&empty[s], ((i / kSt) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], KTK + KTV);
#pragma unroll
          for (int b = 0; b < NBK; ++b)
            tma_load_3d(k_s + s * KTK + b * KBOX, &map_k, &full[s], 64 * b, kt * BN, t.bhk);
#pragma unroll
          for (int b = 0; b < NBV; ++b)
            tma_load_3d(v_s + s * KTV + b * KBOX, &map_v, &full[s], 64 * b, kt * BN, t.bhk);
        }
      }
    } else if (threadIdx.x == 9 * 32) {  // dO, then q
      for (int u = u_lo, c = 0; u < u_hi; ++u, ++c) {
        const Unit t = unit(u);
        for (int w = 0; w < 2; ++w) {
          mbar_wait(&d_empty[w], (c & 1) ^ 1);
          mbar_arrive_expect_tx(&d_full[w], S::kTileV);
#pragma unroll
          for (int b = 0; b < NBV; ++b)
            tma_load_3d(do_s + w * S::kTileV + b * kBox, &map_do, &d_full[w], 64 * b,
                        t.q0 + w * kWgRows, t.bh);
        }
        for (int w = 0; w < 2; ++w) {
          mbar_wait(&q_empty[w], (c & 1) ^ 1);
          mbar_arrive_expect_tx(&q_full[w], S::kTileK);
#pragma unroll
          for (int b = 0; b < NBK; ++b)
            tma_load_3d(q_s + w * S::kTileK + b * kBox, &map_q, &q_full[w], 64 * b,
                        t.q0 + w * kWgRows, t.bh);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2;
  const int tid = threadIdx.x & 127;
  const int gq = (tid & 31) >> 2;
  const int tq = tid & 3;
  const PairConsts pc(p);
  const unsigned char* qs = q_s + wg * S::kTileK;
  const unsigned char* dos = do_s + wg * S::kTileV;
  // A unit's rows' lse (log2 domain) and Di, this thread's two rows.
  auto row_stats = [&](const Unit& t, float (&lse2)[2], float (&di)[2]) {
    const int local0 = t.q0 + wg * kWgRows + 16 * (tid >> 5) + gq;
    const size_t row_base = static_cast<size_t>(t.bh) * p.sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int local = local0 + 8 * r;
      lse2[r] = local < p.sq ? p.lse2[row_base + local] : INFINITY;
      di[r] = local < p.sq ? p.di[row_base + local] : 0.0f;
    }
  };
  int i = 0;
  Unit t = unit(u_lo < u_hi ? u_lo : 0);
  float lse2[2], di[2];
  row_stats(t, lse2, di);
  for (int u = u_lo, c = 0; u < u_hi; ++u, ++c) {
    // The next unit and its rows' lse and Di, in flight through this one.
    const Unit t_next = unit(u + 1 < u_hi ? u + 1 : u);
    float lse2_next[2], di_next[2];
    row_stats(t_next, lse2_next, di_next);
    const int local0 = t.q0 + wg * kWgRows + 16 * (tid >> 5) + gq;  // this thread's rows: +0, +8
    const int row_wg = p.q_offset + t.q0 + wg * kWgRows;  // the warpgroup's first row's position
    float acc[DK / 2];
#pragma unroll
    for (int e = 0; e < DK / 2; ++e) acc[e] = 0.0f;
    mbar_wait(&d_full[wg], c & 1);
    mbar_wait(&q_full[wg], c & 1);
    int kt = next_visible(t, 0);
    if (kt >= t.kt_end && tid == 0) mbar_arrive(&d_empty[wg]);  // no key tile: free at once
    for (; kt < t.kt_end; ++i) {
      const int s = i % kSt;
      const int kt_next = next_visible(t, kt + 1);
      mbar_wait(&full[s], (i / kSt) & 1);
      const unsigned char* ks = k_s + s * KTK;
      const unsigned char* vs = v_s + s * KTV;
      float sa[BN / 2], dp[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk)  // S = Q K^T
        Wgmma<T, BN>::template ss<0, 0>(sa, desc_kmajor(qs + (kk >> 2) * kBox + (kk & 3) * 32),
                                        desc_kmajor(ks + (kk >> 2) * KBOX + (kk & 3) * 32),
                                        kk > 0);
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)  // dP = dO V^T
        Wgmma<T, BN>::template ss<0, 0>(dp, desc_kmajor(dos + (kk >> 2) * kBox + (kk & 3) * 32),
                                        desc_kmajor(vs + (kk >> 2) * KBOX + (kk & 3) * 32),
                                        kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sa);
      fence_regs(dp);
      if (kt_next >= t.kt_end && tid == 0) mbar_arrive(&d_empty[wg]);  // dO read for good
      with_pair_kind(all_visible(p, row_wg, row_wg + kWgRows - 1, kt * BN, kt * BN + BN - 1),
                     p.has_softcap, [&](auto all, auto cap) {  // dS in place of S
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) {
          const int r = (e >> 1) & 1;
          const bool vis = decltype(all)::value ||
                           visible(p, p.q_offset + local0 + 8 * r, kt * BN + 8 * (e >> 2) + 2 * tq + (e & 1));
          float pe;
          pair_grad<decltype(cap)::value>(pc, sa[e], lse2[r], dp[e], di[r], vis, pe, sa[e]);
        }
      });
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {  // dQ += dS K
        uint32_t a[4];
        acc_to_a16<T>(a, sa, kk);
        Wgmma<T, DK>::template rs<1>(acc, a, desc_mnmajor(ks + kk * 2048, KBOX), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (tid == 0) mbar_arrive(&empty[s]);  // the stage's k and v are read
      kt = kt_next;
    }
    // dQ (times scale) out through this warpgroup's q tile, which no
    // product reads any more; the tile is freed once the store has read it.
    unsigned char* out_s = q_s + wg * S::kTileK;
#pragma unroll
    for (int j = 0; j < DK / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int col = 8 * j + 2 * tq;
        *reinterpret_cast<uint32_t*>(out_s + (col / 64) * kBox +
                                     sw128(16 * (tid >> 5) + gq + 8 * r, (col % 64) * 2)) =
            Mma<T>::pack(acc[4 * j + 2 * r] * p.scale, acc[4 * j + 2 * r + 1] * p.scale);
      }
    fence_async_smem();
    named_sync(2 + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int b = 0; b < NBK; ++b)
        if (64 * b < p.dim) tma_store_3d(&map_dq, out_s + b * kBox, 64 * b, t.q0 + wg * kWgRows, t.bh);
      tma_store_commit();
      tma_store_wait_read();
      mbar_arrive(&q_empty[wg]);
    }
    t = t_next;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse2[r] = lse2_next[r];
      di[r] = di_next[r];
    }
  }
  if (tid == 0) tma_store_wait_all();
}

template <int DK, int DV>
constexpr size_t dq_persistent_smem() {
  using S = WgShape<DK, DV>;
  return 1024 + 2 * static_cast<size_t>(S::kTileK + S::kTileV) +
         S::kPersistStages * ((DK + DV) / 64) * S::kDqKeys * 128 + (8 + 2 * S::kPersistStages) * 8;
}

template <int DK, int DV>
constexpr size_t dq_wgmma_smem() {
  using S = WgShape<DK, DV>;
  return 1024 + 2 * static_cast<size_t>(S::kTileK + S::kTileV) +
         S::kStages * ((DK + DV) / 64) * S::kDqKeys * 128 + (1 + 2 * S::kStages) * 8;
}

// The prologue, the key-tile pass (the wrapper's n_plan rows: a block
// each, or over a persistent grid of `grid` blocks at MLA's widths), the
// reduction of its n_red split key tiles, and the query-tile pass (one
// block a unit, or a persistent grid of dq_grid blocks).
template <typename T, int DK, int DV>
int launch_wgmma(const Params& p, int n_plan, int n_red, int grid, int dq_grid,
                 cudaStream_t stream) {
  using S = WgShape<DK, DV>;
  const uint64_t d = p.dim, dv = p.dim_v;
  const uint64_t q_planes = static_cast<uint64_t>(p.n_batch) * p.n_heads;
  const uint64_t kv_planes = static_cast<uint64_t>(p.n_batch) * p.n_kv_heads;
  CUtensorMap map_q, map_do, map_k, map_v, map_k2, map_v2;
  int err = tensor_map_3d<T>(&map_q, p.q, d, p.sq, q_planes, 2 * d, 2 * d * p.sq, kWgRows);
  if (!err)
    err = tensor_map_3d<T>(&map_do, p.dout, dv, p.sq, q_planes, 2 * dv, 2 * dv * p.sq, kWgRows);
  if (!err) err = tensor_map_3d<T>(&map_k, p.k, d, p.sk, kv_planes, 2 * d, 2 * d * p.sk, 64);
  if (!err) err = tensor_map_3d<T>(&map_v, p.v, dv, p.sk, kv_planes, 2 * dv, 2 * dv * p.sk, 64);
  if (!err)
    err = tensor_map_3d<T>(&map_k2, p.k, d, p.sk, kv_planes, 2 * d, 2 * d * p.sk, S::kDqKeys);
  if (!err)
    err = tensor_map_3d<T>(&map_v2, p.v, dv, p.sk, kv_planes, 2 * dv, 2 * dv * p.sk, S::kDqKeys);
  if (err) return err;

  const size_t rows = static_cast<size_t>(p.n_batch) * p.n_heads * p.sq;
  const size_t per_block = kDotThreads / 8;
  flash_bwd_dot16_kernel<T><<<(rows + per_block - 1) / per_block, kDotThreads, 0, stream>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if (n_plan > 0) {
    if constexpr (S::kPersistent) {
      CUtensorMap map_dk, map_dv;  // the stores: [64][64] boxes, clipped to Sk and the width
      err = tensor_map_3d<T>(&map_dk, p.dk, d, p.sk, kv_planes, 2 * d, 2 * d * p.sk, 64);
      if (!err)
        err = tensor_map_3d<T>(&map_dv, p.dv, dv, p.sk, kv_planes, 2 * dv, 2 * dv * p.sk, 64);
      if (err) return err;
      constexpr size_t smem = PersistSmem<DK, DV>::bytes();
      static_assert(smem <= 232448, "a block's shared memory");
      static bool opted = false;
      err = opt_in(flash_bwd_dkdv_persistent_kernel<T, DK, DV>, smem, opted);
      if (err) return err;
      flash_bwd_dkdv_persistent_kernel<T, DK, DV><<<grid, kWgThreads, smem, stream>>>(
          map_q, map_k, map_v, map_do, map_dk, map_dv, p);
    } else {
      constexpr size_t smem = DkdvSmem<DK, DV>::bytes();
      static bool opted = false;
      err = opt_in(flash_bwd_dkdv_wgmma_kernel<T, DK, DV>, smem, opted);
      if (err) return err;
      flash_bwd_dkdv_wgmma_kernel<T, DK, DV>
          <<<n_plan, kWgThreads, smem, stream>>>(map_q, map_k, map_v, map_do, p);
    }
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  if (n_red > 0) {
    constexpr int kChunks = S::kKeys * (S::kWs / 4) / 256;
    flash_bwd_reduce_kernel<T, DK, DV><<<n_red * kChunks, 256, 0, stream>>>(p);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  if constexpr (S::kPersistent) {
    CUtensorMap map_dq;  // the store: [64][64] boxes, clipped to Sq and D
    err = tensor_map_3d<T>(&map_dq, p.dq, d, p.sq, q_planes, 2 * d, 2 * d * p.sq, kWgRows);
    if (err) return err;
    constexpr size_t smem_q = dq_persistent_smem<DK, DV>();
    static bool q_opted = false;
    err = opt_in(flash_bwd_dq_persistent_kernel<T, DK, DV>, smem_q, q_opted);
    if (err) return err;
    flash_bwd_dq_persistent_kernel<T, DK, DV>
        <<<dq_grid, kWgThreads, smem_q, stream>>>(map_q, map_k2, map_v2, map_do, map_dq, p);
  } else {
    constexpr size_t smem_q = dq_wgmma_smem<DK, DV>();
    static bool q_opted = false;
    err = opt_in(flash_bwd_dq_wgmma_kernel<T, DK, DV>, smem_q, q_opted);
    if (err) return err;
    const int n_qt = (p.sq + 2 * kWgRows - 1) / (2 * kWgRows);
    flash_bwd_dq_wgmma_kernel<T, DK, DV>
        <<<n_qt * p.n_batch * p.n_heads, kWgThreads, smem_q, stream>>>(map_q, map_k2, map_v2,
                                                                       map_do, p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The instantiations: Dv == D padded to 64, 128 or 256; Dv != D on MLA's
// (192, 128), which any D <= 192 with Dv <= 128 takes padded by TMA's zeros.
template <typename T>
int launch_wgmma_dim(const Params& p, int n_plan, int n_red, int grid, int dq_grid,
                     cudaStream_t stream) {
  if (p.dim != p.dim_v)
    return launch_wgmma<T, kSplitD, kSplitDv>(p, n_plan, n_red, grid, dq_grid, stream);
  if (p.dim <= 64) return launch_wgmma<T, 64, 64>(p, n_plan, n_red, grid, dq_grid, stream);
  if (p.dim <= 128) return launch_wgmma<T, 128, 128>(p, n_plan, n_red, grid, dq_grid, stream);
  return launch_wgmma<T, 256, 256>(p, n_plan, n_red, grid, dq_grid, stream);
}

}  // namespace

// The wgmma backward: q, k, v, o, dout, dq, dk and dv share the dtype (1 =
// bfloat16, 2 = float16); q, k, dq and dk are dim wide, v, o, dout and dv
// dim_v wide (each a multiple of 8, every pointer 16-byte aligned; Dv == D
// up to 256, or D up to 192 with Dv up to 128); lse is the forward's float32 [B, H, Sq]
// output and scratch a float32 [2, B, H, Sq] buffer (Di, then lse in the
// log2 domain). The wrapper's plan: n_plan rows of the key-tile pass's
// units, n_red rows of its split key tiles, a float32 workspace ws of
// 2 * n_slots [kKeys][kWs] tiles (kWs = the instantiation's DK: dim padded
// to 64, 128 or 256, or 192 for Dv != D), and
// dq_span, the query-tile pass's key tiles for each of its query tiles; at
// Dv != D (the persistent passes) also starts, the key-tile pass's grid
// blocks' row ranges (grid of them), and dq_units / dq_starts, the
// query-tile pass's units in block order and its dq_grid blocks' ranges
// (null and 0 at the other widths, whose passes launch a block a unit).
// Launches the prologue, the key-tile pass, the reduction and the
// query-tile pass on stream, in that order. Returns cudaGetLastError()
// after the first launch that fails (0 on success), 1000 + libcuda's
// error when a tensor map cannot be encoded, or -1 for a dtype or width it
// has no instantiation for.
extern "C" int acs_flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* scratch, void* dq, void* dk, void* dv, int n_batch, int n_heads,
    int n_kv_heads, int sq, int sk, int dim, int dim_v, int dtype, float scale, int causal,
    int has_window,
    int window, int has_softcap, float softcap, int q_offset, int prefix_len, const int* plan,
    int n_plan, const int* red, int n_red, float* ws, int n_slots, const int* dq_span,
    const int* starts, int grid, const int* dq_units, const int* dq_starts, int dq_grid,
    void* stream) {
  const bool widths = dim == dim_v ? dim <= kMaxD : dim <= kSplitD && dim_v <= kSplitDv;
  if (dim < 8 || dim_v < 8 || dim % 8 != 0 || dim_v % 8 != 0 || !widths ||
      (dtype != 1 && dtype != 2))
    return -1;
  if (dim != dim_v && (starts == nullptr || dq_units == nullptr || dq_starts == nullptr ||
                       grid < 1 || dq_grid < 1))
    return -1;
  Params p{q, k, v, o, dout, lse, scratch, dq, dk, dv, n_batch, n_heads, n_kv_heads, sq, sk,
           dim, dim_v, 0, 0, scale, causal, has_window, window, has_softcap, softcap, q_offset,
           prefix_len, plan, red, ws, n_slots,
           scratch + static_cast<size_t>(n_batch) * n_heads * sq, dq_span, starts, dq_units,
           dq_starts};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_wgmma_dim<__nv_bfloat16>(p, n_plan, n_red, grid, dq_grid, s)
                    : launch_wgmma_dim<__half>(p, n_plan, n_red, grid, dq_grid, s);
}
