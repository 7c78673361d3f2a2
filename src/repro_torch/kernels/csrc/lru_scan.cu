// Diagonal linear recurrence h_t = a_t * h_{t-1} + b_t on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/lru_scan.py, lru_scan -> _lru_kernel (the
// Pallas scan whose sequence grid axis carries h in VMEM scratch, with S
// padded to the chunk by a = 1, b = 0).
//
// Bound on this card: bytes. Each call reads a and b once ([B, S, D]),
// reads h0 ([B, D]) and writes h ([B, S, D]): (3*B*S*D + B*D) * elem bytes
// over 3.35 TB/s (recurrentgemma's prefill [1, 512, 2560] f32: 15.7 MB,
// 0.0047 ms). It does two float operations per element, far below the
// byte line.
//
// The recurrence is serial in t for each channel, and it stays serial
// here: each step is __fadd_rn(__fmul_rn(a, h), b), a multiply then an
// add, each rounded, never contracted into a fused multiply-add (the file
// is built with -fmad=false), in time order. The plain version
// (kernels/ref.py lru_scan_ref: h = a[:, t] * h + b[:, t], two eager
// kernels) rounds the same way, so the two are bit-equal. A chunked
// parallel scan would re-associate the carry and lose that.
//
// Time-tiled design (the first design, one thread per channel loading
// straight from device memory, filled 20 of 132 SMs at B = 1, D = 2560 and
// paid a memory latency per step):
// * A block owns one batch row and a tile of C channels: C = 32 (a 128-byte
//   float32 row segment) when that gives at least two blocks per SM, else
//   C = 16 (recurrentgemma at B = 1, D = 2560: 160 blocks, not 20).
// * a and b stream through a 3-stage ring of [T, C] time tiles in shared
//   memory (T * C = 1024 elements: T = 32 or 64 steps), filled by 16-byte
//   cp.async copies (csrc/sm90_tiles.cuh stage), so the loads of tiles
//   k + 1 and k + 2 are in flight while tile k is scanned. Rows that are
//   not 16-byte multiples (D * elem % 16 != 0, or an unaligned pointer)
//   stage with element loads.
// * The C scanning threads read their channel's steps from shared memory:
//   the only serial chain left is the multiply and the add. Each h
//   overwrites its b in the tile, and the whole block then stores the tile
//   with 16-byte writes.
// * Any B, S, D with no padding copy: the last time tile and the last
//   channel tile are masked.
//
// Measured on an H100 80GB HBM3 at 700 W (kernels/scan_epoch_times.py,
// the first design and this one in one call, device time from
// torch.profiler): recurrentgemma's prefill [1, 512, 2560] f32 takes
// 0.0105 ms (the first design 0.0296), 2.2x its byte bound; a decode
// launch [1, 1, 2560] takes 0.0017 ms (0.0012), and there the wrapper's
// host path, 15-30 us a call, sets the time. 59 registers (48 for
// bfloat16), 24 KB (12 KB) of static shared memory, no spills.
//
// The reverse scan (acs_lru_scan_bwd), the recurrence's backward, replaces
// no Pallas kernel: the reference trains through XLA's derivative of its
// oracle (src/repro/kernels/ref.py lru_scan_ref). With the carry
// g_{S-1} = dh_{S-1}, g_t = dh_t + a_{t+1} * g_{t+1} it writes db_t = g_t,
// da_t = g_t * h_{t-1} (h_{-1} = h0) and dh0 = a_0 * g_0, each step one
// rounded multiply and one rounded add in reverse time order, as
// kernels/ref.py lru_scan_bwd_ref does: bit-equal to it on the card.
// * The forward's time-tiled design run backwards: the same blocks of one
//   batch row and C channels, a 3-stage ring of [T, C] tiles of a, the
//   saved output h and dh, filled from the last tile to the first. a_{t+1}
//   is carried in a register from the step before (in reverse order), so
//   a needs no shifted copy; h_{t-1} is the tile's previous row, and at a
//   tile's first step one load from device memory (h0 at t = 0). db
//   overwrites dh's tile and da h's (h_t is read at step t + 1, which ran
//   before step t), then 16-byte stores.
// * Bound: bytes, reading a, h and dh once and writing da and db, plus h0
//   and dh0: recurrentgemma-2b's training shape [4, 512, 2560] f32 moves
//   5 x 21.0 MB, 0.031 ms at 3.35 TB/s.

#include "sm90_tiles.cuh"

#include <cstddef>

namespace {

using namespace sm90;

constexpr int kThreads = 128;
constexpr int kTileElems = 1024;  // T * C elements of a (and of b) per stage
constexpr int kStages = 3;
constexpr int kMaxDevices = 64;

// src [R, C] from shared memory to dst rows r < r_lim, columns c < c_lim
// (row stride ld_dst): 16-byte writes when vec (as in stage), else element
// writes.
template <typename T, int R, int C>
__device__ __forceinline__ void unstage(T* dst, size_t ld_dst, const T* src, int r_lim,
                                        int c_lim, bool vec) {
  if (vec) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
    constexpr int CH = C / kPer;
    for (int i = threadIdx.x; i < R * CH; i += kThreads) {
      const int r = i / CH;
      const int c = (i - r * CH) * kPer;
      if (r < r_lim && c < c_lim) {
        *reinterpret_cast<int4*>(dst + r * ld_dst + c) =
            *reinterpret_cast<const int4*>(src + r * C + c);
      }
    }
  } else {
    for (int i = threadIdx.x; i < R * C; i += kThreads) {
      const int r = i / C;
      const int c = i - r * C;
      if (r < r_lim && c < c_lim) dst[r * ld_dst + c] = src[r * C + c];
    }
  }
}

template <typename T, typename H, int C>
__global__ void __launch_bounds__(kThreads)
lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b, const H* __restrict__ h0,
                T* __restrict__ out, int seq, int dim, int vec) {
  constexpr int TT = kTileElems / C;  // time steps per tile
  // The ring: a's stages, then b's ([kStages][kTileElems] each).
  __shared__ __align__(16) unsigned char smem_raw[2 * kStages * kTileElems * sizeof(T)];
  T* sa = reinterpret_cast<T*>(smem_raw);
  T* sb = sa + kStages * kTileElems;

  const int tiles_c = (dim + C - 1) / C;
  const int bi = blockIdx.x / tiles_c;
  const int c0 = (blockIdx.x - bi * tiles_c) * C;
  const int c_lim = min(C, dim - c0);
  const size_t base = static_cast<size_t>(bi) * seq * dim + c0;
  const T* ga = a + base;
  const T* gb = b + base;
  T* go = out + base;
  const int nt = (seq + TT - 1) / TT;

  auto load = [&](int k) {
    const size_t t0 = static_cast<size_t>(k) * TT;
    const int r_lim = seq - k * TT;
    T* ta = sa + (k % kStages) * kTileElems;
    T* tb = sb + (k % kStages) * kTileElems;
    stage<T, TT, C, C, kThreads>(ta, ga + t0 * dim, dim, r_lim, c_lim, vec);
    stage<T, TT, C, C, kThreads>(tb, gb + t0 * dim, dim, r_lim, c_lim, vec);
  };

  // Ring: tiles 0 .. kStages-2 in flight before the loop; iteration k
  // waits for tile k, refills the stage tile k-1 used, scans, stores.
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < nt) load(k);
    cp_async_commit();
  }
  const int c = threadIdx.x;
  const bool scans = c < c_lim;
  float h = scans ? to_f<H>(h0[static_cast<size_t>(bi) * dim + c0 + c]) : 0.0f;
  for (int k = 0; k < nt; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile k is in shared memory; tile k-1's store is done
    if (k + kStages - 1 < nt) load(k + kStages - 1);
    cp_async_commit();
    const int rows = min(TT, seq - k * TT);
    const T* ta = sa + (k % kStages) * kTileElems;
    T* tb = sb + (k % kStages) * kTileElems;
    if (scans) {
#pragma unroll 8
      for (int t = 0; t < rows; ++t) {
        h = __fadd_rn(__fmul_rn(to_f<T>(ta[t * C + c]), h), to_f<T>(tb[t * C + c]));
        tb[t * C + c] = from_f<T>(h);
      }
    }
    __syncthreads();  // the tile's h is complete
    unstage<T, TT, C>(go + static_cast<size_t>(k) * TT * dim, dim, tb, rows, c_lim, vec);
  }
}

// The reverse scan (see the header): block and ring as lru_scan_kernel,
// tiles visited from the last to the first. dh0 may be null.
template <typename T, typename H, int C>
__global__ void __launch_bounds__(kThreads)
lru_scan_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h, const H* __restrict__ h0,
                    const T* __restrict__ dh, T* __restrict__ da, T* __restrict__ db,
                    H* __restrict__ dh0, int seq, int dim, int vec) {
  constexpr int TT = kTileElems / C;
  // The ring: a's stages, then h's, then dh's ([kStages][kTileElems] each).
  __shared__ __align__(16) unsigned char smem_raw[3 * kStages * kTileElems * sizeof(T)];
  T* sa = reinterpret_cast<T*>(smem_raw);
  T* sh = sa + kStages * kTileElems;
  T* sd = sh + kStages * kTileElems;

  const int tiles_c = (dim + C - 1) / C;
  const int bi = blockIdx.x / tiles_c;
  const int c0 = (blockIdx.x - bi * tiles_c) * C;
  const int c_lim = min(C, dim - c0);
  const size_t base = static_cast<size_t>(bi) * seq * dim + c0;
  const int nt = (seq + TT - 1) / TT;

  // Iteration j works on time tile nt - 1 - j.
  auto load = [&](int j) {
    const int k = nt - 1 - j;
    const size_t off = base + static_cast<size_t>(k) * TT * dim;
    const int r_lim = seq - k * TT;
    const int slot = (j % kStages) * kTileElems;
    stage<T, TT, C, C, kThreads>(sa + slot, a + off, dim, r_lim, c_lim, vec);
    stage<T, TT, C, C, kThreads>(sh + slot, h + off, dim, r_lim, c_lim, vec);
    stage<T, TT, C, C, kThreads>(sd + slot, dh + off, dim, r_lim, c_lim, vec);
  };

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < nt) load(j);
    cp_async_commit();
  }
  const int c = threadIdx.x;
  const bool scans = c < c_lim;
  float g = 0.0f;       // the carry g_{t+1}
  float a_next = 0.0f;  // a_{t+1}
  for (int j = 0; j < nt; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile j is in shared memory; tile j-1's stores are done
    if (j + kStages - 1 < nt) load(j + kStages - 1);
    cp_async_commit();
    const int k = nt - 1 - j;
    const int t0 = k * TT;
    const int rows = min(TT, seq - t0);
    const int slot = (j % kStages) * kTileElems;
    const T* ta = sa + slot;
    T* th = sh + slot;
    T* td = sd + slot;
    if (scans) {
      const float h_before =
          k > 0 ? to_f<T>(h[base + static_cast<size_t>(t0 - 1) * dim + c])
                : to_f<H>(h0[static_cast<size_t>(bi) * dim + c0 + c]);
#pragma unroll 8
      for (int t = rows - 1; t >= 0; --t) {
        const float dht = to_f<T>(td[t * C + c]);
        g = t0 + t == seq - 1 ? dht : __fadd_rn(dht, __fmul_rn(a_next, g));
        const float hp = t > 0 ? to_f<T>(th[(t - 1) * C + c]) : h_before;
        a_next = to_f<T>(ta[t * C + c]);
        td[t * C + c] = from_f<T>(g);                   // db_t
        th[t * C + c] = from_f<T>(__fmul_rn(g, hp));    // da_t
      }
    }
    __syncthreads();  // the tile's da and db are complete
    const size_t off = static_cast<size_t>(t0) * dim;
    unstage<T, TT, C>(db + base + off, dim, td, rows, c_lim, vec);
    unstage<T, TT, C>(da + base + off, dim, th, rows, c_lim, vec);
  }
  if (scans && dh0 != nullptr)
    dh0[static_cast<size_t>(bi) * dim + c0 + c] = from_f<H>(__fmul_rn(a_next, g));
}

int sm_count() {
  static int cache[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 132;
  if (cache[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
      return 132;
    cache[dev] = n;
  }
  return cache[dev];
}

template <typename T, typename H>
int launch(const void* a, const void* b, const void* h0, void* out, int n_batch, int seq,
           int dim, cudaStream_t stream) {
  const bool vec = (static_cast<size_t>(dim) * sizeof(T)) % 16 == 0 && aligned16(a) &&
                   aligned16(b) && aligned16(out);
  const int tiles32 = n_batch * ((dim + 31) / 32);
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  const H* ph = static_cast<const H*>(h0);
  T* po = static_cast<T*>(out);
  if (tiles32 >= 2 * sm_count()) {
    lru_scan_kernel<T, H, 32><<<tiles32, kThreads, 0, stream>>>(pa, pb, ph, po, seq, dim, vec);
  } else {
    const int tiles16 = n_batch * ((dim + 15) / 16);
    lru_scan_kernel<T, H, 16><<<tiles16, kThreads, 0, stream>>>(pa, pb, ph, po, seq, dim, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename H>
int launch_bwd(const void* a, const void* h, const void* h0, const void* dh, void* da, void* db,
               void* dh0, int n_batch, int seq, int dim, cudaStream_t stream) {
  const bool vec = (static_cast<size_t>(dim) * sizeof(T)) % 16 == 0 && aligned16(a) &&
                   aligned16(h) && aligned16(dh) && aligned16(da) && aligned16(db);
  const int tiles32 = n_batch * ((dim + 31) / 32);
  const T* pa = static_cast<const T*>(a);
  const T* ph = static_cast<const T*>(h);
  const H* ph0 = static_cast<const H*>(h0);
  const T* pdh = static_cast<const T*>(dh);
  T* pda = static_cast<T*>(da);
  T* pdb = static_cast<T*>(db);
  H* pdh0 = static_cast<H*>(dh0);
  if (tiles32 >= 2 * sm_count()) {
    lru_scan_bwd_kernel<T, H, 32><<<tiles32, kThreads, 0, stream>>>(pa, ph, ph0, pdh, pda, pdb,
                                                                     pdh0, seq, dim, vec);
  } else {
    const int tiles16 = n_batch * ((dim + 15) / 16);
    lru_scan_bwd_kernel<T, H, 16><<<tiles16, kThreads, 0, stream>>>(pa, ph, ph0, pdh, pda, pdb,
                                                                     pdh0, seq, dim, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype / h0_dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError()
// after the launch (0 on success), or -1 for a dtype code it does not take.
extern "C" int acs_lru_scan(const void* a, const void* b, const void* h0, void* out,
                            int n_batch, int seq, int dim, int dtype, int h0_dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && h0_dtype == 0) return launch<float, float>(a, b, h0, out, n_batch, seq, dim, s);
  if (dtype == 1 && h0_dtype == 0)
    return launch<__nv_bfloat16, float>(a, b, h0, out, n_batch, seq, dim, s);
  if (dtype == 1 && h0_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(a, b, h0, out, n_batch, seq, dim, s);
  if (dtype == 0 && h0_dtype == 1)
    return launch<float, __nv_bfloat16>(a, b, h0, out, n_batch, seq, dim, s);
  return -1;
}

// The reverse scan: da, db ([B, S, D] in dtype) and dh0 ([B, D] in
// h0_dtype, or null for none) from a, the forward's output h and dh (in
// dtype) and h0. Codes and return value as acs_lru_scan.
extern "C" int acs_lru_scan_bwd(const void* a, const void* h, const void* h0, const void* dh,
                                void* da, void* db, void* dh0, int n_batch, int seq, int dim,
                                int dtype, int h0_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && h0_dtype == 0)
    return launch_bwd<float, float>(a, h, h0, dh, da, db, dh0, n_batch, seq, dim, s);
  if (dtype == 1 && h0_dtype == 0)
    return launch_bwd<__nv_bfloat16, float>(a, h, h0, dh, da, db, dh0, n_batch, seq, dim, s);
  if (dtype == 1 && h0_dtype == 1)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(a, h, h0, dh, da, db, dh0, n_batch, seq,
                                                    dim, s);
  if (dtype == 0 && h0_dtype == 1)
    return launch_bwd<float, __nv_bfloat16>(a, h, h0, dh, da, db, dh0, n_batch, seq, dim, s);
  return -1;
}
