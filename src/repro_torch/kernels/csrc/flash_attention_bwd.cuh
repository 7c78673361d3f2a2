// What both of flash attention's backward libraries share
// (flash_attention_bwd.cu, the float32 kernels;
// flash_attention_bwd_wgmma.cu, the wgmma kernels): the kernels' parameters
// and the forward's masks, in the log2 domain the kernels exponentiate in.

#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace flash_bwd {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;     // [B, H, Sq, D]
  const void* k;     // [B, Hkv, Sk, D]
  const void* v;     // [B, Hkv, Sk, Dv]
  const void* o;     // [B, H, Sq, Dv]
  const void* dout;  // [B, H, Sq, Dv]
  const float* lse;  // [B, H, Sq]
  float* di;         // [B, H, Sq] scratch: rowsum(dO * O)
  void* dq;          // [B, H, Sq, D]
  void* dk;          // [B, Hkv, Sk, D]
  void* dv;          // [B, Hkv, Sk, Dv]
  int n_batch, n_heads, n_kv_heads, sq, sk, dim, dim_v;  // dim: q's and k's width; dim_v: v's
  int stride;    // f32 kernels: shared-memory row stride of the streamed q / k tiles
  int stride_v;  // f32 kernels: the same for the streamed dO / v tiles
  float scale;
  int causal;
  int has_window, window;
  int has_softcap;
  float softcap;
  int q_offset, prefix_len;
  // The wgmma path (the wrapper's plan): the key-tile pass's blocks, its
  // split key tiles' slot ranges, and their float32 partial sums.
  const int* plan;  // [n_blocks][8]: kt, b * Hkv + hk, qt_begin, n_q, it_lo, it_hi, slot, 0
  const int* red;   // [n_red][4]: kt, b * Hkv + hk, slot_lo, slot_hi
  float* ws;        // [2][n_slots][kKeys][DP]: dK's, then dV's partial sums
  int n_slots;
  float* lse2;      // [B, H, Sq] scratch: lse in the log2 domain, +inf for a row that sees no key
  // The query-tile pass's key tiles for each query tile: 0 .. prefix_tiles
  // - 1, then max(prefix_tiles, window_tile) .. end - 1.
  const int* dq_span;  // [n_qt][3]: prefix_tiles, window_tile, end
  // The persistent passes (MLA's widths): block b of the key-tile pass runs
  // plan rows starts[b] .. starts[b + 1] - 1; block b of the query-tile
  // pass runs the units dq_units[dq_starts[b] .. dq_starts[b + 1] - 1], each
  // the index of a block of the one-block-a-unit grid (dq_blocks). Null
  // for the other widths, whose passes launch one block a unit.
  const int* starts;     // [grid + 1]
  const int* dq_units;   // [dq_blocks]
  const int* dq_starts;  // [dq_grid + 1]
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

constexpr int kDotThreads = 256;  // the Di prologue's block

}  // namespace flash_bwd
