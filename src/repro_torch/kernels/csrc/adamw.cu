// The optimizer's global-norm clip and AdamW update as multi-tensor passes
// over every leaf of a model, on Hopper (sm_90a).
//
// Replaces: no TPU kernel. The reference's optimizer (src/repro/optim/
// adamw.py, clip_by_global_norm and adamw_update) is plain jnp, which XLA
// fuses. The port ran it as eager PyTorch, leaf by leaf: a float32 copy of
// every gradient for the clip and ~15 kernels a leaf for the update, each
// streaming the leaf through device memory again.
//
// Bound on this card: bytes. A bf16 parameter costs 30 bytes a step: the
// gradient read twice (once for the norm, once for the update), the
// float32 master, m and v read and written once, the parameter written
// once (acsbench/counts/adamw.py). At 3.35 TB/s that is 29.5 ms for
// granite-moe-3b-a800m's 3.30 B parameters. Its ~20 float operations an
// element are far below the byte line.
//
// Design:
// * Two entry points, each a persistent grid (a few 256-thread blocks on
//   every SM) over one table of leaves that the wrapper builds on the host
//   and copies to the card asynchronously (pinned memory): pointers, the
//   element count, the dtypes, the first 16-byte-aligned element and the
//   leaf's first chunk. Each leaf is cut into chunks of kChunk elements,
//   and each block walks a contiguous run of the chunk list, so a launch
//   takes any number of leaves and the number of launches a step does not
//   depend on it.
// * Every element of a leaf is read once and written once a pass: 16-byte
//   loads of the float32 state (and of 16-bit gradients in the norm), 8-byte
//   loads and stores of a 16-bit leaf in the update, four vectors in flight
//   a thread. A leaf whose pointers do not share one 16-byte phase, and the
//   unaligned head and tail of a chunk, go element by element.
// * The norm (acs_adamw_norm): each block sums the float32 squares of its
//   chunks in double and writes its sum to its own slot; a second, one-block
//   launch adds the slots in a fixed order and writes gnorm and the clip's
//   scale, min(1, max_norm / (gnorm + 1e-9)), as PyTorch computes it
//   (a reciprocal, then a multiply). No atomics: the same bits every run on
//   one card. No host read.
// * The update (acs_adamw_update) runs the reference's formula in float32
//   in the order the port's per-leaf path rounds it (kernels/adamw.py
//   adamw_step_ref): g = float(g) * scale; m = m*b1 + (1-b1)*g;
//   v = v*b2 + ((1-b2)*g)*g; master -= lr * ((m/c1) / (sqrt(v/c2) + eps) +
//   wd*master); p = round(master). Built with -fmad=false and IEEE division
//   and square root, each operation rounds once, as PyTorch's eager kernels
//   do, so the two are bit-equal at the same scale. c1, c2 (and lr, when it
//   is a tensor) are read from device memory: nothing waits on the host.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 32768;  // elements a chunk (a multiple of every vector width)
constexpr int kUnroll = 4;           // vectors in flight a thread
constexpr int kMaxDevices = 64;

enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

// One leaf of the table (the wrapper's _LEAF_FIELDS, 8 int64 each).
struct Leaf {
  long long p, g, master, m, v;  // device pointers (0 where a pass does not use one)
  long long numel;
  long long meta;         // p dtype | g dtype << 8 | (head + 1) << 16; head -1: no aligned run
  long long chunk_begin;  // the leaf's first chunk in the launch's chunk list
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// Four elements of T as one load or store (16 bytes of float, 8 of a 16-bit type).
template <typename T> struct alignas(4 * sizeof(T)) AlignedVec4 { T x[4]; };

template <typename T>
__device__ __forceinline__ void load4(const T* p, float out[4]) {
  AlignedVec4<T> v = *reinterpret_cast<const AlignedVec4<T>*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = to_f32(v.x[k]);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float in[4]) {
  AlignedVec4<T> v;
#pragma unroll
  for (int k = 0; k < 4; ++k) v.x[k] = from_f32<T>(in[k]);
  *reinterpret_cast<AlignedVec4<T>*>(p) = v;
}

// The chunk run [c0, c1) of this block (an even split of the chunk list).
__device__ __forceinline__ void block_chunks(long long n_chunks, long long* c0, long long* c1) {
  *c0 = n_chunks * blockIdx.x / gridDim.x;
  *c1 = n_chunks * (blockIdx.x + 1) / gridDim.x;
}

// The leaf that holds chunk c: the last leaf whose chunk_begin <= c.
__device__ __forceinline__ int leaf_of(const Leaf* leaves, int n_leaves, long long c) {
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) / 2;
    if (leaves[mid].chunk_begin <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Elements [lo, hi) of a leaf split into a scalar head [lo, a), whole
// vectors of `width` elements [a, vend) and a scalar tail [vend, hi).
struct Span {
  long long lo, a, vend, hi;
};

__device__ __forceinline__ Span chunk_span(const Leaf& leaf, long long c, int width) {
  Span s;
  s.lo = (c - leaf.chunk_begin) * kChunk;
  s.hi = min(s.lo + kChunk, leaf.numel);
  long long head = ((leaf.meta >> 16) & 0xffff) - 1;
  if (head < 0) {  // no run of whole aligned vectors: all element by element
    s.a = s.vend = s.lo;
  } else {
    s.a = min(s.lo + head, s.hi);
    s.vend = s.a + (s.hi - s.a) / width * width;
  }
  return s;
}

// ---------------------------------------------------------------------------
// The global norm
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ double chunk_sq(const T* g, const Span& s) {
  constexpr int W = 16 / sizeof(T);  // elements a 16-byte load
  struct alignas(16) V { T x[W]; };
  double acc = 0.0;
  for (long long i = s.lo + threadIdx.x; i < s.a; i += kThreads) {
    float x = to_f32(g[i]);
    acc += (double)(x * x);
  }
  for (long long i = s.vend + threadIdx.x; i < s.hi; i += kThreads) {
    float x = to_f32(g[i]);
    acc += (double)(x * x);
  }
  const long long nvec = (s.vend - s.a) / W;
  const V* gv = reinterpret_cast<const V*>(g + s.a);
  for (long long j0 = threadIdx.x; j0 < nvec; j0 += (long long)kThreads * kUnroll) {
    V buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      long long j = j0 + (long long)u * kThreads;
      if (j < nvec) buf[u] = gv[j];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      long long j = j0 + (long long)u * kThreads;
      if (j < nvec) {
#pragma unroll
        for (int k = 0; k < W; ++k) {
          float x = to_f32(buf[u].x[k]);
          acc += (double)(x * x);
        }
      }
    }
  }
  return acc;
}

// The block's sum of `x` over its threads, in a fixed order; valid in thread 0.
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
  }
  return total;
}

__global__ void __launch_bounds__(kThreads) norm_partials_kernel(
    const Leaf* __restrict__ leaves, int n_leaves, long long n_chunks,
    double* __restrict__ partial) {
  long long c0, c1;
  block_chunks(n_chunks, &c0, &c1);
  double acc = 0.0;
  if (c0 < c1) {
    int l = leaf_of(leaves, n_leaves, c0);
    for (long long c = c0; c < c1; ++c) {
      while (l + 1 < n_leaves && leaves[l + 1].chunk_begin <= c) ++l;
      const Leaf leaf = leaves[l];
      const int dt = (int)((leaf.meta >> 8) & 0xff);
      if (dt == kF32) {
        acc += chunk_sq(reinterpret_cast<const float*>(leaf.g), chunk_span(leaf, c, 4));
      } else if (dt == kBF16) {
        acc += chunk_sq(reinterpret_cast<const __nv_bfloat16*>(leaf.g), chunk_span(leaf, c, 8));
      } else {
        acc += chunk_sq(reinterpret_cast<const __half*>(leaf.g), chunk_span(leaf, c, 8));
      }
    }
  }
  double total = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

// out[0] = gnorm, out[1] = the clip's scale, from the blocks' slots.
__global__ void __launch_bounds__(kThreads) norm_finish_kernel(
    const double* __restrict__ partial, int n_partial, float max_norm, float* __restrict__ out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n_partial; i += kThreads) acc += partial[i];
  double sq = block_sum(acc);
  if (threadIdx.x == 0) {
    float gnorm = sqrtf((float)sq);
    float x = (1.0f / (gnorm + 1e-9f)) * max_norm;  // PyTorch's max_norm / t: reciprocal, multiply
    out[0] = gnorm;
    out[1] = isnan(x) ? x : fminf(x, 1.0f);          // clamp(max=1), NaN kept
  }
}

// ---------------------------------------------------------------------------
// The update
// ---------------------------------------------------------------------------

struct Hyper {
  float scale, c1, c2, lr, b1, omb1, b2, omb2, eps, wd;
};

__device__ __forceinline__ float adamw_one(float g, float& master, float& m, float& v,
                                           const Hyper& h) {
  g = g * h.scale;
  m = m * h.b1 + h.omb1 * g;
  v = v * h.b2 + (h.omb2 * g) * g;
  float update = (m / h.c1) / (sqrtf(v / h.c2) + h.eps) + h.wd * master;
  master = master - h.lr * update;
  return master;
}

template <typename P, typename G>
__device__ __forceinline__ void chunk_update(const Leaf& leaf, const Span& s, const Hyper& h) {
  P* __restrict__ p = reinterpret_cast<P*>(leaf.p);
  const G* __restrict__ g = reinterpret_cast<const G*>(leaf.g);
  float* __restrict__ w = reinterpret_cast<float*>(leaf.master);
  float* __restrict__ m = reinterpret_cast<float*>(leaf.m);
  float* __restrict__ v = reinterpret_cast<float*>(leaf.v);
  for (int part = 0; part < 2; ++part) {  // the scalar head, then the scalar tail
    const long long from = part == 0 ? s.lo : s.vend, to = part == 0 ? s.a : s.hi;
    for (long long i = from + threadIdx.x; i < to; i += kThreads) {
      float wi = w[i], mi = m[i], vi = v[i];
      p[i] = from_f32<P>(adamw_one(to_f32(g[i]), wi, mi, vi, h));
      w[i] = wi;
      m[i] = mi;
      v[i] = vi;
    }
  }
  const long long nvec = (s.vend - s.a) / 4;
  for (long long j0 = threadIdx.x; j0 < nvec; j0 += (long long)kThreads * kUnroll) {
    float gb[kUnroll][4], wb[kUnroll][4], mb[kUnroll][4], vb[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = j0 + (long long)u * kThreads;
      if (j < nvec) {
        const long long i = s.a + 4 * j;
        load4(g + i, gb[u]);
        load4(w + i, wb[u]);
        load4(m + i, mb[u]);
        load4(v + i, vb[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = j0 + (long long)u * kThreads;
      if (j < nvec) {
        const long long i = s.a + 4 * j;
        float out[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) out[k] = adamw_one(gb[u][k], wb[u][k], mb[u][k], vb[u][k], h);
        store4(w + i, wb[u]);
        store4(m + i, mb[u]);
        store4(v + i, vb[u]);
        store4(p + i, out);
      }
    }
  }
}

template <typename P>
__device__ __forceinline__ void chunk_update_g(const Leaf& leaf, int g_dt, const Span& s,
                                               const Hyper& h) {
  if (g_dt == kF32) chunk_update<P, float>(leaf, s, h);
  else if (g_dt == kBF16) chunk_update<P, __nv_bfloat16>(leaf, s, h);
  else chunk_update<P, __half>(leaf, s, h);
}

__global__ void __launch_bounds__(kThreads) adamw_update_kernel(
    const Leaf* __restrict__ leaves, int n_leaves, long long n_chunks,
    const float* __restrict__ scale, const float* __restrict__ c1, const float* __restrict__ c2,
    const float* __restrict__ lr_ptr, float lr, float b1, float omb1, float b2, float omb2,
    float eps, float wd) {
  long long c0, c1_;
  block_chunks(n_chunks, &c0, &c1_);
  if (c0 >= c1_) return;
  Hyper h;
  h.scale = scale != nullptr ? *scale : 1.0f;
  h.c1 = *c1;
  h.c2 = *c2;
  h.lr = lr_ptr != nullptr ? *lr_ptr : lr;
  h.b1 = b1;
  h.omb1 = omb1;
  h.b2 = b2;
  h.omb2 = omb2;
  h.eps = eps;
  h.wd = wd;
  int l = leaf_of(leaves, n_leaves, c0);
  for (long long c = c0; c < c1_; ++c) {
    while (l + 1 < n_leaves && leaves[l + 1].chunk_begin <= c) ++l;
    const Leaf leaf = leaves[l];
    const int p_dt = (int)(leaf.meta & 0xff), g_dt = (int)((leaf.meta >> 8) & 0xff);
    const Span s = chunk_span(leaf, c, 4);
    if (p_dt == kF32) chunk_update_g<float>(leaf, g_dt, s, h);
    else if (p_dt == kBF16) chunk_update_g<__nv_bfloat16>(leaf, g_dt, s, h);
    else chunk_update_g<__half>(leaf, g_dt, s, h);
  }
}

template <typename K>
int grid_for(K kernel) {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev < 0 || dev >= kMaxDevices) return -1;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return -(int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return -(int)err;
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cached[dev];
}

}  // namespace

// The number of blocks (and partial slots) of the norm's first launch on
// the current device; negative on a CUDA error.
extern "C" int acs_adamw_norm_blocks() { return grid_for(norm_partials_kernel); }

// The global norm of the gradients in `leaves` (n_leaves device Leaf rows,
// n_chunks chunks in all): out[0] = gnorm, out[1] = the clip's scale
// (float32). `partial` holds acs_adamw_norm_blocks() doubles of scratch.
// Two launches on `stream`; returns the CUDA error code (0 on success).
extern "C" int acs_adamw_norm(const void* leaves, int n_leaves, long long n_chunks,
                              void* partial, float max_norm, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int blocks = grid_for(norm_partials_kernel);
  if (blocks <= 0) return blocks < 0 ? -blocks : -1;
  norm_partials_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const Leaf*>(leaves), n_leaves,
                                                   n_chunks, static_cast<double*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  norm_finish_kernel<<<1, kThreads, 0, s>>>(static_cast<const double*>(partial), blocks, max_norm,
                                            static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// One AdamW step over `leaves` in place (p, master, m, v), from the
// gradients g times *scale (scale null: 1). c1, c2: device float32 scalars
// 1 - b1^t, 1 - b2^t; lr from lr_ptr (a device float32 scalar) or, where it
// is null, the value lr. One launch on `stream`; returns the CUDA error code.
extern "C" int acs_adamw_update(const void* leaves, int n_leaves, long long n_chunks,
                                const void* scale, const void* c1, const void* c2,
                                const void* lr_ptr, float lr, float b1, float omb1, float b2,
                                float omb2, float eps, float wd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int blocks = grid_for(adamw_update_kernel);
  if (blocks <= 0) return blocks < 0 ? -blocks : -1;
  adamw_update_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const Leaf*>(leaves), n_leaves, n_chunks, static_cast<const float*>(scale),
      static_cast<const float*>(c1), static_cast<const float*>(c2),
      static_cast<const float*>(lr_ptr), lr, b1, omb1, b2, omb2, eps, wd);
  return (int)cudaGetLastError();
}
