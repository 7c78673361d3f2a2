// Diagonal linear recurrence h_t = a_t * h_{t-1} + b_t on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/lru_scan.py, lru_scan -> _lru_kernel (the
// Pallas scan whose sequence grid axis carries h in VMEM scratch, with S
// padded to the chunk by a = 1, b = 0).
//
// Bound on this card: bytes. Each call reads a and b once ([B, S, D]),
// reads h0 ([B, D]) and writes h ([B, S, D]): (3*B*S*D + B*D) * elem bytes
// over 3.35 TB/s. It does two float operations per element, far below the
// byte line.
//
// This first design: one thread per (batch, channel), neighbouring threads
// on neighbouring channels, so every load of a[b, t, :] and b[b, t, :] and
// every store of h[b, t, :] is coalesced. Each thread loops over t in order
// with the carry in a float32 register; any S >= 1 runs with no padding
// copy. The step is __fadd_rn(__fmul_rn(a, h), b): a multiply then an add,
// each rounded, never contracted into a fused multiply-add (the file is
// also built with -fmad=false). The plain version (kernels/ref.py
// lru_scan_ref: h = a[:, t] * h + b[:, t], two eager kernels) rounds the
// same way, so the two are bit-equal. B*D threads over B*D/128 blocks:
// at B = 1, D = 2560 that is 20 blocks, and the recurrence's latency, not
// the bytes, sets the time; splitting S across blocks with a second pass
// is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, typename H>
__global__ void __launch_bounds__(kThreads)
lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                const H* __restrict__ h0, T* __restrict__ out, int n_batch,
                int seq, int dim) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;  // over B*D
  if (idx >= n_batch * dim) return;
  const int bi = idx / dim;
  const int d = idx - bi * dim;
  size_t off = static_cast<size_t>(bi) * seq * dim + d;
  float h = to_f<H>(h0[idx]);
#pragma unroll 4
  for (int t = 0; t < seq; ++t, off += dim) {
    h = __fadd_rn(__fmul_rn(to_f<T>(a[off]), h), to_f<T>(b[off]));
    out[off] = from_f<T>(h);
  }
}

template <typename T, typename H>
int launch(const void* a, const void* b, const void* h0, void* out, int n_batch,
           int seq, int dim, cudaStream_t stream) {
  const int n = n_batch * dim;
  const int blocks = (n + kThreads - 1) / kThreads;
  lru_scan_kernel<T, H><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const H*>(h0),
      static_cast<T*>(out), n_batch, seq, dim);
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
