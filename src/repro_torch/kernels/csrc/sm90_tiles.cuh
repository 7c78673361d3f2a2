// Tensor-core and async-copy building blocks shared by the port's tiled
// kernels (flash_attention.cu, grouped_matmul.cu, lru_scan.cu) on Hopper
// (sm_90a):
//
// * cp_async16: one 16-byte cp.async global -> shared copy that zero-fills
//   its destination when the source lies outside the tensor (src-size 0),
//   so a ring stage's ragged rows and columns read as 0 with no branch in
//   the consumer;
// * ldmatrix x4 (and .trans): four 8x8 b16 tiles from shared memory into
//   the fragment layout of mma.sync;
// * Mma<T>::run: mma.sync.m16n8k16, D = A * B + D with A 16x16 and B 16x8
//   in bfloat16 or float16, accumulated in float32; Mma<T>::pack rounds two
//   float32 values into one A-operand register;
// * stage: a [R, C] tile from global into shared memory, 16-byte cp.async
//   copies where rows allow them, element loads where they do not (also
//   lru_scan.cu's time tiles); from_f / to_f convert float32 and the
//   storage types;
// * opt_in: the dynamic shared-memory attribute above 48 KB.
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A: a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//      a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B: b0 (k 2t, 2t+1; col g), b1 (k 2t+8, 2t+9; col g);
//   C: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, cols 2t, 2t+1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to dst when ok, else 16 zero bytes (src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Lanes 0-7, 8-15, 16-23 and 24-31 give the row addresses of tiles 0-3;
// r[i] is tile i's fragment (row lane / 4, columns 2 * (lane % 4) + {0, 1}).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// As ldmatrix_x4, each tile transposed: r[i] holds tile i's rows
// 2 * (lane % 4) + {0, 1} of column lane / 4.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  __device__ __forceinline__ static void run(float c[4], const uint32_t a[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // Two float32 values rounded to nearest even into one b16x2 register
  // (lo in the low half).
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <> struct Mma<__half> {
  __device__ __forceinline__ static void run(float c[4], const uint32_t a[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// float32 -> the storage types, round to nearest even (float32 as is).
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// The storage types -> float32 (exact).
template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) { return __half2float(x); }

// dst[r * LD + c] = src[r * ld_src + c] for r < r_lim and c < c_lim, else
// 0, for r < R and c < C: 16-byte cp.async copies (c_lim and ld_src are
// multiples of 16 / sizeof(T) and src is 16-byte aligned, so a copy is
// wholly inside or wholly outside) when vec, else element loads. The
// element path is for rows that are not 16-byte multiples.
template <typename T, int R, int C, int LD, int kThreads>
__device__ __forceinline__ void stage(T* dst, const T* src, size_t ld_src, int r_lim,
                                      int c_lim, bool vec) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements per copy
  static_assert(C % kPer == 0, "a staged row is whole 16-byte copies");
  if (vec) {
    constexpr int CH = C / kPer;
    for (int i = threadIdx.x; i < R * CH; i += kThreads) {
      const int r = i / CH;
      const int c = (i - r * CH) * kPer;
      const bool ok = r < r_lim && c < c_lim;
      cp_async16(dst + r * LD + c, ok ? src + r * ld_src + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < R * C; i += kThreads) {
      const int r = i / C;
      const int c = i - r * C;
      dst[r * LD + c] = (r < r_lim && c < c_lim) ? src[r * ld_src + c] : from_f<T>(0.0f);
    }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Above 48 KB of dynamic shared memory a kernel must opt in: once per
// kernel (done), and the first launch that needs it. Returns the CUDA
// error (0 on success).
template <typename K>
int opt_in(K kernel, size_t smem, bool& done) {
  if (smem > 48 * 1024 && !done) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    done = true;
  }
  return 0;
}

}  // namespace sm90
