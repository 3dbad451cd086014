// Pieces shared by conv2d3x3.cu (forward) and conv2d3x3_bwd.cu (dgrad,
// wgrad): asynchronous staging of NHWC tiles into shared memory, the skewed
// shared-memory layout of a staged row, vector loads and stores, and the
// device selection of the C entries.
#ifndef REPRO_TORCH_CONV2D3X3_COMMON_CUH_
#define REPRO_TORCH_CONV2D3X3_COMMON_CUH_

#include <cstdint>

#include <cuda_runtime.h>

namespace conv3x3 {

constexpr int kThreads = 256;
constexpr int kMaxCin = 16;
constexpr int kMaxCout = 8;

// Floats a thread moves per asynchronous copy (and per vector load) for a
// run of C-float pixels: 16 bytes where C allows it, else 8, else 4.  A
// chunk never straddles a pixel, so it is either in the image or padding.
template <int C>
__host__ __device__ constexpr int vec_width() { return C % 4 == 0 ? 4 : (C % 2 == 0 ? 2 : 1); }

// Shared-memory index of float f of a staged row: 4 floats of padding
// after every 32.  Threads reading 16-byte vectors 32 or 128 bytes apart
// (Cin = 4 or 8, one or four pixels a thread) then fall on different banks.
// A 4-float run starting at a multiple of 4 stays contiguous.
__host__ __device__ constexpr int skew(int f) { return f + ((f >> 5) << 2); }

// Floats of one staged row of `floats` values, rounded up to 16 bytes.
__host__ __device__ constexpr int skewed_row(int floats) {
  return (skew(floats - 1) + 1 + 3) & ~3;
}

// Copy BYTES (4, 8 or 16) from global to shared memory without passing
// through registers; when `valid` is false, write zeros and read nothing
// (src must still be a mapped address).
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(float* dst, const float* src,
                                               bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(BYTES), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Read n floats of a skewed shared row starting at float f0 (a multiple of
// 4) into out[]: 16-byte loads, then the tail one by one.
template <int MAXN>
__device__ __forceinline__ void load_run(const float* row, int f0, int n,
                                         float (&out)[MAXN]) {
  int i = 0;
#pragma unroll
  for (; i + 4 <= MAXN; i += 4) {
    if (i + 4 > n) break;
    const float4 v = *reinterpret_cast<const float4*>(row + skew(f0 + i));
    out[i] = v.x; out[i + 1] = v.y; out[i + 2] = v.z; out[i + 3] = v.w;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (i + j < n && i + j < MAXN) out[i + j] = row[skew(f0 + i + j)];
}

// Read the n <= MAXN channels of one pixel of a skewed shared row, starting
// at float f (a multiple of V, which divides n), with V-float loads.
template <int V, int MAXN>
__device__ __forceinline__ void load_pixel(const float* row, int f, int n,
                                           float (&out)[MAXN]) {
#pragma unroll
  for (int i = 0; i < MAXN; i += V) {
    if (i >= n) break;
    const float* p = row + skew(f + i);
    if constexpr (V == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      out[i] = v.x; out[i + 1] = v.y; out[i + 2] = v.z; out[i + 3] = v.w;
    } else if constexpr (V == 2) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      out[i] = v.x; out[i + 1] = v.y;
    } else {
      out[i] = *p;
    }
  }
}

// Store N consecutive floats with the widest stores the address allows.
template <int N>
__device__ __forceinline__ void store_run(float* dst, const float (&v)[N]) {
  const auto a = reinterpret_cast<std::uintptr_t>(dst);
  if constexpr (N % 4 == 0) {
    if ((a & 15) == 0) {
#pragma unroll
      for (int i = 0; i < N; i += 4)
        *reinterpret_cast<float4*>(dst + i) =
            make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
      return;
    }
  }
  if constexpr (N % 2 == 0) {
    if ((a & 7) == 0) {
#pragma unroll
      for (int i = 0; i < N; i += 2)
        *reinterpret_cast<float2*>(dst + i) = make_float2(v[i], v[i + 1]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = v[i];
}

// Make `device` current, calling cudaSetDevice only when it is not.
inline cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return err;
  return cur == device ? cudaSuccess : cudaSetDevice(device);
}

// Raise a kernel's dynamic shared-memory limit to `bytes` (past 48 KB);
// done once per kernel, as the limit only grows.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int& granted) {
  if (bytes <= granted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) granted = bytes;
  return err;
}

}  // namespace conv3x3

#endif  // REPRO_TORCH_CONV2D3X3_COMMON_CUH_
