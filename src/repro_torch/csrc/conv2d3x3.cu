// 3x3 convolution + bias (+ ReLU) over NHWC float32 tensors, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/conv2d3x3.py::conv2d3x3
// (body _kernel).  It serves the six non-transposed convs of every
// skipping-DNN forward (conv_in, down1-4 with ReLU fused, conv_out without).
//
//   y[n,oh,ow,co] = act( sum_{dy,dx,ci} xpad[n, oh*s+dy, ow*s+dx, ci]
//                                       * w[dy,dx,ci,co]  + b[co] )
//
// SAME padding follows XLA's arithmetic (lo = total // 2), so at stride 2 on
// an even size the padding is lo=0, hi=1; the wrapper passes pad_top/left.
//
// Bound: memory traffic.  With 1-16 input and 1-8 output channels a point
// does 9*Cin*Cout multiply-adds for 4*(Cin*s^-2 + Cout) bytes, far below the
// card's ratio of operations to bytes.  Design: one thread per output pixel,
// all Cout accumulators in registers (COUT is a template parameter), weights
// and bias in shared memory, every input value read from global memory (the
// 3x3 neighbourhood of a warp's pixels stays in L1/L2).  Sums run in a fixed
// order (dy, dx, then ci ascending) with fused multiply-adds and no atomics,
// so a launch is deterministic: decode reproduces encode's residual bit for
// bit.  Tiling the halo through shared memory is a later optimisation.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCin = 16;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;

template <int COUT>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ b, float* __restrict__ y,
               int n, int h, int wd, int cin, int ho, int wo, int stride,
               int pad_top, int pad_left, int relu) {
  __shared__ float sw[9 * kMaxCin * COUT];
  __shared__ float sb[COUT];
  const int nw = 9 * cin * COUT;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) sw[i] = w[i];
  if (threadIdx.x < COUT) sb[threadIdx.x] = b[threadIdx.x];
  __syncthreads();

  const long long total = (long long)n * ho * wo;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < total; p += (long long)gridDim.x * blockDim.x) {
    const int ow = (int)(p % wo);
    const long long t = p / wo;
    const int oh = (int)(t % ho);
    const long long img = t / ho;
    float acc[COUT];
#pragma unroll
    for (int co = 0; co < COUT; ++co) acc[co] = 0.f;
    const int ih0 = oh * stride - pad_top;
    const int iw0 = ow * stride - pad_left;
    for (int dy = 0; dy < 3; ++dy) {
      const int ih = ih0 + dy;
      if (ih < 0 || ih >= h) continue;
      for (int dx = 0; dx < 3; ++dx) {
        const int iw = iw0 + dx;
        if (iw < 0 || iw >= wd) continue;
        const float* xp = x + ((img * h + ih) * wd + iw) * cin;
        const float* wp = sw + (dy * 3 + dx) * cin * COUT;
        for (int ci = 0; ci < cin; ++ci) {
          const float v = __ldg(xp + ci);
#pragma unroll
          for (int co = 0; co < COUT; ++co)
            acc[co] = fmaf(v, wp[ci * COUT + co], acc[co]);
        }
      }
    }
    float* yp = y + p * COUT;
#pragma unroll
    for (int co = 0; co < COUT; ++co) {
      const float v = acc[co] + sb[co];
      yp[co] = (relu && v < 0.f) ? 0.f : v;  // NaN passes through, as max(v, 0)
    }
  }
}

template <int COUT>
void launch(const float* x, const float* w, const float* b, float* y, int n,
            int h, int wd, int cin, int ho, int wo, int stride, int pad_top,
            int pad_left, int relu, cudaStream_t stream) {
  const long long total = (long long)n * ho * wo;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  conv3x3_kernel<COUT><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, w, b, y, n, h, wd, cin, ho, wo, stride, pad_top, pad_left, relu);
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int conv2d3x3_launch(const void* x, const void* w, const void* b,
                                void* y, int n, int h, int wd, int cin,
                                int cout, int ho, int wo, int stride,
                                int pad_top, int pad_left, int relu,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (cin < 1 || cin > kMaxCin || (stride != 1 && stride != 2))
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_CONV_CASE(C)                                                   \
  case C:                                                                    \
    launch<C>(xf, wf, bf, yf, n, h, wd, cin, ho, wo, stride, pad_top,        \
              pad_left, relu, s);                                            \
    break;
  switch (cout) {
    REPRO_CONV_CASE(1) REPRO_CONV_CASE(2) REPRO_CONV_CASE(3)
    REPRO_CONV_CASE(4) REPRO_CONV_CASE(5) REPRO_CONV_CASE(6)
    REPRO_CONV_CASE(7) REPRO_CONV_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_CONV_CASE
  return (int)cudaGetLastError();
}

extern "C" const char* conv2d3x3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
