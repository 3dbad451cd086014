// 3x3 convolution + bias (+ ReLU) over NHWC float32 tensors, for Hopper:
// the forward.  The backward (dgrad, wgrad) is conv2d3x3_bwd.cu.
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
// does 9*Cin*Cout multiply-adds for 4*(Cin/s^2 + Cout) bytes, far below the
// card's ratio of operations to bytes, so the design moves each byte once,
// coalesced:
//  * A block computes a 2-D output tile (16x64 at stride 1, 8x64 at stride
//    2) and first stages the input halo, ((TH-1)s+3) x ((TW-1)s+3) x Cin
//    floats, into shared memory with cp.async.  In NHWC a halo row is one
//    contiguous span of global memory, so the copies coalesce whatever Cin
//    is (16-byte copies where Cin is a multiple of 4); XLA's pads become the
//    copies' zero fill.  Rows are skewed (skew()) against bank conflicts.
//  * A thread computes PX neighbouring outputs of one row (4 at stride 1,
//    2 at stride 2), all Cout channels in registers: each input row of its
//    window is read from shared memory once and serves all PX outputs and
//    three taps, and each weight is read once for the PX outputs.
//  * Cin, Cout and the stride are template parameters for the enhancer's
//    layer shapes, so every loop unrolls; other shapes take an
//    instantiation with Cin and Cout known only at run time.
//  * 32-bit index arithmetic (the wrapper keeps tensors under 2^31
//    elements): the grid is (column tiles, row tiles, images).
//  * A grouped launch (conv2d3x3_grouped_launch) convolves F fields, each
//    with its own weights and bias, in one grid: the images are
//    field-major, [F*N, H, W, Cin], and block z takes field z / N's weights
//    ([F, 3, 3, Cin, Cout]) and bias ([F, Cout]).  A block's work and its
//    order of sums are those of the single-field launch on that field's
//    images, so field f's output equals that launch's byte for byte; the
//    single-field entry is the grouped one at F = 1.
//  * Outputs leave as 16-byte stores where the address allows, bias and
//    ReLU fused.
// The small layers (down3, down4 at N=10) are one wave of blocks; they sit
// at the launch floor.  Each output sums in a fixed order (dy, dx, then ci
// ascending) with fused multiply-adds and no atomics, whatever the tiling,
// so a launch is deterministic: decode reproduces encode's residual bit for
// bit.

#include "conv2d3x3_common.cuh"

namespace conv3x3 {
namespace {

template <int S>
struct FwdTile {
  static constexpr int PX = S == 1 ? 4 : 2;    // outputs per thread along x
  static constexpr int TX = S == 1 ? 16 : 32;  // threads along x
  static constexpr int TH = kThreads / TX;     // tile rows: 16 or 8
  static constexpr int TW = PX * TX;           // tile columns: 64
  static constexpr int HR = (TH - 1) * S + 3;  // staged input rows
  static constexpr int HC = (TW - 1) * S + 3;  // staged input columns
  static constexpr int RC = (PX - 1) * S + 3;  // input columns per thread
};

template <int S>
constexpr int fwd_smem_floats(int cin) {
  return FwdTile<S>::HR * skewed_row(FwdTile<S>::HC * cin);
}

// CIN_T = COUT_T = 0: Cin and Cout are the run-time cin_rt, cout_rt (at
// most kMaxCin, kMaxCout).
template <int CIN_T, int COUT_T, int S>
__global__ void __launch_bounds__(kThreads)
conv3x3_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ y,
                   int n_per_field, int h, int wd, int cin_rt, int cout_rt,
                   int ho, int wo, int pad_top, int pad_left, int relu) {
  using T = FwdTile<S>;
  constexpr int MAXC = CIN_T > 0 ? CIN_T : kMaxCin;
  constexpr int MAXO = COUT_T > 0 ? COUT_T : kMaxCout;
  constexpr int V = CIN_T > 0 ? vec_width<CIN_T>() : 1;
  const int cin = CIN_T > 0 ? CIN_T : cin_rt;
  const int cout = COUT_T > 0 ? COUT_T : cout_rt;
  extern __shared__ float4 smem4[];
  float* sx = reinterpret_cast<float*>(smem4);
  __shared__ float sw[9 * MAXC * MAXO];
  __shared__ float sb[MAXO];

  const int n = blockIdx.z;
  const int field = n / n_per_field;
  w += field * (9 * cin * cout);
  b += field * cout;
  const int oh0 = blockIdx.y * T::TH, ow0 = blockIdx.x * T::TW;
  const int iy0 = oh0 * S - pad_top, ix0 = ow0 * S - pad_left;
  const int rs = skewed_row(T::HC * cin);
  const float* xn = x + n * (h * wd * cin);

  // Stage the halo: row r of the tile's window is the contiguous span of
  // T::HC pixels starting at (iy0 + r, ix0); pixels outside the image are
  // XLA's zero pads.
  const int row_chunks = T::HC * cin / V;
  for (int c = threadIdx.x; c < T::HR * row_chunks; c += kThreads) {
    const int r = c / row_chunks;
    const int f = (c - r * row_chunks) * V;
    const int col = f / cin;
    const int iy = iy0 + r, ix = ix0 + col;
    const bool in = static_cast<unsigned>(iy) < static_cast<unsigned>(h) &&
                    static_cast<unsigned>(ix) < static_cast<unsigned>(wd);
    cp_async_zfill<4 * V>(sx + r * rs + skew(f),
                          in ? xn + (iy * wd + ix) * cin + (f - col * cin) : x,
                          in);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < 9 * cin * cout; i += kThreads) sw[i] = w[i];
  if (threadIdx.x < cout) sb[threadIdx.x] = b[threadIdx.x];
  cp_async_wait<0>();
  __syncthreads();

  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
  float acc[T::PX][MAXO];
#pragma unroll
  for (int j = 0; j < T::PX; ++j)
#pragma unroll
    for (int co = 0; co < MAXO; ++co) acc[j][co] = 0.f;

  const int f0 = tx * T::PX * S * cin;   // a multiple of 4
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    float xr[T::RC * MAXC];   // this thread's window of input row ty*S+dy
    load_run(sx + (ty * S + dy) * rs, f0, T::RC * cin, xr);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const float* wp = sw + (dy * 3 + dx) * cin * cout;
#pragma unroll
      for (int ci = 0; ci < cin; ++ci) {
        float wv[MAXO];
#pragma unroll
        for (int co = 0; co < cout; ++co) {
          wv[co] = wp[ci * cout + co];
        }
#pragma unroll
        for (int j = 0; j < T::PX; ++j) {
          const float v = xr[(j * S + dx) * cin + ci];
#pragma unroll
          for (int co = 0; co < cout; ++co) {
            acc[j][co] = fmaf(v, wv[co], acc[j][co]);
          }
        }
      }
    }
  }

  const int oh = oh0 + ty, ow = ow0 + tx * T::PX;
  if (oh >= ho || ow >= wo) return;
  float out[T::PX * MAXO];
#pragma unroll
  for (int j = 0; j < T::PX; ++j)
#pragma unroll
    for (int co = 0; co < cout; ++co) {
      const float v = acc[j][co] + sb[co];
      // NaN passes through, as max(v, 0)
      out[j * MAXO + co] = (relu && v < 0.f) ? 0.f : v;
    }
  float* yp = y + ((n * ho + oh) * wo + ow) * cout;
  if (COUT_T > 0 && ow + T::PX <= wo) {
    store_run(yp, out);
    return;
  }
#pragma unroll
  for (int j = 0; j < T::PX; ++j) {
    if (ow + j >= wo) break;
#pragma unroll
    for (int co = 0; co < cout; ++co) {
      yp[j * cout + co] = out[j * MAXO + co];
    }
  }
}

template <int CIN_T, int COUT_T, int S>
cudaError_t launch(const float* x, const float* w, const float* b, float* y,
                   int fields, int n, int h, int wd, int cin, int cout, int ho,
                   int wo, int pad_top, int pad_left, int relu,
                   cudaStream_t stream) {
  using T = FwdTile<S>;
  static int granted = 48 * 1024;
  const int smem = fwd_smem_floats<S>(cin) * 4;
  cudaError_t err =
      allow_smem(conv3x3_fwd_kernel<CIN_T, COUT_T, S>, smem, granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((wo + T::TW - 1) / T::TW, (ho + T::TH - 1) / T::TH,
                  fields * n);
  conv3x3_fwd_kernel<CIN_T, COUT_T, S><<<grid, kThreads, smem, stream>>>(
      x, w, b, y, n, h, wd, cin, cout, ho, wo, pad_top, pad_left, relu);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const float*, const float*, const float*,
                               float*, int, int, int, int, int, int, int, int,
                               int, int, int, cudaStream_t);

// The enhancer's layers (conv_in at c_in 1-3, down1-4, conv_out with and
// without skip connections), then Cin and Cout at run time.
Launch pick(int cin, int cout, int stride) {
  if (stride == 1) {
    if (cout == 4 && cin >= 1 && cin <= 3)
      return cin == 1 ? launch<1, 4, 1> : cin == 2 ? launch<2, 4, 1>
                                                   : launch<3, 4, 1>;
    if (cout == 1 && cin == 8) return launch<8, 1, 1>;
    if (cout == 1 && cin == 4) return launch<4, 1, 1>;
  } else {
    if (cin == 4 && cout == 4) return launch<4, 4, 2>;
    if (cin == 4 && cout == 6) return launch<4, 6, 2>;
    if (cin == 6 && cout == 6) return launch<6, 6, 2>;
    if (cin == 6 && cout == 8) return launch<6, 8, 2>;
  }
  return stride == 1 ? launch<0, 0, 1> : launch<0, 0, 2>;
}

}  // namespace
}  // namespace conv3x3

// F fields of n images each, field-major: x [F*n, h, wd, cin], w [F, 3, 3,
// cin, cout], b [F, cout], y [F*n, ho, wo, cout].  Returns a cudaError_t: 0
// when the launch was accepted.
extern "C" int conv2d3x3_grouped_launch(const void* x, const void* w,
                                        const void* b, void* y, int fields,
                                        int n, int h, int wd, int cin,
                                        int cout, int ho, int wo, int stride,
                                        int pad_top, int pad_left, int relu,
                                        int device, void* stream) {
  using namespace conv3x3;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cin < 1 || cin > kMaxCin || cout < 1 || cout > kMaxCout ||
      (stride != 1 && stride != 2) || fields < 1 || n < 1 ||
      n > 65535 / fields)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(pick(cin, cout, stride)(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(y), fields, n, h, wd,
      cin, cout, ho, wo, pad_top, pad_left, relu,
      static_cast<cudaStream_t>(stream)));
}

// One field: the grouped launch at F = 1.
extern "C" int conv2d3x3_launch(const void* x, const void* w, const void* b,
                                void* y, int n, int h, int wd, int cin,
                                int cout, int ho, int wo, int stride,
                                int pad_top, int pad_left, int relu,
                                int device, void* stream) {
  return conv2d3x3_grouped_launch(x, w, b, y, 1, n, h, wd, cin, cout, ho, wo,
                                  stride, pad_top, pad_left, relu, device,
                                  stream);
}

extern "C" const char* conv2d3x3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
