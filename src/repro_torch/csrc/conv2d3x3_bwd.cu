// Backward of the 3x3 convolution of conv2d3x3.cu, for Hopper: the input
// gradient (dgrad) and the weight and bias gradients (wgrad), launched back
// to back by one C call.
//
// Completes the port of the Pallas TPU kernel
// src/repro/kernels/conv2d3x3.py::conv2d3x3, whose gradient the JAX package
// takes by XLA's autodiff of the same nine-tap sum
// (src/repro/core/skipping_dnn.py::_conv_taps).  Both kernels read the
// forward's saved output y and apply the ReLU mask g' = (y > 0) ? g : 0
// while they read g: no separate mask pass.
//
//   dx[n,ih,iw,ci] = sum_{dy,dx,co} g'[n,oh,ow,co] * w[dy,dx,ci,co]
//                    over oh*s + dy - pad_top = ih, ow*s + dx - pad_left = iw
//   dw[dy,dx,ci,co] = sum_{n,oh,ow} xpad[n, oh*s+dy, ow*s+dx, ci] * g'[n,oh,ow,co]
//   db[co]          = sum_{n,oh,ow} g'[n,oh,ow,co]
//
// Bound: memory traffic, as the forward: each reads x or writes dx once
// (4*Cin bytes a pixel) and reads g and y once (8*Cout bytes an output).
//
// dgrad is a gather, not a scatter: a block owns an 8x64 tile of dx,
// stages the matching (8/s+2) x (64/s+2) tile of g and y in shared memory
// with cp.async (zeros outside the output), and each thread sums two
// neighbouring pixels, all Cin channels in registers, over the taps that
// land on them: at stride 2 the taps are picked by the parity of
// ih + pad_top - dy (XLA's pads are asymmetric, lo=0 hi=1 on even sizes).
// The two pixels of a thread have fixed parities, so a warp never diverges.
// Weights sit in shared memory as [tap][co][ci], read by all threads at
// once.  Each element sums in the fixed order (dy, dx, co ascending).
//
// wgrad reduces up to N*Ho*Wo = 2.6M terms into 9*Cin*Cout + Cout sums,
// deterministically, in two passes and without atomics:
//  * pass 1: a fixed grid of blocks walks the output tiles (16x64 at stride
//    1, 8x64 at stride 2) in a fixed order, double-buffered: while a tile is
//    summed, the next one's x halo and g, y tiles are in flight (cp.async).
//    Each thread keeps its partial sums in registers over all its tiles:
//    all 9*Cin*Cout where they fit, else the taps of one row (blockIdx.y
//    picks the row).  At the end a warp folds its lanes with a fixed
//    butterfly of shuffles and the block adds its warps in order, into one
//    row of per-block partials;
//  * pass 2: the rows are added in a fixed order, 32 columns a block.
// So the sums run in one order for given shapes, whatever the timing.

#include "conv2d3x3_common.cuh"

namespace conv3x3 {
namespace {

// wgrad's first pass runs kSMs * (blocks an SM) / (tap groups) blocks: a
// constant (an H100's SM count), so that the order of the sums does not
// depend on the card.  kWgradRows bounds the rows of partials.
constexpr int kSMs = 132;
constexpr int kWgradRows = 2 * kSMs;

struct DgradTile {
  static constexpr int PX = 2;                 // pixels per thread along x
  static constexpr int TX = 32;                // threads along x
  static constexpr int TH = kThreads / TX;     // tile rows: 8
  static constexpr int TW = PX * TX;           // tile columns: 64
};

// CIN_T = COUT_T = 0: Cin and Cout are the run-time cin_rt, cout_rt (at
// most kMaxCin, kMaxCout).
template <int CIN_T, int COUT_T, int S>
__global__ void __launch_bounds__(kThreads)
conv3x3_bwd_dgrad_kernel(const float* __restrict__ g,
                         const float* __restrict__ y,
                         const float* __restrict__ w, float* __restrict__ dx,
                         int h, int wd, int cin_rt, int cout_rt, int ho,
                         int wo, int pad_top, int pad_left, int relu) {
  using T = DgradTile;
  constexpr int MAXC = CIN_T > 0 ? CIN_T : kMaxCin;
  constexpr int MAXO = COUT_T > 0 ? COUT_T : kMaxCout;
  constexpr int V = COUT_T > 0 ? vec_width<COUT_T>() : 1;
  constexpr int GR = T::TH / S + 2, GC = T::TW / S + 2;  // staged rows, columns
  const int cin = CIN_T > 0 ? CIN_T : cin_rt;
  const int cout = COUT_T > 0 ? COUT_T : cout_rt;
  const int gs = GC * cout;                              // floats a staged row
  __shared__ __align__(16) float sg[GR * GC * MAXO];
  __shared__ __align__(16) float sy[GR * GC * MAXO];
  __shared__ float sw[9 * MAXO * MAXC];

  const int n = blockIdx.z;
  const int ih0 = blockIdx.y * T::TH, iw0 = blockIdx.x * T::TW;
  // Every tap that lands on the tile reads output rows oh_lo..oh_lo+GR-1
  // (and columns likewise): ih0 is even and pad_top is 1 at stride 1, 0 or
  // 1 at stride 2.
  const int oh_lo = ih0 / S - 1, ow_lo = iw0 / S - 1;
  const int off = n * (ho * wo * cout);
  const int row_chunks = gs / V;
  for (int c = threadIdx.x; c < GR * row_chunks; c += kThreads) {
    const int r = c / row_chunks;
    const int f = (c - r * row_chunks) * V;
    const int col = f / cout;
    const int oh = oh_lo + r, ow = ow_lo + col;
    const bool in = static_cast<unsigned>(oh) < static_cast<unsigned>(ho) &&
                    static_cast<unsigned>(ow) < static_cast<unsigned>(wo);
    const int src = off + (oh * wo + ow) * cout + (f - col * cout);
    cp_async_zfill<4 * V>(sg + r * gs + f, in ? g + src : g, in);
    if (relu) cp_async_zfill<4 * V>(sy + r * gs + f, in ? y + src : y, in);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < 9 * cin * cout; i += kThreads) {
    const int tap = i / (cin * cout), rem = i - tap * (cin * cout);
    const int ci = rem / cout, co = rem - ci * cout;
    sw[(tap * cout + co) * cin + ci] = w[i];
  }
  cp_async_wait<0>();
  __syncthreads();

  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
  const int ih = ih0 + ty, iw = iw0 + tx * T::PX;
  float acc[T::PX][MAXC];
#pragma unroll
  for (int j = 0; j < T::PX; ++j)
#pragma unroll
    for (int ci = 0; ci < MAXC; ++ci) acc[j][ci] = 0.f;

#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int t = ih + pad_top - dy;   // oh * S where the tap lands
    if (S == 2 && (t & 1)) continue;
    const float* grow = sg + (t / S - oh_lo) * gs;
    const float* yrow = sy + (t / S - oh_lo) * gs;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const float* wp = sw + (dy * 3 + dx) * cout * cin;
#pragma unroll
      for (int j = 0; j < T::PX; ++j) {
        const int u = iw + j + pad_left - dx;   // ow * S where the tap lands
        if (S == 2 && (u & 1)) continue;
        const int col = (u / S - ow_lo) * cout;
#pragma unroll
        for (int co = 0; co < cout; ++co) {
          float gv = grow[col + co];
          if (relu && !(yrow[col + co] > 0.f)) gv = 0.f;
#pragma unroll
          for (int ci = 0; ci < cin; ++ci) {
            acc[j][ci] = fmaf(gv, wp[co * cin + ci], acc[j][ci]);
          }
        }
      }
    }
  }

  if (ih >= h || iw >= wd) return;
  float* dp = dx + ((n * h + ih) * wd + iw) * cin;
  if constexpr (CIN_T > 0) {
    if (iw + T::PX <= wd) {
      float out[T::PX * CIN_T];
#pragma unroll
      for (int j = 0; j < T::PX; ++j)
#pragma unroll
        for (int ci = 0; ci < CIN_T; ++ci) out[j * CIN_T + ci] = acc[j][ci];
      store_run(dp, out);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < T::PX; ++j) {
    if (iw + j >= wd) break;
#pragma unroll
    for (int ci = 0; ci < cin; ++ci) {
      dp[j * cin + ci] = acc[j][ci];
    }
  }
}

template <int CIN_T, int COUT_T, int S>
struct WgradTile {
  static constexpr int MAXC = CIN_T > 0 ? CIN_T : kMaxCin;
  static constexpr int MAXO = COUT_T > 0 ? COUT_T : kMaxCout;
  static constexpr int TW = 64;                          // tile columns
  static constexpr int TH = (CIN_T > 0 ? 16 : 8) / S;    // tile rows
  static constexpr int HR = (TH - 1) * S + 3;            // staged x rows
  static constexpr int HC = (TW - 1) * S + 3;            // staged x columns
  static constexpr int PPT = TH * TW / kThreads;         // positions a thread takes a tile
  static constexpr int GT = TH * TW * MAXO;              // floats of a staged g tile
  // Taps a block sums: all nine where their 9*Cin*Cout partial sums fit in
  // a thread's registers, else one row of three, else one (Cin at run time).
  static constexpr int TPG = CIN_T == 0 ? 1
                             : 9 * MAXC * MAXO <= 150 ? 9
                             : 3 * MAXC * MAXO <= 150 ? 3 : 1;
  static constexpr int NG = 9 / TPG;                     // blockIdx.y range
  static constexpr int KA = TPG * MAXC * MAXO + MAXO;    // sums a thread keeps
  // Two blocks an SM where their registers allow it: a second block's
  // copies are in flight while the first block sums.
  static constexpr int BPS = CIN_T > 0 && KA <= 80 ? 2 : 1;
};

template <int CIN_T, int COUT_T, int S>
constexpr int wgrad_buf_floats(int cin) {
  using T = WgradTile<CIN_T, COUT_T, S>;
  return T::HR * skewed_row(T::HC * cin) + 2 * T::GT;
}

template <int CIN_T, int COUT_T, int S>
__global__ void __launch_bounds__(kThreads, (WgradTile<CIN_T, COUT_T, S>::BPS))
conv3x3_bwd_wgrad_kernel(const float* __restrict__ x,
                         const float* __restrict__ g,
                         const float* __restrict__ y,
                         float* __restrict__ partial, int n, int h, int wd,
                         int cin_rt, int cout_rt, int ho, int wo, int pad_top,
                         int pad_left, int relu) {
  using T = WgradTile<CIN_T, COUT_T, S>;
  constexpr int MAXC = T::MAXC, MAXO = T::MAXO;
  constexpr int VX = CIN_T > 0 ? vec_width<CIN_T>() : 1;
  constexpr int VG = COUT_T > 0 ? vec_width<COUT_T>() : 1;
  const int cin = CIN_T > 0 ? CIN_T : cin_rt;
  const int cout = COUT_T > 0 ? COUT_T : cout_rt;
  const int rs = skewed_row(T::HC * cin);
  const int xs_floats = T::HR * rs;
  const int buf_floats = xs_floats + 2 * T::GT;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float red[kThreads / 32][T::KA];

  const int tiles_x = (wo + T::TW - 1) / T::TW;
  const int tiles_y = (ho + T::TH - 1) / T::TH;
  const int tiles = n * tiles_y * tiles_x;
  const int group = blockIdx.y;

  // Tile t of the walk: image, first output row and column.
  auto origin = [&](int t, int& img, int& oh0, int& ow0) {
    img = t / (tiles_y * tiles_x);
    const int rem = t - img * (tiles_y * tiles_x);
    oh0 = rem / tiles_x * T::TH;
    ow0 = (rem - rem / tiles_x * tiles_x) * T::TW;
  };

  // Start the copies of tile t into buf: the x halo (XLA's pads as zeros),
  // then g and y (zeros past the output's edge).
  auto stage = [&](int t, float* buf) {
    int img, oh0, ow0;
    origin(t, img, oh0, ow0);
    const int iy0 = oh0 * S - pad_top, ix0 = ow0 * S - pad_left;
    const float* xn = x + img * (h * wd * cin);
    const int row_chunks = T::HC * cin / VX;
    for (int c = threadIdx.x; c < T::HR * row_chunks; c += kThreads) {
      const int r = c / row_chunks;
      const int f = (c - r * row_chunks) * VX;
      const int col = f / cin;
      const int iy = iy0 + r, ix = ix0 + col;
      const bool in = static_cast<unsigned>(iy) < static_cast<unsigned>(h) &&
                      static_cast<unsigned>(ix) < static_cast<unsigned>(wd);
      cp_async_zfill<4 * VX>(
          buf + r * rs + skew(f),
          in ? xn + (iy * wd + ix) * cin + (f - col * cin) : x, in);
    }
    float* sg = buf + xs_floats;
    const int g_chunks = T::TW * cout / VG;
    const int off = img * (ho * wo * cout);
    for (int c = threadIdx.x; c < T::TH * g_chunks; c += kThreads) {
      const int r = c / g_chunks;
      const int f = (c - r * g_chunks) * VG;
      const int col = f / cout;
      const int oh = oh0 + r, ow = ow0 + col;
      const bool in = oh < ho && ow < wo;
      const int src = off + (oh * wo + ow) * cout + (f - col * cout);
      const int dst = r * (T::TW * cout) + f;
      cp_async_zfill<4 * VG>(sg + dst, in ? g + src : g, in);
      if (relu) cp_async_zfill<4 * VG>(sg + T::GT + dst, in ? y + src : y, in);
    }
  };

  float acc[T::TPG][MAXC][MAXO];
  float dacc[MAXO];
#pragma unroll
  for (int co = 0; co < MAXO; ++co) {
    dacc[co] = 0.f;
#pragma unroll
    for (int tt = 0; tt < T::TPG; ++tt)
#pragma unroll
      for (int ci = 0; ci < MAXC; ++ci) acc[tt][ci][co] = 0.f;
  }

  const int col = threadIdx.x % T::TW;
  int buf = 0;
  stage(blockIdx.x, smem);   // the grid never exceeds the tiles
  cp_async_commit();
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    if (t + gridDim.x < tiles) stage(t + gridDim.x, smem + (buf ^ 1) * buf_floats);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const float* sx = smem + buf * buf_floats;
    const float* sg = sx + xs_floats;
    const float* sy = sg + T::GT;
    int img, oh0, ow0;
    origin(t, img, oh0, ow0);
#pragma unroll
    for (int i = 0; i < T::PPT; ++i) {
      const int row = threadIdx.x / T::TW + i * (kThreads / T::TW);
      if (oh0 + row >= ho || ow0 + col >= wo) continue;
      const int p = (row * T::TW + col) * cout;
      float gv[MAXO];
#pragma unroll
      for (int co = 0; co < cout; ++co) {
        gv[co] = sg[p + co];
        if (relu && !(sy[p + co] > 0.f)) gv[co] = 0.f;
        dacc[co] += gv[co];
      }
#pragma unroll
      for (int tt = 0; tt < T::TPG; ++tt) {
        const int tap = group * T::TPG + tt;
        const int dy = tap / 3, dx = tap - 3 * (tap / 3);
        float xv[MAXC];
        load_pixel<VX>(sx + (row * S + dy) * rs, (col * S + dx) * cin, cin, xv);
#pragma unroll
        for (int ci = 0; ci < cin; ++ci) {
#pragma unroll
          for (int co = 0; co < cout; ++co) {
            acc[tt][ci][co] = fmaf(xv[ci], gv[co], acc[tt][ci][co]);
          }
        }
      }
    }
    __syncthreads();
    buf ^= 1;
  }

  // Fold the lanes of each warp (a fixed butterfly), then the warps in order.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto fold = [&](float v, int k) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    if (lane == 0) red[warp][k] = v;
  };
#pragma unroll
  for (int tt = 0; tt < T::TPG; ++tt)
#pragma unroll
    for (int ci = 0; ci < cin; ++ci) {
#pragma unroll
      for (int co = 0; co < cout; ++co) {
        fold(acc[tt][ci][co], (tt * MAXC + ci) * MAXO + co);
      }
    }
#pragma unroll
  for (int co = 0; co < cout; ++co) {
    fold(dacc[co], T::TPG * MAXC * MAXO + co);
  }
  __syncthreads();

  const int kw = 9 * cin * cout;        // weight sums; the bias sums follow
  const int mine = T::TPG * cin * cout;  // weight sums of this block's taps
  float* out = partial + blockIdx.x * (kw + cout);
  for (int k = threadIdx.x; k < mine + (group == 0 ? cout : 0); k += kThreads) {
    int local, glob;
    if (k < mine) {
      const int tt = k / (cin * cout), rem = k - tt * (cin * cout);
      const int ci = rem / cout, co = rem - ci * cout;
      local = (tt * MAXC + ci) * MAXO + co;
      glob = group * mine + rem + tt * (cin * cout);
    } else {
      local = T::TPG * MAXC * MAXO + (k - mine);
      glob = kw + (k - mine);
    }
    float s = red[0][local];
#pragma unroll
    for (int wi = 1; wi < kThreads / 32; ++wi) s += red[wi][local];
    out[glob] = s;
  }
}

// Pass 2: dw and db.  Block b owns columns 32b..32b+31 of the partials:
// warp w adds rows w, w+32, w+64, ... in order, then warp 0 adds the 32
// warps' sums in order.
constexpr int kSumThreads = 1024;

__global__ void __launch_bounds__(kSumThreads)
conv3x3_bwd_wsum_kernel(const float* __restrict__ partial, int rows, int kw,
                        int cout, float* __restrict__ dw,
                        float* __restrict__ db) {
  __shared__ float part[kSumThreads / 32][32];
  const int kt = kw + cout;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (k < kt) {
#pragma unroll 4
    for (int r = warp; r < rows; r += kSumThreads / 32) s += partial[r * kt + k];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && k < kt) {
    s = part[0][lane];
#pragma unroll
    for (int wi = 1; wi < kSumThreads / 32; ++wi) s += part[wi][lane];
    if (k < kw) dw[k] = s; else db[k - kw] = s;
  }
}

struct BwdArgs {
  const float *x, *w, *y, *g;
  float *dx, *dw, *db, *partial;
  int partial_rows, n, h, wd, cin, cout, ho, wo, pad_top, pad_left, relu;
  cudaStream_t stream;
};

template <int CIN_T, int COUT_T, int S>
cudaError_t launch_dgrad(const BwdArgs& a) {
  using T = DgradTile;
  const dim3 grid((a.wd + T::TW - 1) / T::TW, (a.h + T::TH - 1) / T::TH, a.n);
  conv3x3_bwd_dgrad_kernel<CIN_T, COUT_T, S><<<grid, kThreads, 0, a.stream>>>(
      a.g, a.y, a.w, a.dx, a.h, a.wd, a.cin, a.cout, a.ho, a.wo, a.pad_top,
      a.pad_left, a.relu);
  return cudaGetLastError();
}

template <int CIN_T, int COUT_T, int S>
cudaError_t launch_wgrad(const BwdArgs& a) {
  using T = WgradTile<CIN_T, COUT_T, S>;
  static int granted = 48 * 1024;
  const int tiles = a.n * ((a.ho + T::TH - 1) / T::TH) * ((a.wo + T::TW - 1) / T::TW);
  constexpr int most = kSMs * T::BPS / T::NG;
  static_assert(most <= kWgradRows, "more blocks than rows of partials");
  const int blocks = tiles < most ? tiles : most;
  if (blocks > a.partial_rows) return cudaErrorInvalidValue;
  const int smem = 2 * wgrad_buf_floats<CIN_T, COUT_T, S>(a.cin) * 4;
  cudaError_t err =
      allow_smem(conv3x3_bwd_wgrad_kernel<CIN_T, COUT_T, S>, smem, granted);
  if (err != cudaSuccess) return err;
  conv3x3_bwd_wgrad_kernel<CIN_T, COUT_T, S><<<dim3(blocks, T::NG), kThreads, smem, a.stream>>>(
      a.x, a.g, a.y, a.partial, a.n, a.h, a.wd, a.cin, a.cout, a.ho, a.wo,
      a.pad_top, a.pad_left, a.relu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int kt = 9 * a.cin * a.cout + a.cout;
  conv3x3_bwd_wsum_kernel<<<(kt + 31) / 32, kSumThreads, 0, a.stream>>>(
      a.partial, blocks, 9 * a.cin * a.cout, a.cout, a.dw, a.db);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const BwdArgs&);

// The enhancer's layers (dgrad: down1-4 and conv_out; wgrad: conv_in at
// c_in 1-3 too), then Cin and Cout at run time.
template <template <int, int, int> class Pick>
Launch pick(int cin, int cout, int stride, bool conv_in_shapes) {
  if (stride == 1) {
    if (conv_in_shapes && cout == 4 && cin >= 1 && cin <= 3)
      return cin == 1 ? Pick<1, 4, 1>::fn : cin == 2 ? Pick<2, 4, 1>::fn
                                                     : Pick<3, 4, 1>::fn;
    if (cout == 1 && cin == 8) return Pick<8, 1, 1>::fn;
    if (cout == 1 && cin == 4) return Pick<4, 1, 1>::fn;
  } else {
    if (cin == 4 && cout == 4) return Pick<4, 4, 2>::fn;
    if (cin == 4 && cout == 6) return Pick<4, 6, 2>::fn;
    if (cin == 6 && cout == 6) return Pick<6, 6, 2>::fn;
    if (cin == 6 && cout == 8) return Pick<6, 8, 2>::fn;
  }
  return stride == 1 ? Pick<0, 0, 1>::fn : Pick<0, 0, 2>::fn;
}

template <int CIN_T, int COUT_T, int S>
struct PickDgrad { static constexpr Launch fn = launch_dgrad<CIN_T, COUT_T, S>; };
template <int CIN_T, int COUT_T, int S>
struct PickWgrad { static constexpr Launch fn = launch_wgrad<CIN_T, COUT_T, S>; };

}  // namespace
}  // namespace conv3x3

// dgrad (when need_dx), then wgrad's two passes, on one stream.  partial
// holds partial_rows rows of 9*cin*cout + cout floats.  Returns the first
// cudaError_t: 0 when every launch was accepted.
extern "C" int conv2d3x3_bwd_launch(
    const void* x, const void* w, const void* y, const void* g, void* dx,
    void* dw, void* db, void* partial, int partial_rows, int n, int h, int wd,
    int cin, int cout, int ho, int wo, int stride, int pad_top, int pad_left,
    int relu, int need_dx, int device, void* stream) {
  using namespace conv3x3;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cin < 1 || cin > kMaxCin || cout < 1 || cout > kMaxCout ||
      (stride != 1 && stride != 2) || n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{static_cast<const float*>(x), static_cast<const float*>(w),
                  static_cast<const float*>(y), static_cast<const float*>(g),
                  static_cast<float*>(dx), static_cast<float*>(dw),
                  static_cast<float*>(db), static_cast<float*>(partial),
                  partial_rows, n, h, wd, cin, cout, ho, wo, pad_top, pad_left, relu,
                  static_cast<cudaStream_t>(stream)};
  if (need_dx) {
    err = pick<PickDgrad>(cin, cout, stride, false)(a);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(pick<PickWgrad>(cin, cout, stride, true)(a));
}

extern "C" const char* conv2d3x3_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
