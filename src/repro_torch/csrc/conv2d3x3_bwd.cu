// Backward of the 3x3 convolution of conv2d3x3.cu, for Hopper: the input
// gradient (dgrad) and the weight and bias gradients (wgrad) in one launch.
//
// Completes the port of the Pallas TPU kernel
// src/repro/kernels/conv2d3x3.py::conv2d3x3, whose gradient the JAX package
// takes by XLA's autodiff of the same nine-tap sum
// (src/repro/core/skipping_dnn.py::_conv_taps).  Both parts read the
// forward's saved output y and apply the ReLU mask g' = (y > 0) ? g : 0
// while they read g: no separate mask pass.
//
//   dx[n,ih,iw,ci] = sum_{dy,dx,co} g'[n,oh,ow,co] * w[dy,dx,ci,co]
//                    over oh*s + dy - pad_top = ih, ow*s + dx - pad_left = iw
//   dw[dy,dx,ci,co] = sum_{n,oh,ow} xpad[n, oh*s+dy, ow*s+dx, ci] * g'[n,oh,ow,co]
//   db[co]          = sum_{n,oh,ow} g'[n,oh,ow,co]
//
// Bound: memory traffic.  A call reads x (4*Cin bytes a pixel) and g, y
// (8*Cout bytes an output) once and writes dx once; the multiply-adds are
// far below the card's ratio of operations to bytes.
//
// One launch a call where it pays.  The grid's first nd blocks are dgrad
// blocks (3/8 of those the SMs hold), the rest wgrad blocks; both kinds
// are resident at once (the grid never exceeds the blocks the SMs hold),
// so the dgrad stores and the wgrad loads overlap, and a small layer costs
// about one launch.  A kernel's registers and shared memory are those of
// its hungriest role: where a wgrad block fills an SM (the stride-2 layers:
// 144 sums a thread, or three stages of 64-94 KB), dgrad in that grid
// would walk many tiles at eight warps an SM.  Where it would walk more
// than two, dgrad is a launch of its own, one tile a block with its own
// registers, before the wgrad launch: two launches a call (down1-down3).
//
// dgrad is a gather, not a scatter.  Each dgrad block of the fused launch
// walks dx tiles (8x64 pixels) in a fixed order, persistent: while it sums
// one tile, the next two tiles' (8/s+2) x (64/s+2) windows of g and y are
// in flight (cp.async, zeros outside the output); a block of the
// stand-alone launch stages its one tile's window and sums it, with the
// same per-tile code.  The weights are staged once a block, into registers
// where a thread's share is small (conv_out: 36 floats), else into shared
// memory as [tap][co][ci].  At stride 1 a thread sums one pixel
// and four of its channels, so a warp's 16-byte stores of dx are one
// contiguous run; at stride 2 it sums two neighbouring pixels, whose taps
// are picked by the parity of ih + pad_top - dy (XLA's pads are asymmetric,
// lo=0 hi=1 on even sizes); a warp is one row of the tile, so it never
// diverges.  Each element sums in the fixed order (dy, dx, co ascending).
//
// wgrad reduces up to N*Ho*Wo = 2.6M terms into 9*Cin*Cout + Cout sums,
// deterministically and without atomics on the data:
//  * each wgrad block walks output tiles (16x64 at stride 1, 8x64 at
//    stride 2) in a fixed order with a ring of 2 or 3 stages (x halo, g,
//    y) in flight;
//  * a thread takes a run of 4 (stride 1) or 2 (stride 2) neighbouring
//    outputs of one row and reads each staged input pixel of its window
//    once, for every tap it meets (a sliding window in registers), not once
//    per tap: at stride 1 that is 18 pixel reads for 4 outputs, not 36;
//  * each thread keeps its partial sums in registers over all its tiles:
//    all 9*Cin*Cout where they fit, else the taps of one row (the block's
//    tap group);
//  * at the end a warp folds its 32 lanes with a transposing butterfly of
//    shuffles (each step halves the values a lane holds: K shuffles for K
//    sums, not 5K), the block adds its 8 warps in order, and writes one row
//    of partial sums;
//  * the last wgrad block to finish (a ticket: __threadfence, then an
//    atomicInc that wraps the counter back to 0 for the next call) adds the
//    rows in row order, so the bytes do not depend on which block is last.
// So the sums run in one order for given shapes, whatever the timing: two
// calls give the same bytes.  The ticket counter changes only inside a
// running kernel: a launch the runtime refuses never starts and leaves it
// at 0, and a kernel that faults leaves the CUDA context unusable (a sticky
// error), so no later call reads a stale count.
//
// A grouped call (conv2d3x3_bwd_grouped_launch) takes F fields, each with
// its own weights: x, dx [F*N, H, W, Cin], y, g [F*N, Ho, Wo, Cout], w, dw
// [F, 3, 3, Cin, Cout], db [F, Cout], field-major.  blockIdx.y is the
// field (the stand-alone dgrad launch takes its z over all fields' images,
// each block the weights of its image's field); each field has its own rows of partial sums and its own
// ticket, which its last wgrad block wraps back to 0.  A field's blocks,
// their partition of the work and the order of every sum are those of a
// single-field call on that field's slices, so field f's gradients equal
// that call's byte for byte; the single-field entry is the grouped one at
// F = 1.

#include "conv2d3x3_common.cuh"

namespace conv3x3 {
namespace {

// The grid is sized for kSMs SMs of an H100 (a constant, so that the order
// of the sums depends on the shapes only); kWgradRows bounds the rows of
// partial sums.
constexpr int kSMs = 132;
constexpr int kWgradRows = 2 * kSMs;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemPerSM = 233472;      // bytes of shared memory an SM holds
constexpr int kSmemPerBlock = 232448;   // bytes a block may use

struct BwdArgs {
  const float *x, *w, *y, *g;
  float *dx, *dw, *db, *partial;
  unsigned* ticket;
  int n, h, wd, cin, cout, ho, wo, pad_top, pad_left, relu;
  int partial_rows;   // rows of partial sums a field owns
  int nd;    // dgrad blocks (0 without dx)
  int nw;    // wgrad blocks: slots * tap groups
  int kt4;   // floats a row of partials holds: 9*cin*cout + cout, rounded up to 4
};

// The arguments of field f of a grouped call: every pointer moved to that
// field's slice (32-bit offsets: the wrapper keeps each tensor under 2^31
// elements).
__device__ __forceinline__ BwdArgs field_args(const BwdArgs& a, int f) {
  BwdArgs b = a;
  const int xs = a.n * a.h * a.wd * a.cin, gs = a.n * a.ho * a.wo * a.cout;
  const int ws = 9 * a.cin * a.cout;
  b.x += f * xs;
  b.y += f * gs;
  b.g += f * gs;
  if (b.dx != nullptr) b.dx += f * xs;
  b.w += f * ws;
  b.dw += f * ws;
  b.db += f * a.cout;
  b.partial += f * (a.partial_rows * a.kt4);
  b.ticket += f;
  return b;
}

template <int CIN_T, int COUT_T, int S>
struct DgradTile {
  static constexpr int MAXC = CIN_T > 0 ? CIN_T : kMaxCin;
  static constexpr int MAXO = COUT_T > 0 ? COUT_T : kMaxCout;
  static constexpr int VG = COUT_T > 0 ? vec_width<COUT_T>() : 1;
  static constexpr int PX = S;                           // pixels an item
  static constexpr int QW = CIN_T > 0 && CIN_T % 4 == 0 ? 4 : MAXC;  // channels an item
  static constexpr int NQ = MAXC / QW;                   // items a pixel run
  static constexpr int NS = 3;                           // stages in flight
  static constexpr int TH = 8, TW = 64;                  // dx tile
  static constexpr int RUNS = TW / PX;                   // pixel runs a tile row
  static constexpr int IPT = TH * RUNS * NQ / kThreads;  // items a thread a tile
  static constexpr int GR = TH / S + 2, GC = TW / S + 2; // staged g rows, columns
  static constexpr int GT = (GR * GC * MAXO + 3) & ~3;   // floats of a staged g (or y)
  // A thread's weights in registers where they are few.
  static constexpr bool WREG = CIN_T > 0 && COUT_T > 0 && 9 * COUT_T * QW <= 48;
  static constexpr int NWR = WREG ? 9 * MAXO * QW : 1;   // a thread's weights in registers
  // Shared memory: the weights, then the stages (one tile a block needs
  // only the first).
  static constexpr int WFLOATS = (9 * MAXC * MAXO + 3) & ~3;
  static constexpr int FLOATS = WFLOATS + NS * 2 * GT;
  static constexpr int FLOATS_ONE = WFLOATS + 2 * GT;
  static_assert(TH * RUNS * NQ % kThreads == 0, "items do not fill the threads");
};

template <int CIN_T, int COUT_T, int S>
struct WgradTile {
  static constexpr int MAXC = CIN_T > 0 ? CIN_T : kMaxCin;
  static constexpr int MAXO = COUT_T > 0 ? COUT_T : kMaxCout;
  static constexpr int VX = CIN_T > 0 ? vec_width<CIN_T>() : 1;
  static constexpr int VG = COUT_T > 0 ? vec_width<COUT_T>() : 1;
  static constexpr int PW = CIN_T > 0 ? (S == 1 ? 4 : 2) : (S == 1 ? 2 : 1);  // outputs a run
  static constexpr int TW = 64;                          // tile columns
  static constexpr int SEGS = TW / PW;                   // runs a tile row
  static constexpr int TH = kThreads / SEGS;             // tile rows
  static constexpr int HR = (TH - 1) * S + 3;            // staged x rows
  static constexpr int HC = (TW - 1) * S + 3;            // staged x columns
  static constexpr int NP = (PW - 1) * S + 3;            // input pixels of a run's window
  // Floats of a staged g (or y) tile, skewed (skew()) like the x rows: a
  // thread reads a run of PW*Cout floats, and neighbouring runs then fall
  // on different banks.
  static constexpr int GT = (skew(TH * TW * MAXO - 1) + 1 + 3) & ~3;
  // Taps a block sums: all nine where their 9*Cin*Cout partial sums fit in
  // a thread's registers, else one row of three, else one (Cin at run time).
  static constexpr int TPG = CIN_T == 0 ? 1
                             : 9 * MAXC * MAXO <= 150 ? 9
                             : 3 * MAXC * MAXO <= 150 ? 3 : 1;
  static constexpr int NG = 9 / TPG;                     // tap groups
  static constexpr int KA = TPG * MAXC * MAXO + MAXO;    // sums a thread keeps
  static constexpr int K = (KA + 31) & ~31;              // padded for the fold
  static constexpr int STAGE = CIN_T > 0 ? HR * skewed_row(HC * CIN_T) + 2 * GT : 0;
  static constexpr int STATIC_BYTES = 4 * kWarps * K + 16 * kThreads + 64;
  // Two blocks an SM where their registers and two stages each allow it;
  // else one block with three stages where they fit.
  static constexpr bool TWO = CIN_T > 0 && KA <= 80 &&
      2 * (8 * STAGE + STATIC_BYTES + 1024) <= kSmemPerSM;
  static constexpr int BPS = TWO ? 2 : 1;
  static constexpr int NSTAGE =
      !TWO && CIN_T > 0 && 12 * STAGE + STATIC_BYTES <= kSmemPerBlock ? 3 : 2;
};

template <int CIN_T, int COUT_T, int S>
int wgrad_floats(int cin) {
  using T = WgradTile<CIN_T, COUT_T, S>;
  return T::NSTAGE * (T::HR * skewed_row(T::HC * cin) + 2 * T::GT);
}

// Read the N floats of an unskewed shared run starting at p (n of them at
// run time where VEC is false), with the widest loads N allows where VEC
// says the run starts at a multiple of that width.
template <bool VEC, int N>
__device__ __forceinline__ void load_vec(const float* p, int n, float (&out)[N]) {
  if constexpr (VEC && N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      out[i] = v.x; out[i + 1] = v.y; out[i + 2] = v.z; out[i + 3] = v.w;
    }
  } else if constexpr (VEC && N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + i);
      out[i] = v.x; out[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (VEC || i < n) out[i] = p[i];
  }
}

// ---- dgrad: the pieces of one dx tile, then its two frames ----

// Start the copies of the g (and y) window of the dx tile at (img, ih0,
// iw0) into buf.  Every tap that lands on the tile reads output rows
// oh_lo..oh_lo+GR-1 (and columns likewise): ih0 is a multiple of 8 and
// pad_top is 1 at stride 1, 0 or 1 at stride 2.
template <int CIN_T, int COUT_T, int S>
__device__ __forceinline__ void dgrad_stage(const BwdArgs& a, int img, int ih0,
                                            int iw0, float* buf) {
  using T = DgradTile<CIN_T, COUT_T, S>;
  constexpr int V = T::VG;
  const int cout = COUT_T > 0 ? COUT_T : a.cout;
  const int gs = T::GC * cout;                           // floats a staged row
  const int oh_lo = ih0 / S - 1, ow_lo = iw0 / S - 1;
  const int off = img * (a.ho * a.wo * cout);
  const int row_chunks = gs / V;
  for (int c = threadIdx.x; c < T::GR * row_chunks; c += kThreads) {
    const int r = c / row_chunks;
    const int f = (c - r * row_chunks) * V;
    const int col = f / cout;
    const int oh = oh_lo + r, ow = ow_lo + col;
    const bool in = static_cast<unsigned>(oh) < static_cast<unsigned>(a.ho) &&
                    static_cast<unsigned>(ow) < static_cast<unsigned>(a.wo);
    const int src = off + (oh * a.wo + ow) * cout + (f - col * cout);
    cp_async_zfill<4 * V>(buf + r * gs + f, in ? a.g + src : a.g, in);
    if (a.relu)
      cp_async_zfill<4 * V>(buf + T::GT + r * gs + f, in ? a.y + src : a.y, in);
  }
}

// The weights w, once a block: a thread's share into registers where it is
// small (wr), else all of them into shared memory as [tap][co][ci] (sw).
template <int CIN_T, int COUT_T, int S>
__device__ __forceinline__ void dgrad_weights(const BwdArgs& a, const float* w,
                                              float* sw,
                                              float (&wr)[DgradTile<CIN_T, COUT_T, S>::NWR]) {
  using T = DgradTile<CIN_T, COUT_T, S>;
  constexpr int MAXO = T::MAXO, QW = T::QW;
  const int cin = CIN_T > 0 ? CIN_T : a.cin;
  const int cout = COUT_T > 0 ? COUT_T : a.cout;
  if constexpr (T::WREG) {
    const int q = threadIdx.x % T::NQ;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int co = 0; co < MAXO; ++co)
#pragma unroll
        for (int k = 0; k < QW; ++k)
          wr[(tap * MAXO + co) * QW + k] = w[(tap * cin + q * QW + k) * cout + co];
  } else {
    for (int i = threadIdx.x; i < 9 * cin * cout; i += kThreads) {
      const int tap = i / (cin * cout), rem = i - tap * (cin * cout);
      const int ci = rem / cout, co = rem - ci * cout;
      sw[(tap * cout + co) * cin + ci] = w[i];
    }
  }
}

// Sum and store the dx tile at (img, ih0, iw0) from its staged window sg
// (g, then y at sg + GT).
template <int CIN_T, int COUT_T, int S>
__device__ __forceinline__ void dgrad_tile(
    const BwdArgs& a, const float* sg, const float* sw,
    const float (&wr)[DgradTile<CIN_T, COUT_T, S>::NWR], int img, int ih0, int iw0) {
  using T = DgradTile<CIN_T, COUT_T, S>;
  constexpr int MAXO = T::MAXO, QW = T::QW;
  const int cin = CIN_T > 0 ? CIN_T : a.cin;
  const int cout = COUT_T > 0 ? COUT_T : a.cout;
  const int gs = T::GC * cout;
  const int tid = threadIdx.x;
  const int q = tid % T::NQ;                             // this thread's channels: q*QW...
  const float* sy = sg + T::GT;
  const int oh_lo = ih0 / S - 1, ow_lo = iw0 / S - 1;
#pragma unroll
  for (int it = 0; it < T::IPT; ++it) {
    const int rest = (it * kThreads + tid) / T::NQ;
    const int run = rest % T::RUNS, r = rest / T::RUNS;
    const int ih = ih0 + r, iw = iw0 + run * T::PX;
    float acc[T::PX][QW];
#pragma unroll
    for (int j = 0; j < T::PX; ++j)
#pragma unroll
      for (int k = 0; k < QW; ++k) acc[j][k] = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int tr = ih + a.pad_top - dy;   // oh * S where the tap lands
      if (S == 2 && (tr & 1)) continue;
      const float* grow = sg + (tr / S - oh_lo) * gs;
      const float* yrow = sy + (tr / S - oh_lo) * gs;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
        for (int j = 0; j < T::PX; ++j) {
          const int u = iw + j + a.pad_left - dx;   // ow * S where the tap lands
          if (S == 2 && (u & 1)) continue;
          const int col = (u / S - ow_lo) * cout;
#pragma unroll
          for (int co = 0; co < cout; ++co) {
            float gv = grow[col + co];
            if (a.relu && !(yrow[col + co] > 0.f)) gv = 0.f;
            float wv[QW];
            if constexpr (T::WREG) {
#pragma unroll
              for (int k = 0; k < QW; ++k) wv[k] = wr[((dy * 3 + dx) * MAXO + co) * QW + k];
            } else {
              load_vec<(CIN_T > 0)>(sw + ((dy * 3 + dx) * cout + co) * cin + q * QW,
                                    cin, wv);
            }
#pragma unroll
            for (int k = 0; k < QW; ++k) {
              if (CIN_T == 0 && k >= cin) break;
              acc[j][k] = fmaf(gv, wv[k], acc[j][k]);
            }
          }
        }
      }
    }
    if (ih < a.h && iw < a.wd) {
      float* dp = a.dx + ((img * a.h + ih) * a.wd + iw) * cin + q * QW;
      if (CIN_T > 0 && (T::PX == 1 || iw + T::PX <= a.wd)) {
        if constexpr (T::PX == 1) {
          store_run(dp, acc[0]);
        } else {
          float out[T::PX * QW];
#pragma unroll
          for (int j = 0; j < T::PX; ++j)
#pragma unroll
            for (int k = 0; k < QW; ++k) out[j * QW + k] = acc[j][k];
          store_run(dp, out);   // QW = cin: the run's pixels are contiguous
        }
      } else {
#pragma unroll
        for (int j = 0; j < T::PX; ++j) {
          if (iw + j >= a.wd) break;
#pragma unroll
          for (int k = 0; k < QW; ++k) {
            if (k >= cin) break;
            dp[j * cin + k] = acc[j][k];
          }
        }
      }
    }
  }
}

// dgrad in the fused launch: block b of nd walks dx tiles b, b + nd, ...
// with NS stages in flight.
template <int CIN_T, int COUT_T, int S>
__device__ __forceinline__ void dgrad_role(const BwdArgs& a, float* smem) {
  using T = DgradTile<CIN_T, COUT_T, S>;
  float* sw = smem;
  smem += T::WFLOATS;
  const int tiles_x = (a.wd + T::TW - 1) / T::TW;
  const int tiles_y = (a.h + T::TH - 1) / T::TH;
  const int tiles = a.n * tiles_y * tiles_x;
  auto origin = [&](int t, int& img, int& ih0, int& iw0) {
    img = t / (tiles_y * tiles_x);
    const int rem = t - img * (tiles_y * tiles_x);
    ih0 = rem / tiles_x * T::TH;
    iw0 = (rem - rem / tiles_x * tiles_x) * T::TW;
  };
  auto stage = [&](int t, float* buf) {
    int img, ih0, iw0;
    origin(t, img, ih0, iw0);
    dgrad_stage<CIN_T, COUT_T, S>(a, img, ih0, iw0, buf);
  };

  const int nd = a.nd;
#pragma unroll
  for (int s = 0; s < T::NS - 1; ++s) {
    if (blockIdx.x + s * nd < tiles) stage(blockIdx.x + s * nd, smem + s * 2 * T::GT);
    cp_async_commit();
  }
  float wr[T::NWR];   // while the first copies are in flight
  dgrad_weights<CIN_T, COUT_T, S>(a, a.w, sw, wr);

  int it_tile = 0;
  for (int t = blockIdx.x; t < tiles; t += nd, ++it_tile) {
    const int ahead = t + (T::NS - 1) * nd;
    if (ahead < tiles) stage(ahead, smem + ((it_tile + T::NS - 1) % T::NS) * 2 * T::GT);
    cp_async_commit();
    cp_async_wait<T::NS - 1>();
    __syncthreads();
    int img, ih0, iw0;
    origin(t, img, ih0, iw0);
    dgrad_tile<CIN_T, COUT_T, S>(a, smem + (it_tile % T::NS) * 2 * T::GT, sw, wr,
                                 img, ih0, iw0);
    __syncthreads();
  }
}

// Fold v[K] over the 32 lanes of a warp: each step sends half of the values
// a lane holds to its partner and adds the half it keeps, so after the five
// steps (M = 16, 8, 4, 2, 1) lane l holds the sums of entries
// l*K/32 ... l*K/32 + K/32 - 1 in v[0 .. K/32).  A fixed butterfly: the
// same order every call.
template <int HALF, int M, int K>
__device__ __forceinline__ void fold_lanes(float (&v)[K], int lane) {
  if constexpr (M > 0) {
    const bool up = lane & M;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float send = up ? v[i] : v[i + HALF];
      const float keep = up ? v[i + HALF] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
    }
    fold_lanes<HALF / 2, M / 2>(v, lane);
  }
}

// ---- wgrad: block wb of nw sums tap group wb % NG over tiles s, s + nws, ...
// (s = wb / NG), into row s of the partials; the last block adds the rows.
template <int CIN_T, int COUT_T, int S>
__device__ __forceinline__ void wgrad_role(const BwdArgs& a, float* smem, int wb) {
  using T = WgradTile<CIN_T, COUT_T, S>;
  constexpr int MAXC = T::MAXC, MAXO = T::MAXO, PW = T::PW, K = T::K;
  const int cin = CIN_T > 0 ? CIN_T : a.cin;
  const int cout = COUT_T > 0 ? COUT_T : a.cout;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rs = skewed_row(T::HC * cin);
  const int xs_floats = T::HR * rs;
  const int stage_floats = xs_floats + 2 * T::GT;
  const int group = wb % T::NG, slot = wb / T::NG;
  const int nws = a.nw / T::NG;
  __shared__ float red[kWarps][K];
  __shared__ float4 part[kThreads];
  __shared__ unsigned last;

  const int tiles_x = (a.wo + T::TW - 1) / T::TW;
  const int tiles_y = (a.ho + T::TH - 1) / T::TH;
  const int tiles = a.n * tiles_y * tiles_x;
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
    const int iy0 = oh0 * S - a.pad_top, ix0 = ow0 * S - a.pad_left;
    const float* xn = a.x + img * (a.h * a.wd * cin);
    const int row_chunks = T::HC * cin / T::VX;
    for (int c = tid; c < T::HR * row_chunks; c += kThreads) {
      const int r = c / row_chunks;
      const int f = (c - r * row_chunks) * T::VX;
      const int col = f / cin;
      const int iy = iy0 + r, ix = ix0 + col;
      const bool in = static_cast<unsigned>(iy) < static_cast<unsigned>(a.h) &&
                      static_cast<unsigned>(ix) < static_cast<unsigned>(a.wd);
      cp_async_zfill<4 * T::VX>(
          buf + r * rs + skew(f),
          in ? xn + (iy * a.wd + ix) * cin + (f - col * cin) : a.x, in);
    }
    float* sg = buf + xs_floats;
    const int g_chunks = T::TW * cout / T::VG;
    const int off = img * (a.ho * a.wo * cout);
    for (int c = tid; c < T::TH * g_chunks; c += kThreads) {
      const int r = c / g_chunks;
      const int f = (c - r * g_chunks) * T::VG;
      const int col = f / cout;
      const int oh = oh0 + r, ow = ow0 + col;
      const bool in = oh < a.ho && ow < a.wo;
      const int src = off + (oh * a.wo + ow) * cout + (f - col * cout);
      const int dst = skew(r * (T::TW * cout) + f);
      cp_async_zfill<4 * T::VG>(sg + dst, in ? a.g + src : a.g, in);
      if (a.relu) cp_async_zfill<4 * T::VG>(sg + T::GT + dst, in ? a.y + src : a.y, in);
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

  const int seg = tid % T::SEGS, row = tid / T::SEGS;
#pragma unroll
  for (int s = 0; s < T::NSTAGE - 1; ++s) {
    if (slot + s * nws < tiles) stage(slot + s * nws, smem + s * stage_floats);
    cp_async_commit();
  }
  int it = 0;
  for (int t = slot; t < tiles; t += nws, ++it) {
    const int ahead = t + (T::NSTAGE - 1) * nws;
    if (ahead < tiles) stage(ahead, smem + ((it + T::NSTAGE - 1) % T::NSTAGE) * stage_floats);
    cp_async_commit();
    cp_async_wait<T::NSTAGE - 1>();
    __syncthreads();

    const float* sx = smem + (it % T::NSTAGE) * stage_floats;
    const float* sg = sx + xs_floats;
    const float* sy = sg + T::GT;
    int img, oh0, ow0;
    origin(t, img, oh0, ow0);
    // g' of this thread's run of outputs; zero past the output's edge.
    float gv[PW][MAXO];
    const bool row_in = oh0 + row < a.ho;
    const int p0 = (row * T::TW + seg * PW) * cout;   // a multiple of 4 (Cout fixed)
    float graw[PW * MAXO], yraw[PW * MAXO];
    if constexpr (COUT_T > 0) {
      load_run(sg, p0, PW * cout, graw);
      if (a.relu) load_run(sy, p0, PW * cout, yraw);
    } else {
#pragma unroll
      for (int i = 0; i < PW * MAXO; ++i) {
        if (i >= PW * cout) break;
        graw[i] = sg[skew(p0 + i)];
        yraw[i] = a.relu ? sy[skew(p0 + i)] : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < PW; ++j) {
      const bool in = row_in && ow0 + seg * PW + j < a.wo;
#pragma unroll
      for (int co = 0; co < MAXO; ++co) {
        float v = 0.f;
        if (co < cout && in) {
          v = graw[j * cout + co];
          if (a.relu && !(yraw[j * cout + co] > 0.f)) v = 0.f;
        }
        gv[j][co] = v;
        dacc[co] += v;
      }
    }
    const int f0 = seg * PW * S * cin;   // this run's window in a staged row
    if constexpr (T::TPG == 1) {
      // One tap (Cin at run time): the pixel of each output.
      const int dy = group / 3, dx = group - 3 * (group / 3);
      const float* xrow = sx + (row * S + dy) * rs;
#pragma unroll
      for (int j = 0; j < PW; ++j) {
        float xv[MAXC];
        load_pixel<T::VX>(xrow, f0 + (j * S + dx) * cin, cin, xv);
#pragma unroll
        for (int ci = 0; ci < MAXC; ++ci) {
          if (ci >= cin) break;
#pragma unroll
          for (int co = 0; co < MAXO; ++co) {
            if (co >= cout) break;
            acc[0][ci][co] = fmaf(xv[ci], gv[j][co], acc[0][ci][co]);
          }
        }
      }
    } else {
      // Rows of taps: all three (TPG 9) or this group's (TPG 3).  Each
      // pixel of the run's window is read once and meets every tap that
      // lands on it.
#pragma unroll
      for (int d = 0; d < T::TPG / 3; ++d) {
        const int dy = T::TPG == 9 ? d : group;
        const float* xrow = sx + (row * S + dy) * rs;
        constexpr bool RUN = T::NP * MAXC <= 32;   // the whole window at once
        float xw[RUN ? T::NP * MAXC : 1];
        if constexpr (RUN) load_run(xrow, f0, T::NP * cin, xw);
#pragma unroll
        for (int p = 0; p < T::NP; ++p) {
          float xv[MAXC];
          if constexpr (RUN) {
#pragma unroll
            for (int ci = 0; ci < MAXC; ++ci) xv[ci] = xw[p * MAXC + ci];
          } else {
            load_pixel<T::VX>(xrow, f0 + p * cin, cin, xv);
          }
#pragma unroll
          for (int j = 0; j < PW; ++j) {
            const int dx = p - j * S;
            if (dx < 0 || dx > 2) continue;
            const int tt = d * 3 + dx;
#pragma unroll
            for (int ci = 0; ci < MAXC; ++ci)
#pragma unroll
              for (int co = 0; co < MAXO; ++co)
                acc[tt][ci][co] = fmaf(xv[ci], gv[j][co], acc[tt][ci][co]);
          }
        }
      }
    }
    __syncthreads();
  }

  // Fold: lanes (a butterfly), then the warps in order, into row `slot`.
  float v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = 0.f;
#pragma unroll
  for (int tt = 0; tt < T::TPG; ++tt)
#pragma unroll
    for (int ci = 0; ci < MAXC; ++ci)
#pragma unroll
      for (int co = 0; co < MAXO; ++co) v[(tt * MAXC + ci) * MAXO + co] = acc[tt][ci][co];
#pragma unroll
  for (int co = 0; co < MAXO; ++co) v[T::TPG * MAXC * MAXO + co] = dacc[co];
  fold_lanes<K / 2, 16>(v, lane);
#pragma unroll
  for (int i = 0; i < K / 32; ++i) red[warp][lane * (K / 32) + i] = v[i];
  __syncthreads();

  const int kw = 9 * cin * cout;        // weight sums; the bias sums follow
  float* out = a.partial + slot * a.kt4;
  for (int k = tid; k < T::KA; k += kThreads) {
    int glob = -1;
    if (k < T::TPG * MAXC * MAXO) {
      const int tt = k / (MAXC * MAXO), rem = k - tt * (MAXC * MAXO);
      const int ci = rem / MAXO, co = rem - ci * MAXO;
      if (ci < cin && co < cout) glob = (group * T::TPG + tt) * cin * cout + ci * cout + co;
    } else if (group == 0 && k - T::TPG * MAXC * MAXO < cout) {
      glob = kw + (k - T::TPG * MAXC * MAXO);
    }
    if (glob < 0) continue;
    float s = red[0][k];
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi) s += red[wi][k];
    out[glob] = s;
  }

  // The ticket: the last block to finish adds the rows.
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicInc(a.ticket, a.nw - 1) == static_cast<unsigned>(a.nw - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int q4 = a.kt4 / 4;
  const int kt = kw + cout;
  const float4* rows = reinterpret_cast<const float4*>(a.partial);
  for (int q0 = 0; q0 < q4; q0 += kThreads) {
    const int qc = min(kThreads, q4 - q0);
    const int groups = kThreads / qc;     // row groups, each adding rows rg, rg + groups, ...
    const int q = tid % qc, rg = tid / qc;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rg < groups) {
#pragma unroll 8
      for (int r = rg; r < nws; r += groups) {
        const float4 u = __ldcg(rows + r * q4 + q0 + q);
        s.x += u.x; s.y += u.y; s.z += u.z; s.w += u.w;
      }
    }
    part[tid] = s;
    __syncthreads();
    if (tid < qc) {
      float4 t = part[tid];
      for (int gi = 1; gi < groups; ++gi) {
        const float4 u = part[gi * qc + tid];
        t.x += u.x; t.y += u.y; t.z += u.z; t.w += u.w;
      }
      const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * (q0 + tid) + e;
        if (k < kw) a.dw[k] = tv[e];
        else if (k < kt) a.db[k - kw] = tv[e];
      }
    }
    __syncthreads();
  }
}

// dgrad alone, where it does not ride in the wgrad launch (launch_bwd):
// one tile a block, taken from a 3-D grid (x tile, y tile, image), staged
// once.  Its own registers, so many blocks an SM.  No walk, no ring and no
// division of a linear tile index: that frame took 48-51 registers a
// thread here, not 32-35, and made this launch 9-33% slower at down1-down3
// on an H100.
template <int CIN_T, int COUT_T, int S>
__global__ void __launch_bounds__(kThreads)
conv3x3_bwd_dgrad_kernel(const BwdArgs a) {
  using T = DgradTile<CIN_T, COUT_T, S>;
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  float* sg = sw + T::WFLOATS;
  // g, y and dx are field-major, so the image z of all fields' images
  // indexes them as it is; only the weights are the field's own.
  const int img = blockIdx.z, ih0 = blockIdx.y * T::TH, iw0 = blockIdx.x * T::TW;
  dgrad_stage<CIN_T, COUT_T, S>(a, img, ih0, iw0, sg);
  cp_async_commit();
  float wr[T::NWR];
  const int cin = CIN_T > 0 ? CIN_T : a.cin, cout = COUT_T > 0 ? COUT_T : a.cout;
  dgrad_weights<CIN_T, COUT_T, S>(a, a.w + img / a.n * (9 * cin * cout), sw, wr);
  cp_async_wait<0>();
  __syncthreads();
  dgrad_tile<CIN_T, COUT_T, S>(a, sg, sw, wr, img, ih0, iw0);
}

template <int CIN_T, int COUT_T, int S>
__global__ void __launch_bounds__(kThreads, (WgradTile<CIN_T, COUT_T, S>::BPS))
conv3x3_bwd_kernel(const BwdArgs args) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const BwdArgs a = field_args(args, blockIdx.y);
  if (static_cast<int>(blockIdx.x) < a.nd) {
    dgrad_role<CIN_T, COUT_T, S>(a, smem);
  } else {
    wgrad_role<CIN_T, COUT_T, S>(a, smem, blockIdx.x - a.nd);
  }
}

// Size the grid to the work: 3/8 of the resident blocks to dgrad (at most
// one a dx tile), the rest to wgrad's tap groups (at most one slot a tile).
// Where the wgrad blocks need a whole SM each (BPS 1: their registers) and
// the dx tiles are more than twice the dgrad blocks, dgrad in the same
// grid would walk tile after tile at one block an SM; there it is a launch
// of its own before wgrad's, one tile a block (two launches a call; its
// grid's z is the image, so at most 65535 images over all fields).
template <int CIN_T, int COUT_T, int S>
int dgrad_tiles(int n, int h, int wd) {
  using D = DgradTile<CIN_T, COUT_T, S>;
  return n * ((h + D::TH - 1) / D::TH) * ((wd + D::TW - 1) / D::TW);
}

template <int CIN_T, int COUT_T, int S>
constexpr int dgrad_blocks() { return kSMs * WgradTile<CIN_T, COUT_T, S>::BPS * 3 / 8; }

// Kernels a call launches: 2 where dgrad is a launch of its own, else 1.
template <int CIN_T, int COUT_T, int S>
int bwd_kernels(int n, int h, int wd, int need_dx) {
  return need_dx && WgradTile<CIN_T, COUT_T, S>::BPS == 1 && n <= 65535 &&
                 dgrad_tiles<CIN_T, COUT_T, S>(n, h, wd) > 2 * dgrad_blocks<CIN_T, COUT_T, S>()
             ? 2 : 1;
}

template <int CIN_T, int COUT_T, int S>
cudaError_t launch_bwd(BwdArgs a, int need_dx, int fields,
                       cudaStream_t stream) {
  using D = DgradTile<CIN_T, COUT_T, S>;
  using W = WgradTile<CIN_T, COUT_T, S>;
  static int granted = 48 * 1024, granted_d = 48 * 1024;
  const int cap = kSMs * W::BPS;
  const int dtiles = dgrad_tiles<CIN_T, COUT_T, S>(a.n, a.h, a.wd);
  const int dblocks = dgrad_blocks<CIN_T, COUT_T, S>();
  a.nd = need_dx ? (dtiles < dblocks ? dtiles : dblocks) : 0;
  if (bwd_kernels<CIN_T, COUT_T, S>(a.n, a.h, a.wd, need_dx) == 2) {
    if (a.n > 65535 / fields) return cudaErrorInvalidValue;
    cudaError_t err = allow_smem(conv3x3_bwd_dgrad_kernel<CIN_T, COUT_T, S>,
                                 4 * D::FLOATS_ONE, granted_d);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.wd + D::TW - 1) / D::TW, (a.h + D::TH - 1) / D::TH,
                    fields * a.n);
    conv3x3_bwd_dgrad_kernel<CIN_T, COUT_T, S><<<grid, kThreads, 4 * D::FLOATS_ONE, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    a.nd = 0;
  }
  const int wtiles = a.n * ((a.ho + W::TH - 1) / W::TH) * ((a.wo + W::TW - 1) / W::TW);
  int nws = (cap - a.nd) / W::NG;
  if (nws > kWgradRows) nws = kWgradRows;
  if (nws > wtiles) nws = wtiles;
  if (nws < 1 || nws > a.partial_rows) return cudaErrorInvalidValue;
  a.nw = nws * W::NG;
  const int wf = wgrad_floats<CIN_T, COUT_T, S>(a.cin);
  const int smem = 4 * (wf > D::FLOATS ? wf : D::FLOATS);
  cudaError_t err = allow_smem(conv3x3_bwd_kernel<CIN_T, COUT_T, S>, smem, granted);
  if (err != cudaSuccess) return err;
  conv3x3_bwd_kernel<CIN_T, COUT_T, S>
      <<<dim3(a.nd + a.nw, fields), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// A shape's launch and its count of kernels.
struct Plan {
  cudaError_t (*launch)(BwdArgs, int, int, cudaStream_t);
  int (*kernels)(int, int, int, int);
};

template <int CIN_T, int COUT_T, int S>
constexpr Plan plan() { return {launch_bwd<CIN_T, COUT_T, S>, bwd_kernels<CIN_T, COUT_T, S>}; }

// The enhancer's layers (down1-4, conv_out at c_in 8 and 4, conv_in at
// c_in 1-3), then Cin and Cout at run time.
Plan pick(int cin, int cout, int stride) {
  if (stride == 1) {
    if (cout == 4 && cin >= 1 && cin <= 3)
      return cin == 1 ? plan<1, 4, 1>() : cin == 2 ? plan<2, 4, 1>() : plan<3, 4, 1>();
    if (cout == 1 && cin == 8) return plan<8, 1, 1>();
    if (cout == 1 && cin == 4) return plan<4, 1, 1>();
  } else {
    if (cin == 4 && cout == 4) return plan<4, 4, 2>();
    if (cin == 4 && cout == 6) return plan<4, 6, 2>();
    if (cin == 6 && cout == 6) return plan<6, 6, 2>();
    if (cin == 6 && cout == 8) return plan<6, 8, 2>();
  }
  return stride == 1 ? plan<0, 0, 1>() : plan<0, 0, 2>();
}

}  // namespace
}  // namespace conv3x3

// dgrad (when need_dx) and wgrad of F fields, in one launch (two where
// dgrad runs apart), on one stream.  partial holds F blocks of partial_rows
// rows of kt4 floats (9*cin*cout + cout rounded up to a multiple of 4);
// ticket holds F counters that are 0 between calls (the kernel leaves them
// so).  n is the images of one field.  Returns a cudaError_t: 0 when the
// launch was accepted.
extern "C" int conv2d3x3_bwd_grouped_launch(
    const void* x, const void* w, const void* y, const void* g, void* dx,
    void* dw, void* db, void* partial, void* ticket, int partial_rows,
    int fields, int n, int h, int wd, int cin, int cout, int ho, int wo,
    int stride, int pad_top, int pad_left, int relu, int need_dx, int device,
    void* stream) {
  using namespace conv3x3;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cin < 1 || cin > kMaxCin || cout < 1 || cout > kMaxCout ||
      (stride != 1 && stride != 2) || fields < 1 || fields > 65535 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{static_cast<const float*>(x), static_cast<const float*>(w),
            static_cast<const float*>(y), static_cast<const float*>(g),
            static_cast<float*>(dx), static_cast<float*>(dw),
            static_cast<float*>(db), static_cast<float*>(partial),
            static_cast<unsigned*>(ticket), n, h, wd, cin, cout, ho, wo,
            pad_top, pad_left, relu, partial_rows, 0, 0,
            (9 * cin * cout + cout + 3) & ~3};
  return static_cast<int>(pick(cin, cout, stride).launch(
      a, need_dx, fields, static_cast<cudaStream_t>(stream)));
}

// One field: the grouped launch at F = 1.
extern "C" int conv2d3x3_bwd_launch(
    const void* x, const void* w, const void* y, const void* g, void* dx,
    void* dw, void* db, void* partial, void* ticket, int partial_rows, int n,
    int h, int wd, int cin, int cout, int ho, int wo, int stride, int pad_top,
    int pad_left, int relu, int need_dx, int device, void* stream) {
  return conv2d3x3_bwd_grouped_launch(x, w, y, g, dx, dw, db, partial, ticket,
                                      partial_rows, 1, n, h, wd, cin, cout, ho,
                                      wo, stride, pad_top, pad_left, relu,
                                      need_dx, device, stream);
}

// Kernels one call of conv2d3x3_bwd_launch launches at these shapes (1 or
// 2); 0 for shapes it refuses.
extern "C" int conv2d3x3_bwd_kernels(int n, int h, int wd, int cin, int cout,
                                     int stride, int need_dx) {
  using namespace conv3x3;
  if (cin < 1 || cin > kMaxCin || cout < 1 || cout > kMaxCout ||
      (stride != 1 && stride != 2))
    return 0;
  return pick(cin, cout, stride).kernels(n, h, wd, need_dx);
}

extern "C" const char* conv2d3x3_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
