// Dual-quantization Lorenzo predictor (cuSZ-style), encode and decode, for
// Hopper.
//
// Replaces the Pallas TPU kernels src/repro/kernels/lorenzo3d.py::
// lorenzo3d_fwd (body _fwd_kernel) and ::lorenzo3d_inv (body _inv_kernel),
// but matches the eager reference that writes archives, not the Pallas
// bodies: repro.compressors.szlike._lorenzo_encode_core for the encode and
// lorenzo_undelta + q * (2 eb) for the decode.  Three differences from the
// Pallas forward body follow from that: the quantizer divides by the step
// (the body multiplies by 1/step, which rounds differently on lattice
// boundaries), escapes are zeroed before the delta, and the input stays
// float64 (the Pallas wrapper narrows it to float32).
//
// Both kernels take a stacked group x[F][D][H][W] (a 2-D field is D = 1)
// with one bound eb[f] per field, step = 2 eb[f].
//
// lorenzo3d_fwd, per point:
//   q      = rint(x / step)                       (round half to even)
//   unpred = |q| >= CODE_CAP  or  x not finite
//   qi     = unpred ? 0 : int(q)
//   r      = qi * step
//   unpred = unpred  or  |cast_out(r) - x| > eb   (the output-dtype check)
//   qi     = unpred ? 0 : qi;   rec = unpred ? x : r
//   delta  = the 8-point first-order Lorenzo delta of qi, zero outside.
// lorenzo3d_inv: q = inclusive prefix sums of delta over x, y and z;
//   rec = q * step.
//
// Every float64 divide, multiply and subtract is an explicit round-to-
// nearest intrinsic (__ddiv_rn, __dmul_rn, __dsub_rn) and the cast check a
// __double2float_rn, so nvcc cannot contract or reassociate them: a code
// that differs in one point changes the archive's bytes.
//
// Bounds: both are memory-bound.  The forward reads 8 bytes and writes
// 4 + 1 + 8 per point (0.47 ms for 3 x 100 x 500 x 500 at 3.35 TB/s); the
// inverse reads 4 and writes 8 (0.27 ms).
//
// Forward design: one block per (field, 8-row, 32-column) tile walks z.
// The tile's escaped qi, with its -1 halo row and column, lives in shared
// memory for the current and the previous plane (three rotating buffers,
// so one barrier per plane suffices); this loop inside the block takes the
// place of the Pallas grid's sequential z-carry.  Each x is read once
// (the halo adds one row and one column of reads per tile), and delta,
// unpred and rec are written in the same pass.  The next plane's x is
// loaded before the current one is differenced.
//
// Inverse design: blocks run in no order, so the TPU's carried plane
// becomes a second pass.  Pass 1: one block per (field, z) plane scans each
// row along x (warp shuffles, then the warp totals in shared memory) and
// adds it to a running column sum in shared memory, writing the 2-D prefix
// to an int32 scratch plane.  Pass 2: one thread per (field, y, x) walks z
// with a register carry and writes rec.  The scratch costs 8 bytes a point
// of traffic beyond the bound.  Integer sums wrap (unsigned arithmetic),
// which is exact for every archive the encoder writes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCodeCap = 1 << 15;
constexpr int kTX = 32;
constexpr int kTY = 8;
constexpr int kHalo = kTX + 1 + kTY;   // the -1 row with its corner, the -1 column
constexpr int kScanThreads = 512;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kZThreads = 256;

template <bool kF32>
__device__ __forceinline__ double cast_back(double v) {
  if (kF32) return (double)__double2float_rn(v);
  return v;
}

// The escaped code of one point; writes unpred and rec when asked.
template <bool kF32>
__device__ __forceinline__ int quantize(double xv, double step, double eb,
                                        bool* unpred_out, double* rec_out) {
  const double q = rint(__ddiv_rn(xv, step));
  bool un = fabs(q) >= (double)kCodeCap || !isfinite(xv);
  int qi = un ? 0 : (int)q;
  const double r = __dmul_rn((double)qi, step);
  un = un || fabs(__dsub_rn(cast_back<kF32>(r), xv)) > eb;
  *unpred_out = un;
  *rec_out = un ? xv : r;
  return un ? 0 : qi;
}

template <bool kF32>
__global__ void __launch_bounds__(kTX * kTY)
lorenzo3d_fwd_kernel(const double* __restrict__ x, const double* __restrict__ eb,
                     int D, int H, int W, int* __restrict__ delta,
                     uint8_t* __restrict__ unpred, double* __restrict__ rec) {
  __shared__ int tile[3][kTY + 1][kTX + 1];
  const int f = blockIdx.z;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int gx = x0 + tx, gy = y0 + ty;
  const bool inside = gx < W && gy < H;
  const double e = eb[f];
  const double step = __dmul_rn(2.0, e);
  const long long plane = (long long)H * W;
  const double* xf = x + (long long)f * D * plane;

  // Halo entry of this thread, if any: (hj, hi) in the tile, (hy, hx) in the field.
  int hj = 0, hi = 0;
  if (tid <= kTX) {
    hi = tid;
  } else if (tid < kHalo) {
    hj = tid - kTX;
  }
  const int hy = y0 - 1 + hj, hx = x0 - 1 + hi;
  const bool halo = tid < kHalo && hy >= 0 && hx >= 0 && hy < H && hx < W;

  // Plane z = -1 is zero.
  for (int i = tid; i < (kTY + 1) * (kTX + 1); i += kTX * kTY)
    (&tile[2][0][0])[i] = 0;

  const long long own = (long long)gy * W + gx;
  const long long hown = (long long)hy * W + hx;
  double xn = inside ? xf[own] : 0.0;
  double hn = halo ? xf[hown] : 0.0;
  for (int z = 0; z < D; ++z) {
    const double xv = xn, hv = hn;
    if (z + 1 < D) {
      if (inside) xn = xf[(long long)(z + 1) * plane + own];
      if (halo) hn = xf[(long long)(z + 1) * plane + hown];
    }
    const int cb = z % 3, pb = (z + 2) % 3;
    bool un;
    double r;
    int qi = 0;
    if (inside) {
      qi = quantize<kF32>(xv, step, e, &un, &r);
      const long long o = (long long)z * plane + own + (long long)f * D * plane;
      unpred[o] = un ? 1 : 0;
      rec[o] = r;
    }
    tile[cb][ty + 1][tx + 1] = qi;
    if (tid < kHalo) tile[cb][hj][hi] = halo ? quantize<kF32>(hv, step, e, &un, &r) : 0;
    __syncthreads();
    if (inside) {
      const int (*c)[kTX + 1] = tile[cb];
      const int (*p)[kTX + 1] = tile[pb];
      const int j = ty + 1, i = tx + 1;
      const int d = (c[j][i] - c[j][i - 1] - c[j - 1][i] + c[j - 1][i - 1])
                  - (p[j][i] - p[j][i - 1] - p[j - 1][i] + p[j - 1][i - 1]);
      delta[(long long)z * plane + own + (long long)f * D * plane] = d;
    }
    // Buffer cb is rewritten at z + 3; every read of it is done before the
    // barrier of z + 1, so one barrier per plane suffices.
  }
}

// Pass 1 of the inverse: 2-D inclusive prefix (x, then y) of one (f, z) plane.
__global__ void __launch_bounds__(kScanThreads)
lorenzo3d_inv_plane_kernel(const int* __restrict__ delta, int H, int W,
                           int* __restrict__ q2) {
  extern __shared__ unsigned colsum[];           // W running column sums
  __shared__ unsigned wsum[2][kScanWarps];
  const long long base = (long long)blockIdx.x * H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int x = threadIdx.x; x < W; x += kScanThreads) colsum[x] = 0u;
  // colsum[x] is touched only by the thread that owns column x: no barrier.
  int row = 0;   // row-chunks done, picks the warp-total buffer
  for (int y = 0; y < H; ++y) {
    unsigned off = 0u;   // sum of this row's earlier chunks
    const int* drow = delta + base + (long long)y * W;
    int* qrow = q2 + base + (long long)y * W;
    for (int c0 = 0; c0 < W; c0 += kScanThreads, ++row) {
      const int x = c0 + threadIdx.x;
      unsigned v = x < W ? (unsigned)drow[x] : 0u;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const unsigned u = __shfl_up_sync(0xffffffffu, v, s);
        if (lane >= s) v += u;
      }
      unsigned* ws = wsum[row & 1];
      if (lane == 31) ws[warp] = v;
      __syncthreads();
      unsigned before = 0u, total = 0u;
#pragma unroll
      for (int k = 0; k < kScanWarps; ++k) {
        const unsigned t = ws[k];
        if (k < warp) before += t;
        total += t;
      }
      // ws is rewritten two chunks later, after the next chunk's barrier,
      // which every thread reaches only once these reads are done.
      if (x < W) {
        const unsigned s = colsum[x] + v + before + off;
        colsum[x] = s;
        qrow[x] = (int)s;
      }
      off += total;
    }
  }
}

// Pass 2 of the inverse: prefix over z and dequantize, one thread per (f, y, x).
__global__ void __launch_bounds__(kZThreads)
lorenzo3d_inv_z_kernel(const int* __restrict__ q2, const double* __restrict__ eb,
                       int F, int D, long long plane, double* __restrict__ rec) {
  const long long i = (long long)blockIdx.x * kZThreads + threadIdx.x;
  if (i >= (long long)F * plane) return;
  const int f = (int)(i / plane);
  const long long p = i - (long long)f * plane;
  const double step = __dmul_rn(2.0, eb[f]);
  const long long base = (long long)f * D * plane + p;
  unsigned acc = 0u;
#pragma unroll 4
  for (int z = 0; z < D; ++z) {
    acc += (unsigned)q2[base + (long long)z * plane];
    rec[base + (long long)z * plane] = __dmul_rn((double)(int)acc, step);
  }
}

template <bool kF32>
void launch_fwd(const void* x, const void* eb, int F, int D, int H, int W,
                void* delta, void* unpred, void* rec, cudaStream_t s) {
  const dim3 grid((W + kTX - 1) / kTX, (H + kTY - 1) / kTY, F);
  lorenzo3d_fwd_kernel<kF32><<<grid, dim3(kTX, kTY), 0, s>>>(
      static_cast<const double*>(x), static_cast<const double*>(eb), D, H, W,
      static_cast<int*>(delta), static_cast<uint8_t*>(unpred),
      static_cast<double*>(rec));
}

}  // namespace

// Each returns a cudaError_t: 0 when the launches were accepted.
extern "C" int lorenzo3d_fwd(const void* x, const void* eb, int F, int D, int H,
                             int W, int out_f32, void* delta, void* unpred,
                             void* rec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)F * D * H * W == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (out_f32) launch_fwd<true>(x, eb, F, D, H, W, delta, unpred, rec, s);
  else launch_fwd<false>(x, eb, F, D, H, W, delta, unpred, rec, s);
  return (int)cudaGetLastError();
}

extern "C" int lorenzo3d_inv(const void* delta, const void* eb, int F, int D,
                             int H, int W, void* scratch, void* rec, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)F * D * H * W == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)W * sizeof(unsigned);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lorenzo3d_inv_plane_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  lorenzo3d_inv_plane_kernel<<<(unsigned)((long long)F * D), kScanThreads, smem, s>>>(
      static_cast<const int*>(delta), H, W, static_cast<int*>(scratch));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long plane = (long long)H * W;
  const long long n = (long long)F * plane;
  lorenzo3d_inv_z_kernel<<<(unsigned)((n + kZThreads - 1) / kZThreads), kZThreads, 0, s>>>(
      static_cast<const int*>(scratch), static_cast<const double*>(eb), F, D,
      plane, static_cast<double*>(rec));
  return (int)cudaGetLastError();
}

extern "C" const char* lorenzo3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
