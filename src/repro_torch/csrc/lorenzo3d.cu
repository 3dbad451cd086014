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
// becomes a reduce pass and a scan pass that wait on no other block, with
// no full-size scratch.  A field's rows are cut into bands of bh rows
// (bh = 8 where a band's state fits in shared memory, fewer for very wide
// rows).  Pass 1 (carry): one thread per (field, z, x) walks the column
// down the plane and writes, at each band's first row, the sum of the rows
// above it: carry[f][z][b][x], 1/bh of a plane.  Pass 2 (band): one block
// per (field, band) walks z.  For each plane it reads the band's rows of
// delta and its carry row (the next plane's are in flight while it works),
// scans each column down the band in registers and adds the carry (the
// column's prefix over y), adds that into the band's running sums over z
// (bh x W in shared memory), then scans each row along x (warp shuffles,
// then a scan of the warp totals) and writes rec = q * step.  Traffic:
// delta is read twice and rec written once, plus the carry rows (1/bh of
// delta, written once and read once).  Integer sums wrap (unsigned
// arithmetic), which is exact for every archive the encoder writes.
//
// Striped inverse, for rows wider than a band's state holds (W > 56,320
// points, where not even one row fits in shared memory): the row is cut
// into stripes of kStripe points and each (field, band, stripe) block runs
// the band pass above over its stripe alone.  The 3-D prefix sum is
// separable, so a stripe needs one more value per (f, z, y): the sum of
// every point left of the stripe in the rows and planes up to (z, y),
//   P[f][z][y][s] = sum over z' <= z, y' <= y, x < s * kStripe of delta,
// which the band pass adds to each point of row y at plane z.  P comes
// from three small passes over F * D * H * nS values (1 / kStripe of the
// group): the stripes' row-segment sums (seg), their exclusive scan over
// the stripes of a row (segscan), then the inclusive prefix over y and z
// (prefix: one block per (field, stripe) scans y plane by plane and adds
// the plane before).  Traffic: delta read three times, rec written once.
// Rows that fit keep the route above, unchanged.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCodeCap = 1 << 15;
constexpr int kTX = 32;
constexpr int kTY = 8;
constexpr int kHalo = kTX + 1 + kTY;   // the -1 row with its corner, the -1 column
constexpr int kCarryThreads = 128;
constexpr int kBandThreads = 512;
constexpr int kBandWarps = kBandThreads / 32;
constexpr int kBandRows = 8;                    // the most rows a band holds
constexpr int kStateBytes = 220 * 1024;         // shared memory for a band's state
constexpr int kStripe = 4 * kBandThreads;       // points of a stripe (striped route)
constexpr int kSegThreads = 256;
constexpr int kPrefixThreads = 256;

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

// Pass 1 of the inverse: carry[f][z][b][x] = sum of delta[f][z][y][x] over
// the rows y above band b (b * bh), one thread per (f, z, x).
__global__ void __launch_bounds__(kCarryThreads)
lorenzo3d_inv_carry_kernel(const int* __restrict__ delta, int H, int W, int bh,
                           int nb, int xblocks, unsigned* __restrict__ carry) {
  const int plane = blockIdx.x / xblocks;            // f * D + z
  const int x = (blockIdx.x - plane * xblocks) * kCarryThreads + threadIdx.x;
  if (x >= W) return;
  const int* d = delta + (long long)plane * H * W + x;
  unsigned* c = carry + (long long)plane * nb * W + x;
  unsigned s = 0u;
  int b = 0, left = 0;   // band of the next row, rows left in the current band
  for (int y0 = 0; y0 < H; y0 += 8) {
    unsigned v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = y0 + i < H ? (unsigned)__ldg(d + (long long)(y0 + i) * W) : 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (y0 + i >= H) break;
      if (left == 0) {
        c[(long long)b * W] = s;
        ++b;
        left = bh;
      }
      s += v[i];
      --left;
    }
  }
}

// Pass 2 of the inverse: block (f, b) walks z over the band's rows.  On the
// striped route (kStriped) block (f, b, s) walks stripe s of them, columns
// x0 .. x0 + Ws of rows W wide, and adds the stripe's left prefix
// P[f][z][y][s] to each point.
template <bool kStriped>
__global__ void __launch_bounds__(kBandThreads)
lorenzo3d_inv_band_kernel(const int* __restrict__ delta,
                          const unsigned* __restrict__ carry,
                          const unsigned* __restrict__ left,
                          const double* __restrict__ eb, int D, int H, int W,
                          int bh, int nb, int ns, double* __restrict__ rec) {
  extern __shared__ unsigned state[];   // [bh][Ws]: sums over z of the column prefix
  __shared__ unsigned wtot[2][kBandRows][kBandWarps];   // warp totals of a row chunk
  __shared__ uint4 wpre[2][kBandWarps][kBandRows / 4];  // their exclusive scan
  __shared__ unsigned ctot[2][kBandRows];               // a row chunk's total
  const int f = blockIdx.x / nb, b = blockIdx.x - f * nb;
  const int sx = kStriped ? (int)blockIdx.y : 0;
  const int x0 = kStriped ? sx * kStripe : 0;
  const int Ws = kStriped ? (W - x0 < kStripe ? W - x0 : kStripe) : W;
  const int y0 = b * bh;
  const int rows = H - y0 < bh ? H - y0 : bh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const double step = __dmul_rn(2.0, eb[f]);
  const long long plane = (long long)H * W;
  const int* dband = delta + (long long)f * D * plane + (long long)y0 * W + x0;
  const unsigned* cband = carry + ((long long)f * D * nb + b) * W + x0;
  const unsigned* lband = kStriped ? left + ((long long)f * D * H + y0) * ns + sx : nullptr;
  double* rband = rec + (long long)f * D * plane + (long long)y0 * W + x0;
  for (int i = tid; i < rows * Ws; i += kBandThreads) state[i] = 0u;
  __syncthreads();

  const int chunks = (Ws + kBandThreads - 1) / kBandThreads;
  const int steps = D * chunks;
  // The loads of step k: the band's rows of delta and the carry row at
  // plane z, columns of chunk ch.
  unsigned dn[kBandRows], cn = 0u;
  auto load = [&](int k) {
    const int z = k / chunks, x = (k - z * chunks) * kBandThreads + tid;
    if (x >= Ws) return;
    const int* dp = dband + (long long)z * plane + x;
#pragma unroll
    for (int i = 0; i < kBandRows; ++i)
      if (i < rows) dn[i] = (unsigned)__ldg(dp + (long long)i * W);
    cn = __ldg(cband + (long long)z * nb * W + x);
  };
  load(0);
  // Sums of the row's earlier chunks; striped, they start at the stripe's
  // left prefix.
  unsigned off[kBandRows];
  for (int k = 0; k < steps; ++k) {
    const int z = k / chunks, ch = k - z * chunks;
    const int x = ch * kBandThreads + tid;
    const int par = k & 1;
    unsigned d[kBandRows];
#pragma unroll
    for (int i = 0; i < kBandRows; ++i) d[i] = dn[i];
    unsigned u = cn;
    if (k + 1 < steps) load(k + 1);
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < kBandRows; ++i) {
        off[i] = 0u;
        if (kStriped && i < rows) off[i] = __ldg(lband + ((long long)z * H + i) * ns);
      }
    }
    // Down the column (the carry holds the rows above the band), into the
    // running sums over z, then the inclusive scan along x within the warp.
    unsigned v[kBandRows];
#pragma unroll
    for (int i = 0; i < kBandRows; ++i) {
      v[i] = 0u;
      if (i < rows && x < Ws) {
        u += d[i];
        v[i] = state[i * Ws + x] + u;
        state[i * Ws + x] = v[i];
      }
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const unsigned t = __shfl_up_sync(0xffffffffu, v[i], s);
        if (lane >= s) v[i] += t;
      }
      if (lane == 31) wtot[par][i][warp] = v[i];
    }
    __syncthreads();
    // Warp i scans row i's warp totals.
    if (warp < rows) {
      const unsigned t = lane < kBandWarps ? wtot[par][warp][lane] : 0u;
      unsigned incl = t;
#pragma unroll
      for (int s = 1; s < kBandWarps; s <<= 1) {
        const unsigned w = __shfl_up_sync(0xffffffffu, incl, s);
        if (lane >= s) incl += w;
      }
      if (lane < kBandWarps)
        reinterpret_cast<unsigned*>(&wpre[par][lane][0])[warp] = incl - t;
      if (lane == kBandWarps - 1) ctot[par][warp] = incl;
    }
    __syncthreads();
    // wtot[par], wpre[par] and ctot[par] are written again two steps on,
    // after the next step's first barrier, which every thread reaches only
    // once these reads are done.
    const unsigned* pre = reinterpret_cast<const unsigned*>(&wpre[par][warp][0]);
#pragma unroll
    for (int i = 0; i < kBandRows; ++i) {
      if (i >= rows) break;
      const unsigned q = v[i] + pre[i] + off[i];
      off[i] += ctot[par][i];
      if (x < Ws)
        rband[(long long)z * plane + (long long)i * W + x] =
            __dmul_rn((double)(int)q, step);
    }
  }
}

// Striped route, pass a: seg[r][s] = the sum of row r's points in stripe
// s, one block per (row, stripe), r = (f * D + z) * H + y.
__global__ void __launch_bounds__(kSegThreads)
lorenzo3d_inv_seg_kernel(const int* __restrict__ delta, int W, int ns,
                         unsigned* __restrict__ seg) {
  __shared__ unsigned wsum[kSegThreads / 32];
  const long long r = blockIdx.x / ns;
  const int s = (int)(blockIdx.x - r * ns);
  const int x0 = s * kStripe;
  const int x1 = W - x0 < kStripe ? W : x0 + kStripe;
  const int* row = delta + r * W;
  unsigned acc = 0u;
  for (int x = x0 + threadIdx.x; x < x1; x += kSegThreads)
    acc += (unsigned)__ldg(row + x);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned t = 0u;
#pragma unroll
    for (int w = 0; w < kSegThreads / 32; ++w) t += wsum[w];
    seg[r * ns + s] = t;
  }
}

// Striped route, pass b: each row's segment sums become their exclusive
// scan over the row's stripes, one thread per row.
__global__ void __launch_bounds__(kPrefixThreads)
lorenzo3d_inv_segscan_kernel(long long rows, int ns, unsigned* __restrict__ seg) {
  const long long r = (long long)blockIdx.x * kPrefixThreads + threadIdx.x;
  if (r >= rows) return;
  unsigned* p = seg + r * ns;
  unsigned run = 0u;
  for (int s = 0; s < ns; ++s) {
    const unsigned v = p[s];
    p[s] = run;
    run += v;
  }
}

// Striped route, pass c: the inclusive prefix over y, then over z, of the
// exclusive stripe sums, in place.  Block (f, s) scans y for each plane z in
// chunks of kPrefixThreads rows and adds plane z - 1's result at the same
// y, which the same thread wrote.
__global__ void __launch_bounds__(kPrefixThreads)
lorenzo3d_inv_prefix_kernel(int D, int H, int ns, unsigned* __restrict__ seg) {
  __shared__ unsigned wtot[kPrefixThreads / 32];
  const int f = blockIdx.x / ns, s = blockIdx.x - f * ns;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned* col = seg + (long long)f * D * H * ns + s;
  for (int z = 0; z < D; ++z) {
    unsigned run = 0u;   // the sum of this plane's earlier chunks
    for (int y0 = 0; y0 < H; y0 += kPrefixThreads) {
      const int y = y0 + tid;
      const long long o = ((long long)z * H + y) * ns;
      unsigned v = y < H ? col[o] : 0u;
#pragma unroll
      for (int k = 1; k < 32; k <<= 1) {
        const unsigned t = __shfl_up_sync(0xffffffffu, v, k);
        if (lane >= k) v += t;
      }
      if (lane == 31) wtot[warp] = v;
      __syncthreads();
      unsigned before = 0u, total = 0u;
#pragma unroll
      for (int w = 0; w < kPrefixThreads / 32; ++w) {
        before += w < warp ? wtot[w] : 0u;
        total += wtot[w];
      }
      __syncthreads();   // wtot is written again by the next chunk
      if (y < H) {
        unsigned q = v + before + run;
        if (z > 0) q += col[o - (long long)H * ns];
        col[o] = q;
      }
      run += total;
    }
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
  // Tiles of kTY rows along grid.y, fields along grid.z.
  if ((H + kTY - 1) / kTY > 65535 || F > 65535) return (int)cudaErrorInvalidConfiguration;
  auto s = static_cast<cudaStream_t>(stream);
  if (out_f32) launch_fwd<true>(x, eb, F, D, H, W, delta, unpred, rec, s);
  else launch_fwd<false>(x, eb, F, D, H, W, delta, unpred, rec, s);
  return (int)cudaGetLastError();
}

// Rows a band of the inverse holds for rows of W points: kBandRows where
// the band's state fits in shared memory, fewer for very wide rows; 0 when
// not even one row fits.
extern "C" int lorenzo3d_inv_band_rows(int W) {
  const long long rows = kStateBytes / (4LL * (W > 0 ? W : 1));
  return rows < kBandRows ? (int)rows : kBandRows;
}

// The stripe width of the striped route, for rows that
// lorenzo3d_inv_band_rows refuses.
extern "C" int lorenzo3d_inv_stripe() { return kStripe; }

// carry holds F * D * ceil(H / bh) * W unsigned ints.  Rows that fit a band
// take the band route: bh = lorenzo3d_inv_band_rows(W), ns = 1, left
// unused.  Wider rows take the striped route: bh =
// lorenzo3d_inv_band_rows(kStripe), ns = ceil(W / kStripe), and left holds
// F * D * H * ns unsigned ints.
extern "C" int lorenzo3d_inv(const void* delta, const void* eb, int F, int D,
                             int H, int W, int bh, int ns, void* carry,
                             void* left, void* rec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((long long)F * D * H * W == 0) return 0;
  const bool striped = ns > 1;
  const int width = striped ? kStripe : W;
  if (bh < 1 || bh > lorenzo3d_inv_band_rows(width)) return (int)cudaErrorInvalidValue;
  if (ns != (striped ? (W + kStripe - 1) / kStripe : 1) || ns > 65535)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int nb = (H + bh - 1) / bh;
  const int xblocks = (W + kCarryThreads - 1) / kCarryThreads;
  lorenzo3d_inv_carry_kernel<<<(unsigned)((long long)F * D * xblocks), kCarryThreads, 0, s>>>(
      static_cast<const int*>(delta), H, W, bh, nb, xblocks,
      static_cast<unsigned*>(carry));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (striped) {
    const long long rows = (long long)F * D * H;
    unsigned* l = static_cast<unsigned*>(left);
    lorenzo3d_inv_seg_kernel<<<(unsigned)(rows * ns), kSegThreads, 0, s>>>(
        static_cast<const int*>(delta), W, ns, l);
    lorenzo3d_inv_segscan_kernel<<<(unsigned)((rows + kPrefixThreads - 1) / kPrefixThreads),
                                   kPrefixThreads, 0, s>>>(rows, ns, l);
    lorenzo3d_inv_prefix_kernel<<<(unsigned)((long long)F * ns), kPrefixThreads, 0, s>>>(
        D, H, ns, l);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = (size_t)bh * width * sizeof(unsigned);
  auto kernel = striped ? lorenzo3d_inv_band_kernel<true> : lorenzo3d_inv_band_kernel<false>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3((unsigned)((long long)F * nb), (unsigned)ns), kBandThreads, smem, s>>>(
      static_cast<const int*>(delta), static_cast<const unsigned*>(carry),
      static_cast<const unsigned*>(left), static_cast<const double*>(eb), D, H, W,
      bh, nb, ns, static_cast<double*>(rec));
  return (int)cudaGetLastError();
}

extern "C" const char* lorenzo3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
