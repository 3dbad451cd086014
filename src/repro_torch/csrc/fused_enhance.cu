// Fused enhancement + error regulation (paper §3.3), for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_enhance.py::
// fused_enhance (body _kernel), but matches the eager reference that writes
// archives, repro.core.regulation.fused_enhance, not the Pallas body: the
// arithmetic is float64 and the result is cast once to the field's type.
//
//   r    = z * eb                      (regulated: (2*sigmoid(z) - 1) * eb)
//   enh  = cast_T(double(dec) + r)
//   bad  = |double(enh) - double(orig)| > eb
//   out  = strict && bad ? dec : enh,   mask = bad
//
// Every float64 multiply and add is written with an explicit round-to-
// nearest intrinsic (__dmul_rn, __dadd_rn, __dsub_rn) and the cast with
// __double2float_rn, so nvcc cannot contract d + z*eb into one fused
// multiply-add whatever --fmad says: a contracted sum rounds once where the
// reference rounds twice and flips points at the bound, which strict mode
// cannot afford.  The same kernel serves decode with orig := dec and
// strict = 0.
//
// Bound: memory traffic (4 + 2*sizeof(T) bytes in, sizeof(T) + 1 out per
// point, a few float64 operations).  Design: one grid-stride elementwise
// pass, so the field is read once and written once.  Vector loads are a
// later optimisation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;

__device__ __forceinline__ float narrow(float*, double v) {
  return __double2float_rn(v);
}
__device__ __forceinline__ double narrow(double*, double v) { return v; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_enhance_kernel(const float* __restrict__ z, const T* __restrict__ dec,
                     const T* __restrict__ orig, T* __restrict__ out,
                     uint8_t* __restrict__ mask, long long n, double eb,
                     int regulated, int strict) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const double zd = (double)z[i];
    double r;
    if (regulated) {
      const double s = 1.0 / (1.0 + exp(-zd));
      r = __dmul_rn(__dsub_rn(__dmul_rn(2.0, s), 1.0), eb);
    } else {
      r = __dmul_rn(zd, eb);
    }
    const T d = dec[i];
    const T enh = narrow((T*)nullptr, __dadd_rn((double)d, r));
    const bool bad = fabs(__dsub_rn((double)enh, (double)orig[i])) > eb;
    out[i] = (strict && bad) ? d : enh;
    mask[i] = bad ? 1 : 0;
  }
}

template <typename T>
int launch(const void* z, const void* dec, const void* orig, void* out,
           void* mask, long long n, double eb, int regulated, int strict,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  fused_enhance_kernel<T><<<(unsigned)blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const T*>(dec),
      static_cast<const T*>(orig), static_cast<T*>(out),
      static_cast<uint8_t*>(mask), n, eb, regulated, strict);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns a cudaError_t: 0 when the launch was accepted.
extern "C" int fused_enhance_f32(const void* z, const void* dec,
                                 const void* orig, void* out, void* mask,
                                 long long n, double eb, int regulated,
                                 int strict, int device, void* stream) {
  return launch<float>(z, dec, orig, out, mask, n, eb, regulated, strict,
                       device, stream);
}

extern "C" int fused_enhance_f64(const void* z, const void* dec,
                                 const void* orig, void* out, void* mask,
                                 long long n, double eb, int regulated,
                                 int strict, int device, void* stream) {
  return launch<double>(z, dec, orig, out, mask, n, eb, regulated, strict,
                        device, stream);
}

extern "C" const char* fused_enhance_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
