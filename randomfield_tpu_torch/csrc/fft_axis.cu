// K3: unnormalized complex FFT, inverse (sign = +1) or forward (sign = -1),
// along the middle axis of a float32 re/im pair viewed as (outer, n, inner),
// in place, natural order out.
//
// Replaces randomfield_tpu/ops/pallas_fft.py:_make_kernel + _ct_core, reached
// through _ifft2d (ifft_minor_pallas_reim).  The TPU's forward transform
// (fft_minor_pallas_reim) conjugates around the inverse kernel; here the
// sign conjugates the twiddles as the block loads them, so the forward pass
// of the distributed forward transform costs what the inverse costs.  The
// TPU kernel transforms the MINOR axis only, so the TPU pipeline pays a
// physical transpose before each of its x and y passes.  Here the transform
// axis is the middle one of any (outer, n, inner) view: the x pass of an
// (nx, ny, nzh) spectrum is the view (1, nx, ny * nzh) and the y pass is
// (nx, ny, nzh), with no transpose.
//
// What bounds it on the H100: device-memory bytes (one read and one write of
// each lattice, 16 bytes per complex mode) and the shared-memory traffic of
// log2(n) butterfly stages.  Design: a block owns a panel of `panel`
// consecutive inner columns by all n rows.  Its loads and stores run along
// `inner`, so a warp touches contiguous 32-byte segments (panel >= 8), and the
// whole transform of the panel stays in shared memory between one read and
// one write.  Lines are padded by one element (stride n + 1) so the
// column-major scatter of the load spreads over the banks.
#include "fft_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fft_axis_kernel(float* __restrict__ re, float* __restrict__ im,
                const float2* __restrict__ tw_global, int sign, int n,
                int log2n, long long inner, int panel, int log2panel) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* tw = reinterpret_cast<float2*>(smem_raw);  // n / 2 twiddles
  float2* buf = tw + (n >> 1);                         // panel lines of n + 1
  const int stride = n + 1;
  const long long col0 = static_cast<long long>(blockIdx.x) * panel;
  const long long base = static_cast<long long>(blockIdx.y) * n * inner;
  const int count = n << log2panel;

  for (int k = threadIdx.x; k < (n >> 1); k += blockDim.x) {
    tw[k] = rf::conj_if(tw_global[k], sign < 0);
  }
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int r = e >> log2panel;
    const int c = e & (panel - 1);
    const long long col = col0 + c;
    float2 v = make_float2(0.f, 0.f);
    if (col < inner) {
      const long long idx = base + r * inner + col;
      v = make_float2(re[idx], im[idx]);
    }
    buf[c * stride + rf::bit_reverse(r, log2n)] = v;
  }
  __syncthreads();

  rf::fft_lines(buf, panel, n, log2n, stride, tw, 1);

  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int r = e >> log2panel;
    const int c = e & (panel - 1);
    const long long col = col0 + c;
    if (col < inner) {
      const long long idx = base + r * inner + col;
      const float2 v = buf[c * stride + r];
      re[idx] = v.x;
      im[idx] = v.y;
    }
  }
}

}  // namespace

// re, im: float32 (outer, n, inner), contiguous, transformed in place:
// X[j] = sum_k x[k] exp(sign 2 pi i j k / n).  tw: n / 2 float2 twiddles
// exp(+2 pi i k / n) (either sign).  n and panel are powers of two, 16 <= n
// <= 2048, outer <= 65535; the caller checks.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int rf_fft_axis(void* re, void* im, const void* tw, int sign,
                           int outer, int n, long long inner, int panel,
                           void* stream) {
  const size_t smem = sizeof(float2) *
                      (static_cast<size_t>(n >> 1) +
                       static_cast<size_t>(panel) * (n + 1));
  cudaError_t err = cudaFuncSetAttribute(
      fft_axis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((inner + panel - 1) / panel),
                  static_cast<unsigned>(outer));
  fft_axis_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(re), static_cast<float*>(im),
      static_cast<const float2*>(tw), sign, n, rf::log2_of(n), inner, panel,
      rf::log2_of(panel));
  return static_cast<int>(cudaGetLastError());
}
