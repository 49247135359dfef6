// K9: unnormalized inverse complex FFT down the rows of each group of a
// float32 re/im pair viewed as (groups, n, cols), written ROTATED: output row
// g * cols + col holds the n transformed values of input column col of group
// g, so the output is (groups * cols, n) with the transformed axis minor.
// Natural order out; new tensors (the rotation cannot run in place).
//
// Replaces randomfield_tpu/ops/pallas_fft.py:_make_sublane_kernel, reached
// through _ifft_sublane2d (ifft_sublane_pallas_reim), the transform of the
// staged v4 render (engine/staged.py:_stages_v4): "physical transpose + minor
// axis FFT" as one pass over device memory.  The TPU kernel gets the rotation
// from its stage-2 matmul's free choice of output orientation and leaves the
// lanes in raw digit order, which a later gather undoes; here the radix-2
// routine of fft_common.cuh leaves every line in natural order in shared
// memory, and the rotation is the store's index arithmetic, so no digit fix
// exists.
//
// What bounds it on the H100: device-memory bytes, one read and one write of
// each lattice (16 bytes per complex element), and the shared-memory traffic
// of log2(n) butterfly stages.  Design: it is the axis FFT's panel kernel
// (fft_axis.cu) with the store turned.  A block owns `panel` consecutive
// columns by all n rows of one group; its loads run along the columns (panel
// contiguous floats per row); after the transform each of the panel's lines
// is one whole output row, and the panel's rows lie back to back, so the
// block writes panel * n contiguous floats.  The columns ride grid.x (a
// 1024^3 pass has 525312 of them) and the groups grid.y; indices are 64-bit.
#include "fft_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fft_rotate_kernel(const float* __restrict__ re, const float* __restrict__ im,
                  float* __restrict__ out_re, float* __restrict__ out_im,
                  const float2* __restrict__ tw_global, int n, int log2n,
                  long long cols, int panel, int log2panel) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* tw = reinterpret_cast<float2*>(smem_raw);  // n / 2 twiddles
  float2* buf = tw + (n >> 1);                         // panel lines of n + 1
  const int stride = n + 1;
  const long long col0 = static_cast<long long>(blockIdx.x) * panel;
  const long long group = static_cast<long long>(blockIdx.y);
  const long long base = group * n * cols;
  const int count = n << log2panel;

  for (int k = threadIdx.x; k < (n >> 1); k += blockDim.x) tw[k] = tw_global[k];
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int r = e >> log2panel;
    const int c = e & (panel - 1);
    const long long col = col0 + c;
    float2 v = make_float2(0.f, 0.f);
    if (col < cols) {
      const long long idx = base + r * cols + col;
      v = make_float2(re[idx], im[idx]);
    }
    buf[c * stride + rf::bit_reverse(r, log2n)] = v;
  }
  __syncthreads();

  rf::fft_lines(buf, panel, n, log2n, stride, tw, 1);

  // line c is output row group * cols + col0 + c: the block's rows are
  // contiguous, n floats each
  const long long left = cols - col0;
  const int lines = left < panel ? static_cast<int>(left) : panel;
  const long long out0 = (group * cols + col0) * n;
  for (int e = threadIdx.x; e < (lines << log2n); e += blockDim.x) {
    const float2 v = buf[(e >> log2n) * stride + (e & (n - 1))];
    out_re[out0 + e] = v.x;
    out_im[out0 + e] = v.y;
  }
}

}  // namespace

// re, im: float32 (groups, n, cols), contiguous, read only; out_re, out_im:
// float32 (groups * cols, n), contiguous: out[g * cols + col][j] = sum_k
// x[g][k][col] exp(+2 pi i j k / n).  tw: n / 2 float2 twiddles
// exp(+2 pi i k / n).  n and panel are powers of two, 16 <= n <= 2048,
// groups <= 65535; the caller checks.  Returns the CUDA error of the launch
// (0 on success).
extern "C" int rf_fft_rotate(const void* re, const void* im, void* out_re,
                             void* out_im, const void* tw, int groups, int n,
                             long long cols, int panel, void* stream) {
  const size_t smem = sizeof(float2) *
                      (static_cast<size_t>(n >> 1) +
                       static_cast<size_t>(panel) * (n + 1));
  cudaError_t err = cudaFuncSetAttribute(
      fft_rotate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((cols + panel - 1) / panel),
                  static_cast<unsigned>(groups));
  fft_rotate_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<const float2*>(tw), n, rf::log2_of(n), cols, panel,
      rf::log2_of(panel));
  return static_cast<int>(cudaGetLastError());
}
