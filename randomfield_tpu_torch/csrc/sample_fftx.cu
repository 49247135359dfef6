// K10: the staged v6 render's entry stage, sampling fused into the x
// transform.  Output: two float32 lattices (nzh * ny, nx), nzh = nz / 2 + 1;
// row kz * ny + y holds the unnormalized inverse x-FFT, in natural order, of
// that x-line of the sampled half-spectrum.  No sampled line ever reaches
// device memory: a block draws its lines into shared memory, transforms them
// there and writes the result once.
//
// Replaces randomfield_tpu/ops/pallas_genfft.py:_make_genfft_kernel, reached
// through _genfft_jit (sample_fftx_pallas).  Per line:
//   * bulk rows (0 < kz < nz / 2; they hold no DC and no self-conjugate
//     mode): per mode two 32-bit words -> 24-bit uniforms -> Box-Muller ->
//     sigma(|k|) (sigma_common.cuh) / sqrt(2), and the Gaussian filter when
//     s != 0, in the TPU kernel's order of float32 operations: |k|^2 =
//     (kx^2 + ky^2) + kz^2, re = (sigma / sqrt(2)) (r cos theta), then re *=
//     exp(((-k^2 / 2) s) s);
//   * plane rows (kz = 0 and kz = nz / 2), whose Hermitian pairing spans the
//     whole plane: the line is LOADED from the (2 ny, nx) input that
//     ops/genfft.py:plane_spectra prepares (rows [0, ny) are kz = 0, rows
//     [ny, 2 ny) the Nyquist plane) and goes through the same transform.
// The TPU kernel seeds its hardware PRNG per row block, which nothing else
// can replay; this one draws a counter-based stream (ops/genfft.py):
// Threefry-2x32 (threefry.cuh) under the seed's key, counting the 64-bit flat
// index (kz ny + y) nx + x.  The TPU leaves the x lanes in raw digit order;
// the radix-2 routine of fft_common.cuh ends in natural order.
//
// What bounds it on the H100: it writes 8 bytes per mode (4.303 GB at 1024^3)
// and reads only the two planes; per bulk mode it spends the hash (about 70
// integer operations), a logf, sqrtf, sincosf and (smoothing) expf, plus
// 5 log2(nx) floating-point operations of the transform.  Design: a block
// owns `lines_per_block` consecutive rows, contiguous in the output.  Thread
// e fills shared-memory POSITION p = e mod nx of its line with the mode x =
// bit_reverse(p): the routine wants its input bit-reversed, a generated mode
// costs the same at any x, and consecutive threads then write consecutive
// shared-memory words (no bank conflict; only the plane rows, 2 of nzh, pay
// for it with a scattered read).  The store runs along x, coalesced.
#include <cstdint>

#include "fft_common.cuh"
#include "sigma_common.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sample_fftx_kernel(float* __restrict__ re, float* __restrict__ im,
                   const float* __restrict__ pre, const float* __restrict__ pim,
                   const float* __restrict__ knots, int n_knots,
                   const float2* __restrict__ tw_global, int nx, int log2nx,
                   int ny, int nz, int rows, int lines_per_block, uint32_t k0,
                   uint32_t k1, float kx_scale, float ky_scale, float kz_scale,
                   float half_inv_ln10, float lk0, float inv_dlk,
                   float smoothing) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* tw = reinterpret_cast<float2*>(smem_raw);  // nx / 2 twiddles
  float2* buf = tw + (nx >> 1);                        // lines of nx + 1
  const int stride = nx + 1;
  float* tab = reinterpret_cast<float*>(buf + lines_per_block * stride);

  const int row0 = static_cast<int>(blockIdx.x) * lines_per_block;
  const int left = rows - row0;
  const int lines = left < lines_per_block ? left : lines_per_block;
  const int m_z = nz / 2;

  for (int k = threadIdx.x; k < (nx >> 1); k += blockDim.x) tw[k] = tw_global[k];
  rf::load_knots(tab, knots, n_knots);  // ends with a barrier

  for (int e = threadIdx.x; e < (lines << log2nx); e += blockDim.x) {
    const int l = e >> log2nx;
    const int p = e & (nx - 1);
    const int x = rf::bit_reverse(p, log2nx);
    const int row = row0 + l;
    const int kzi = row / ny;
    const int y = row - kzi * ny;
    float2 v;
    if (kzi == 0 || kzi == m_z) {
      const long long src =
          static_cast<long long>(kzi == 0 ? y : ny + y) * nx + x;
      v = make_float2(pre[src], pim[src]);
    } else {
      const float kx = kx_scale * static_cast<float>(rf::signed_index(x, nx));
      const float ky = ky_scale * static_cast<float>(rf::signed_index(y, ny));
      const float kz = kz_scale * static_cast<float>(kzi);
      const float ksq = __fadd_rn(
          __fadd_rn(__fmul_rn(kx, kx), __fmul_rn(ky, ky)), __fmul_rn(kz, kz));
      const float sig = rf::interp_sigma(
          tab, n_knots, rf::log10_k(ksq, half_inv_ln10), lk0, inv_dlk);
      const uint2 b = rf::mode_bits(
          k0, k1, static_cast<unsigned long long>(row) * nx + x);
      const float r = sqrtf(-2.f * logf(rf::uniform_u1(b.x)));
      const float theta = 6.28318530717958648f * rf::uniform_u2(b.y);
      float s, c;
      sincosf(theta, &s, &c);
      const float amp = sig * 0.70710678118654752f;
      v = make_float2(amp * (r * c), amp * (r * s));
      if (smoothing != 0.f) {
        const float filt = expf(-0.5f * ksq * smoothing * smoothing);
        v.x *= filt;
        v.y *= filt;
      }
    }
    buf[l * stride + p] = v;
  }
  __syncthreads();

  rf::fft_lines(buf, lines, nx, log2nx, stride, tw, 1);

  const long long out0 = static_cast<long long>(row0) * nx;
  for (int e = threadIdx.x; e < (lines << log2nx); e += blockDim.x) {
    const float2 v = buf[(e >> log2nx) * stride + (e & (nx - 1))];
    re[out0 + e] = v.x;
    im[out0 + e] = v.y;
  }
}

}  // namespace

// re, im: float32 (nzh * ny, nx) outputs, contiguous.  pre, pim: float32
// (2 ny, nx) symmetrized plane spectra.  knots: float32 (n_knots,), n_knots
// >= 2.  tw: nx / 2 float2 twiddles exp(+2 pi i k / nx).  (k0, k1): the
// seed's stream key.  k_scale = 2 pi / (spacing * n) per axis and the table
// constants, rounded to float32 as the TPU kernel rounds them.  nx and
// lines_per_block are powers of two, 16 <= nx <= 2048, nz even; the caller
// checks.  Returns the CUDA error of the launch.
extern "C" int rf_sample_fftx(void* re, void* im, const void* pre,
                              const void* pim, const void* knots, int n_knots,
                              const void* tw, int nx, int ny, int nz,
                              int lines_per_block, uint32_t k0, uint32_t k1,
                              float kx_scale, float ky_scale, float kz_scale,
                              float half_inv_ln10, float lk0, float inv_dlk,
                              float smoothing, void* stream) {
  const size_t smem =
      sizeof(float2) * (static_cast<size_t>(nx >> 1) +
                        static_cast<size_t>(lines_per_block) * (nx + 1)) +
      sizeof(float) * static_cast<size_t>(n_knots);
  cudaError_t err = cudaFuncSetAttribute(
      sample_fftx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = (nz / 2 + 1) * ny;
  const unsigned blocks =
      static_cast<unsigned>((rows + lines_per_block - 1) / lines_per_block);
  sample_fftx_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(re), static_cast<float*>(im),
      static_cast<const float*>(pre), static_cast<const float*>(pim),
      static_cast<const float*>(knots), n_knots,
      static_cast<const float2*>(tw), nx, rf::log2_of(nx), ny, nz, rows,
      lines_per_block, k0, k1, kx_scale, ky_scale, kz_scale, half_inv_ln10,
      lk0, inv_dlk, smoothing);
  return static_cast<int>(cudaGetLastError());
}
