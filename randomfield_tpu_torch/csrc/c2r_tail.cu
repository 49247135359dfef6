// K4: c2r along the minor (kz) axis by the half-length complex pack, times
// the per-plane weights w[z]: (lines, nz/2 + 1) re/im -> (lines, nz) float32.
//
// Replaces randomfield_tpu/ops/pallas_fft.py:_make_c2r_kernel, reached through
// _irfft_tail2d (irfft_tail_pallas), the fused tail of the TPU's fastest
// render (engine/staged.py:_render_v5_single).  Same algebra: with m = nz / 2,
//
//   G[j] = E[j] + i W^j O[j],  E = c[j] + conj(c[m-j]),  O = c[j] - conj(c[m-j]),
//   W = exp(+2 pi i / nz),     z = IFFT_m(G),
//   out[2j] = Re z[j] * w[2j],  out[2j+1] = Im z[j] * w[2j+1].
//
// The TPU kernel reverses lanes with in-vreg gathers and undoes the CT digit
// order with a second gather per output block; here the reversal is an index
// (c[m-j] read from shared memory), the G values are written at bit-reversed
// positions, and the radix-2 routine of fft_common.cuh leaves z in natural
// order, so the even/odd interleave is a plain indexed store.
//
// What bounds it on the H100: device-memory bytes, one read of the spectrum
// (8 bytes per packed mode) and one write of the field (4 bytes per cell),
// plus log2(m) shared-memory butterfly stages.  Design: a block owns
// `lines_per_block` consecutive (x, y) lines, which lie contiguous in both the
// spectrum and the field, so the load and the store are fully coalesced and
// nothing between them touches device memory.
#include "fft_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
c2r_tail_kernel(const float* __restrict__ re, const float* __restrict__ im,
                const float* __restrict__ weights,
                const float2* __restrict__ tw_global, float* __restrict__ out,
                long long lines, int m, int log2m, int lines_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nzh = m + 1;
  const int nz = 2 * m;
  float2* tw = reinterpret_cast<float2*>(smem_raw);  // m twiddles W^j
  float2* spec = tw + m;                               // packed input lines
  float2* g = spec + lines_per_block * nzh;            // half-pack lines
  const long long line0 = static_cast<long long>(blockIdx.x) * lines_per_block;
  const long long left = lines - line0;
  const int nlines = left < lines_per_block ? static_cast<int>(left)
                                            : lines_per_block;

  for (int k = threadIdx.x; k < m; k += blockDim.x) tw[k] = tw_global[k];
  const long long in0 = line0 * nzh;
  for (int e = threadIdx.x; e < nlines * nzh; e += blockDim.x) {
    spec[e] = make_float2(re[in0 + e], im[in0 + e]);
  }
  __syncthreads();

  for (int e = threadIdx.x; e < nlines * m; e += blockDim.x) {
    const int b = e >> log2m;
    const int j = e & (m - 1);
    const float2 c = spec[b * nzh + j];
    const float2 r = spec[b * nzh + m - j];
    const float er = c.x + r.x;
    const float ei = c.y - r.y;
    const float orr = c.x - r.x;
    const float oi = c.y + r.y;
    const float2 w = tw[j];
    g[b * nzh + rf::bit_reverse(j, log2m)] =
        make_float2(er - (w.x * oi + w.y * orr), ei + (w.x * orr - w.y * oi));
  }
  __syncthreads();

  // the m-point transform needs exp(+2 pi i k / m) = W^(2k): stride 2
  rf::fft_lines(g, nlines, m, log2m, nzh, tw, 2);

  float* dst = out + line0 * nz;
  for (int e = threadIdx.x; e < nlines * nz; e += blockDim.x) {
    const int b = e >> (log2m + 1);
    const int p = e & (nz - 1);
    const float2 z = g[b * nzh + (p >> 1)];
    dst[e] = ((p & 1) ? z.y : z.x) * weights[p];
  }
}

}  // namespace

// re, im: float32 (lines, m + 1) packed spectra; weights: float32 (2m,);
// tw: m float2 twiddles exp(+2 pi i j / (2m)); out: float32 (lines, 2m).
// m and lines_per_block are powers of two, 16 <= m <= 2048; the caller
// checks.  Returns the CUDA error of the launch (0 on success).
extern "C" int rf_c2r_tail(const void* re, const void* im, const void* weights,
                           const void* tw, void* out, long long lines, int m,
                           int lines_per_block, void* stream) {
  const size_t smem =
      sizeof(float2) * (static_cast<size_t>(m) +
                        2 * static_cast<size_t>(lines_per_block) * (m + 1));
  cudaError_t err = cudaFuncSetAttribute(
      c2r_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks =
      static_cast<unsigned>((lines + lines_per_block - 1) / lines_per_block);
  c2r_tail_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<const float*>(weights), static_cast<const float2*>(tw),
      static_cast<float*>(out), lines, m, rf::log2_of(m), lines_per_block);
  return static_cast<int>(cudaGetLastError());
}
