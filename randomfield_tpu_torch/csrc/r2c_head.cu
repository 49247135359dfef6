// K6: r2c along the minor (z) axis by the half-length complex pack:
// (lines, nz) float32 -> (lines, nz/2 + 1) re/im, unnormalized forward.
//
// Replaces randomfield_tpu/ops/pallas_fft.py:rfft_minor_half_reim, the head
// of the distributed forward transform (parallel/dfft.py:_slab_pallas_
// forward_local), the mirror of the c2r tail (c2r_tail.cu, K4).  Same
// algebra: with m = nz / 2,
//
//   z[j] = x[2j] + i x[2j+1],  Z = FFT_m(z),  R[k] = conj(Z[(m - k) mod m]),
//   A[k] = (Z[k] + R[k]) / 2,  B[k] = -i (Z[k] - R[k]) / 2,
//   X[k] = A[k] + W^-k B[k],   W = exp(+2 pi i / nz),  k < m,
//   X[m] = Re Z[0] - Im Z[0].
//
// The TPU kernel pairs the lanes with a reshape and reverses Z with a
// concatenate in XLA around a forward CT pass (the inverse kernel between
// two conjugations); here the pair is one float2 load, the reversal an
// index into shared memory, and the m-point transform runs forward on
// conjugated twiddles (fft_common.cuh), so the field is read once and the
// spectrum written once.
//
// What bounds it on the H100: device-memory bytes, one read of the field
// (4 bytes per cell) and one write of the spectrum (8 bytes per packed
// mode), plus log2(m) shared-memory butterfly stages.  Design: a block owns
// `lines_per_block` consecutive (x, y) lines, which lie contiguous in both
// the field and the spectrum, so the load and the store are fully coalesced
// and nothing between them touches device memory.
#include "fft_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
r2c_head_kernel(const float* __restrict__ x, const float2* __restrict__ tw_global,
                float* __restrict__ re, float* __restrict__ im,
                long long lines, int m, int log2m, int lines_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nzh = m + 1;
  const int nz = 2 * m;
  float2* tw = reinterpret_cast<float2*>(smem_raw);  // m twiddles W^-j
  float2* z = tw + m;                                  // packed lines of m
  const long long line0 = static_cast<long long>(blockIdx.x) * lines_per_block;
  const long long left = lines - line0;
  const int nlines = left < lines_per_block ? static_cast<int>(left)
                                            : lines_per_block;

  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    tw[k] = rf::conj_if(tw_global[k], true);
  }
  // the pair (x[2j], x[2j+1]) is one aligned float2: nz is even
  const float2* src = reinterpret_cast<const float2*>(x + line0 * nz);
  for (int e = threadIdx.x; e < nlines * m; e += blockDim.x) {
    const int b = e >> log2m;
    const int j = e & (m - 1);
    z[b * m + rf::bit_reverse(j, log2m)] = src[e];
  }
  __syncthreads();

  // the forward m-point transform needs exp(-2 pi i k / m) = W^(-2k): stride 2
  rf::fft_lines(z, nlines, m, log2m, m, tw, 2);

  const long long out0 = line0 * nzh;
  for (int e = threadIdx.x; e < nlines * nzh; e += blockDim.x) {
    const int b = e / nzh;
    const int k = e - b * nzh;
    const float2* row = z + b * m;
    float xr, xi;
    if (k == m) {
      xr = row[0].x - row[0].y;
      xi = 0.f;
    } else {
      const float2 zk = row[k];
      const float2 zr = row[(m - k) & (m - 1)];
      const float a_re = 0.5f * (zk.x + zr.x);
      const float a_im = 0.5f * (zk.y - zr.y);
      const float b_re = 0.5f * (zk.y + zr.y);
      const float b_im = -0.5f * (zk.x - zr.x);
      const float2 w = tw[k];
      xr = a_re + (w.x * b_re - w.y * b_im);
      xi = a_im + (w.x * b_im + w.y * b_re);
    }
    re[out0 + e] = xr;
    im[out0 + e] = xi;
  }
}

}  // namespace

// x: float32 (lines, 2m), contiguous; tw: m float2 twiddles
// exp(+2 pi i j / (2m)) (conjugated here); re, im: float32 (lines, m + 1).
// m and lines_per_block are powers of two, 16 <= m <= 2048; the caller
// checks.  Returns the CUDA error of the launch (0 on success).
extern "C" int rf_r2c_head(const void* x, const void* tw, void* re, void* im,
                           long long lines, int m, int lines_per_block,
                           void* stream) {
  const size_t smem =
      sizeof(float2) * (static_cast<size_t>(m) +
                        static_cast<size_t>(lines_per_block) * m);
  cudaError_t err = cudaFuncSetAttribute(
      r2c_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks =
      static_cast<unsigned>((lines + lines_per_block - 1) / lines_per_block);
  r2c_head_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float2*>(tw),
      static_cast<float*>(re), static_cast<float*>(im), lines, m,
      rf::log2_of(m), lines_per_block);
  return static_cast<int>(cudaGetLastError());
}
