// sigma(|k|) by linear interpolation in log10 k over the uniform knot table:
// the device code that K1 (sample_modes.cu), K2 (scale_sigma.cu and its
// fused form draw_scale.cu), K5 (sample_power_bins.cu) and K10
// (sample_fftx.cu) share, so all of them interpolate identically.
//
// Counterpart of randomfield_tpu/ops/pallas_sampler.py:_interp_sigma_tile.
// The TPU keeps the knots as overlapping 128-wide segment rows for Mosaic's
// one-vreg lane gather; here the flat knot vector sits in shared memory and
// is indexed directly.  Step for step: log10|k| = (0.5 / ln 10) ln|k|^2,
// t = (log10|k| - lk0) / dlk clipped to [0, n_knots - 1], i0 = min(int(t),
// n_knots - 2), sigma = s[i0] (1 - frac) + s[i0 + 1] frac.  Every step is
// rounded as written (__fmul_rn, __fsub_rn, __fadd_rn): nvcc's default
// contraction would otherwise fuse log10|k| = h ln|k|^2 into the next
// subtraction, (h ln|k|^2 - lk0), as one FFMA once the functions are
// inlined, which moved t, and so sigma, by an ulp on some modes away from
// the plain PyTorch version (ops/sampler.py:_interp_sigma, which rounds the
// product and the difference apart).  table_t is that step alone, so the
// check entry of scale_sigma.cu can write each step.
#pragma once

#include <cuda_runtime.h>

namespace rf {

// Copy the knots into shared memory; every thread of the block must call it.
__device__ __forceinline__ void load_knots(float* tab,
                                           const float* __restrict__ knots,
                                           int n_knots) {
  for (int i = threadIdx.x; i < n_knots; i += blockDim.x) tab[i] = knots[i];
  __syncthreads();
}

// fft frequency index: i up to n/2, i - n above.
__device__ __forceinline__ int signed_index(int i, int n) {
  return i <= n / 2 ? i : i - n;
}

// log10|k| from |k|^2 > 0.
__device__ __forceinline__ float log10_k(float ksq, float half_inv_ln10) {
  return __fmul_rn(half_inv_ln10, logf(ksq));
}

// The table coordinate of log10|k| = lk: (lk - lk0) / dlk clipped to
// [0, n_knots - 1].
__device__ __forceinline__ float table_t(float lk, float lk0, float inv_dlk,
                                         int n_knots) {
  return fminf(fmaxf(__fmul_rn(__fsub_rn(lk, lk0), inv_dlk), 0.f),
               static_cast<float>(n_knots - 1));
}

// sigma at log10|k| = lk, linear over the table tab[0, n_knots).
__device__ __forceinline__ float interp_sigma(const float* tab, int n_knots,
                                              float lk, float lk0,
                                              float inv_dlk) {
  const float t = table_t(lk, lk0, inv_dlk, n_knots);
  const int i0 = min(static_cast<int>(t), n_knots - 2);
  const float frac = __fsub_rn(t, static_cast<float>(i0));
  return __fadd_rn(__fmul_rn(tab[i0], __fsub_rn(1.f, frac)),
                   __fmul_rn(tab[i0 + 1], frac));
}

// K2's amplitude at |k|^2 = ksq: sigma(|k|) * exp(-k^2 s^2 / 2) * gain with
// sigma(0) = 0, the filter only when s != 0.  The fused K2 (draw_scale.cu)
// calls it once for the two x rows of a row pair, whose |k|^2 agree bit for
// bit.
__device__ __forceinline__ float k2_amplitude_ksq(const float* tab,
                                                  int n_knots, float ksq,
                                                  float half_inv_ln10,
                                                  float lk0, float inv_dlk,
                                                  float smoothing,
                                                  float gain) {
  float amp = 0.f;
  if (ksq > 0.f) {
    amp = interp_sigma(tab, n_knots, log10_k(ksq, half_inv_ln10), lk0,
                       inv_dlk);
    if (smoothing != 0.f) amp = amp * expf(-0.5f * ksq * smoothing * smoothing);
    amp = amp * gain;
  }
  return amp;
}

// K2's per-mode amplitude (scale_sigma.cu): k2_amplitude_ksq at |k|^2
// summed (kx^2 + ky^2) + kz^2 as the JAX package's 'xyz' lattice sums it.
__device__ __forceinline__ float k2_amplitude(const float* tab, int n_knots,
                                              float kx2, float ky, float kz,
                                              float half_inv_ln10, float lk0,
                                              float inv_dlk, float smoothing,
                                              float gain) {
  const float ksq =
      __fadd_rn(__fadd_rn(kx2, __fmul_rn(ky, ky)), __fmul_rn(kz, kz));
  return k2_amplitude_ksq(tab, n_knots, ksq, half_inv_ln10, lk0, inv_dlk,
                          smoothing, gain);
}

}  // namespace rf
