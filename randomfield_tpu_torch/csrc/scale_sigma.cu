// K2: in place re, im *= sigma(|k|) * exp(-k^2 s^2 / 2) * gain over an 'xyz'
// (nx_loc, ny_loc, nz/2 + 1) block of the packed half-spectrum.  A render
// passes gain = 1/sqrt(2), the unit draws' complex normalization, so the
// draws need no pass of their own for it.
//
// Replaces randomfield_tpu/ops/pallas_sampler.py:_scale_jit_reim (the 'xzy'
// single-device kernel) on draws the caller supplies; (x_off, y_off) place
// a block of the grid.  Same arithmetic, step for step:
// |k|^2 from the signed global indices, log10|k| = (0.5 / ln 10) ln|k|^2,
// t = (log10|k| - lk0) / dlk clipped to [0, n_knots - 1], i0 = min(int(t),
// n_knots - 2), sigma = s[i0] (1 - frac) + s[i0 + 1] frac, sigma(0) = 0, the
// filter only when s != 0, then the gain (sigma_common.cuh:k2_amplitude,
// which the fused draw_scale.cu calls too; the interpolation is the one K1
// and K5 use).  The default render draws, fixes and scales in draw_scale.cu;
// this kernel scales the caller's draws of generate_from_noise.
//
// What bounds it on the H100: device-memory bytes, one read and one write of
// each lattice (16 bytes per mode); per mode it adds one logf and, when
// smoothing, one expf.  Design: blockIdx.y is the x plane, so kx is computed
// once per block; the threads stride over the plane's (y, kz) modes, which lie
// contiguous, so every access is coalesced.  Products and sums that decide
// the result are rounded as written (__fmul_rn, __fadd_rn), so no fused
// multiply-add moves them away from the plain PyTorch version.
#include <cuda_runtime.h>

#include "sigma_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksPerPlane = 32;

__global__ void __launch_bounds__(kThreads)
scale_sigma_kernel(float* __restrict__ re, float* __restrict__ im,
                   const float* __restrict__ knots, int n_knots, int ny_loc,
                   int nzh, int nx, int ny, int x_off, int y_off,
                   float kx_scale, float ky_scale, float kz_scale,
                   float half_inv_ln10, float lk0, float inv_dlk,
                   float smoothing, float gain) {
  extern __shared__ float tab[];
  rf::load_knots(tab, knots, n_knots);

  const int plane = ny_loc * nzh;
  const int gx = static_cast<int>(blockIdx.y) + x_off;
  const float kx = kx_scale * static_cast<float>(rf::signed_index(gx, nx));
  const float kx2 = kx * kx;
  float* rp = re + static_cast<long long>(blockIdx.y) * plane;
  float* ip = im + static_cast<long long>(blockIdx.y) * plane;

  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < plane;
       p += gridDim.x * blockDim.x) {
    const int y = p / nzh;
    const int z = p - y * nzh;
    const float ky = ky_scale * static_cast<float>(rf::signed_index(y + y_off, ny));
    const float kz = kz_scale * static_cast<float>(z);
    const float amp = rf::k2_amplitude(tab, n_knots, kx2, ky, kz,
                                       half_inv_ln10, lk0, inv_dlk, smoothing,
                                       gain);
    rp[p] = rp[p] * amp;
    ip[p] = ip[p] * amp;
  }
}

// The check entry's kernel: K2's amplitude at each |k|^2 of a list, with
// its steps written out (log10|k|, t, i0, frac), through the same device
// functions the kernels inline.
__global__ void __launch_bounds__(kThreads)
sigma_steps_kernel(const float* __restrict__ ksq,
                   const float* __restrict__ knots, int n_knots, long long n,
                   float half_inv_ln10, float lk0, float inv_dlk,
                   float smoothing, float gain, float* __restrict__ lk_out,
                   float* __restrict__ t_out, int* __restrict__ i0_out,
                   float* __restrict__ frac_out, float* __restrict__ amp_out) {
  extern __shared__ float tab[];
  rf::load_knots(tab, knots, n_knots);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float k2 = ksq[i];
    const float lk = k2 > 0.f ? rf::log10_k(k2, half_inv_ln10) : 0.f;
    const float t = rf::table_t(lk, lk0, inv_dlk, n_knots);
    const int i0 = min(static_cast<int>(t), n_knots - 2);
    lk_out[i] = lk;
    t_out[i] = t;
    i0_out[i] = i0;
    frac_out[i] = __fsub_rn(t, static_cast<float>(i0));
    amp_out[i] = rf::k2_amplitude_ksq(tab, n_knots, k2, half_inv_ln10, lk0,
                                      inv_dlk, smoothing, gain);
  }
}

}  // namespace

// re, im: float32 (nx_loc, ny_loc, nzh), contiguous, scaled in place; they
// cover global x rows [x_off, x_off + nx_loc) and y rows [y_off, y_off +
// ny_loc) of an (nx, ny, nz) scene.  knots: float32 (n_knots,), n_knots >= 2.
// k_scale = 2 pi / (spacing * n) per axis, rounded to float32 as the TPU
// kernel rounds it.  Returns the CUDA error of the launch (0 on success).
extern "C" int rf_scale_sigma(void* re, void* im, const void* knots,
                              int n_knots, int nx_loc, int ny_loc, int nzh,
                              int nx, int ny, int x_off, int y_off,
                              float kx_scale, float ky_scale, float kz_scale,
                              float half_inv_ln10, float lk0, float inv_dlk,
                              float smoothing, float gain, void* stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(n_knots);
  cudaError_t err = cudaFuncSetAttribute(
      scale_sigma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int plane = ny_loc * nzh;
  int per_plane = (plane + kThreads - 1) / kThreads;
  if (per_plane > kMaxBlocksPerPlane) per_plane = kMaxBlocksPerPlane;
  const dim3 grid(static_cast<unsigned>(per_plane),
                  static_cast<unsigned>(nx_loc));
  scale_sigma_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(re), static_cast<float*>(im),
      static_cast<const float*>(knots), n_knots, ny_loc, nzh, nx, ny, x_off,
      y_off, kx_scale, ky_scale, kz_scale, half_inv_ln10, lk0, inv_dlk,
      smoothing, gain);
  return static_cast<int>(cudaGetLastError());
}

// A check, counted nowhere: each step of K2's amplitude at n values of
// |k|^2 (float32), written to lk, t, frac, amp (float32) and i0 (int32), as
// ops/sampler.py:sigma_steps_plain writes the plain version's.
extern "C" int rf_sigma_steps(const void* ksq, const void* knots, int n_knots,
                              long long n, float half_inv_ln10, float lk0,
                              float inv_dlk, float smoothing, float gain,
                              void* lk, void* t, void* i0, void* frac,
                              void* amp, void* stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(n_knots);
  cudaError_t err = cudaFuncSetAttribute(
      sigma_steps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  sigma_steps_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ksq), static_cast<const float*>(knots),
      n_knots, n, half_inv_ln10, lk0, inv_dlk, smoothing, gain,
      static_cast<float*>(lk), static_cast<float*>(t), static_cast<int*>(i0),
      static_cast<float*>(frac), static_cast<float*>(amp));
  return static_cast<int>(cudaGetLastError());
}

// Message of a CUDA error code returned by the entries of this library.
extern "C" const char* rf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
