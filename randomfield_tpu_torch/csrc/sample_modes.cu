// K1: the sampler='pallas' spectrum, drawn and scaled in one pass.  Per mode
// of the packed 'xyz' (nx, ny, nz/2 + 1) half-spectrum: Threefry-2x32 bits
// of the flat mode index (threefry.cuh) -> 24-bit uniforms -> Box-Muller ->
// sigma(|k|) (sigma_common.cuh) / sqrt(2) -> the filter exp(-k^2 s^2 / 2)
// when s != 0 -> re and im, with DC = 0.  The Hermitian fix of the kz = 0
// and Nyquist planes runs after it, outside the kernel
// (ops/transform.py:symmetrize_with_shape_reim), as on the TPU.
//
// Replaces randomfield_tpu/ops/pallas_sampler.py:_make_kernel with
// bins=None, via _sample_jit_reim / sample_spectrum_pallas_reim.  The same
// float32 operations in the same order: u1 = (b1 >> 8) 2^-24 + 2^-25,
// u2 = (b2 >> 8) 2^-24, r = sqrt(-2 ln u1), theta = 2 pi u2,
// base = sigma / sqrt(2), amp = base exp(((-k^2 / 2) s) s), re = amp (r cos
// theta), im = amp (r sin theta); |k|^2 summed as the TPU's 'xzy' tile sums
// it.  Accurate logf, sqrtf and sincosf (no fast math).  The TPU kernel
// draws from its hardware PRNG per tile, which nothing else can replay; this
// one draws the counter-based stream of ops/modestream.py.
//
// K8, the same kernel over the ky rows [y_off, y_off + ny_loc) of a slab
// mesh's shard, replaces pallas_sampler.py:sample_shard_pallas_reim (the
// _make_kernel shard mode).  The TPU kernel seeds each tile by its global
// tile id; here every mode hashes its global flat 'xyz' counter
// (x ny + y_off + y_loc) nzh + z and takes its global |k|, so the shards'
// union is the whole-grid K1 output bit for bit.  Only the index arithmetic
// differs from K1 (y_off = 0, ny_loc = ny).
//
// What bounds it on the H100: it reads nothing per mode and writes the two
// float32 lattices once (8 bytes per mode, 4.303 GB at 1024^3, 1.284 ms at
// 3.35 TB/s); per mode it spends about 70 integer operations on the hash and
// a logf, sqrtf, sincosf and (smoothing) expf.  Design: blockIdx.y is the x
// plane, so kx is computed once per block; the threads stride over the
// plane's (y, kz) modes, which lie contiguous in the output and in the
// counter, so the stores are coalesced for any nzh (513 at 1024^3).  The
// mode index is 64-bit (2048^3 has more than 2^32 modes).
#include <cstdint>

#include <cuda_runtime.h>

#include "sigma_common.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksPerPlane = 64;

__global__ void __launch_bounds__(kThreads)
sample_modes_kernel(float* __restrict__ re, float* __restrict__ im,
                    const float* __restrict__ knots, int n_knots, int nx,
                    int ny, int nzh, int y_off, int ny_loc, uint32_t k0,
                    uint32_t k1, float kx_scale, float ky_scale,
                    float kz_scale, float half_inv_ln10, float lk0,
                    float inv_dlk, float smoothing) {
  extern __shared__ float tab[];
  rf::load_knots(tab, knots, n_knots);

  const int plane = ny_loc * nzh;
  const int x = static_cast<int>(blockIdx.y);
  const float kx = kx_scale * static_cast<float>(rf::signed_index(x, nx));
  // the counter of this plane's first mode, (x ny + y_off) nzh
  const unsigned long long first =
      (static_cast<unsigned long long>(x) * ny + y_off) * nzh;
  float* rp = re + static_cast<long long>(x) * plane;
  float* ip = im + static_cast<long long>(x) * plane;

  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < plane;
       p += gridDim.x * blockDim.x) {
    const int yl = p / nzh;
    const int z = p - yl * nzh;
    const int y = yl + y_off;
    const float ky = ky_scale * static_cast<float>(rf::signed_index(y, ny));
    const float kz = kz_scale * static_cast<float>(z);
    const float ksq = rf::sampler_ksq(kx, ky, kz);
    float sig = 0.f;
    if (ksq > 0.f) {
      sig = rf::interp_sigma(tab, n_knots, rf::log10_k(ksq, half_inv_ln10),
                             lk0, inv_dlk);
    }
    const uint2 b = rf::mode_bits(k0, k1, first + p);
    const float r = sqrtf(-2.f * logf(rf::uniform_u1(b.x)));
    const float theta = 6.28318530717958648f * rf::uniform_u2(b.y);
    float s, c;
    sincosf(theta, &s, &c);
    float amp = sig * 0.70710678118654752f;
    if (smoothing != 0.f) {
      amp = amp * expf(-0.5f * ksq * smoothing * smoothing);
    }
    rp[p] = amp * (r * c);
    ip[p] = amp * (r * s);
  }
}

}  // namespace

// re, im: float32 (nx, ny_loc, nzh) outputs, contiguous, the ky rows
// [y_off, y_off + ny_loc) of an (nx, ny, nzh) spectrum (K1: y_off = 0,
// ny_loc = ny).  knots: float32 (n_knots,), n_knots >= 2.  (k0, k1): the
// seed's stream key.  k_scale = 2 pi / (spacing * n) per axis and the table
// constants, rounded to float32 as the TPU kernel rounds them.  Returns the
// CUDA error of the launch.
extern "C" int rf_sample_modes(void* re, void* im, const void* knots,
                               int n_knots, int nx, int ny, int nzh,
                               int y_off, int ny_loc, uint32_t k0,
                               uint32_t k1, float kx_scale, float ky_scale,
                               float kz_scale, float half_inv_ln10, float lk0,
                               float inv_dlk, float smoothing, void* stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(n_knots);
  cudaError_t err = cudaFuncSetAttribute(
      sample_modes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int plane = ny_loc * nzh;
  int per_plane = (plane + kThreads - 1) / kThreads;
  if (per_plane > kMaxBlocksPerPlane) per_plane = kMaxBlocksPerPlane;
  const dim3 grid(static_cast<unsigned>(per_plane), static_cast<unsigned>(nx));
  sample_modes_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(re), static_cast<float*>(im),
      static_cast<const float*>(knots), n_knots, nx, ny, nzh, y_off, ny_loc,
      k0, k1, kx_scale, ky_scale, kz_scale, half_inv_ln10, lk0, inv_dlk,
      smoothing);
  return static_cast<int>(cudaGetLastError());
}
