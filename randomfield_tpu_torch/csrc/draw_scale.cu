// K2, fused with its draws: the default sampler='threefry' spectrum drawn,
// made Hermitian and scaled in one pass over an 'xyz' (nx_loc, ny_loc,
// nz/2 + 1) block of the packed half-spectrum, reading nothing but the knots.
// Per mode (x, y, kz):
//
// 1. the counter of the canonical stream (ops/sample.py): chunk i = x / cx
//    of canonical_chunks(nx) x slabs, key fold_in(key(seed), i) (the host
//    hashes the at most 16 chunk keys and passes them by value), flat index
//    ((c cx + x mod cx) nzh + kz) ny + y of the (2, cx, nzh, ny) chunk,
//    c = 0 for re and 1 for im, bits = jax.random.bits there
//    (threefry.cuh:jax_bits);
// 2. jax.random.normal's float32 value of those bits (threefry.cuh:
//    jax_normal, XLA's erfinv);
// 3. on kz = 0, and on kz = nz/2 for even nz, the Hermitian fix in the
//    thread (hermitian.cuh, ops/grid.py:hermitian_plane_masks): a mode
//    that is not canonical draws its partner's counters at ((-x) mod nx,
//    (-y) mod ny)
//    and stores (re', -im'); a self-conjugate mode stores (re sqrt(2), 0).
//    The stream is counter-based, so the partner's draw needs no other
//    thread, no second pass and, on a slab mesh, no exchange;
// 4. K2's amplitude sigma(|k|) exp(-k^2 s^2 / 2) gain (sigma_common.cuh:
//    k2_amplitude, the arithmetic of scale_sigma.cu) at the mode's own k.
//
// Unit mode skips 3 and 4 and writes the raw unit normals (generate_noise);
// bits mode writes step 1's bits, for checking the hash alone.
//
// Replaces randomfield_tpu/ops/pallas_sampler.py:_scale_jit_reim together
// with the jax.random draw in front of it (randomfield_tpu/engine/staged.py:
// 214, _stage_p1_unit, and its Hermitian fix), and, at a shard's offsets,
// pallas_sampler.py:scale_shard_pallas_reim (K7) together with the sharded
// fix the JAX mesh lowers to collective permutes.  Every product and sum of
// steps 2-4 is rounded as written, so on the card the kernel equals the
// plain PyTorch chain (ops/sample.py:unit_draws_reim ->
// ops/transform.py:symmetrize_with_shape_reim -> ops/sampler.py:
// scale_sigma_plain) bit for bit.
//
// What bounds it on the H100: operations.  It writes 8 bytes a mode (4.303
// GB at 1024^3, 1.285 ms at 3.35 TB/s) and hashes twice a mode, about 150
// 32-bit integer operations, plus two log1pf and the erfinv polynomials, and
// a logf (and expf) for sigma.  Design: blockIdx.y is the x plane, so the
// chunk keys of the plane and of its partner plane, the counter's x part and
// kx are computed once per block; the threads stride over the plane's
// (y, kz) modes, which lie contiguous in the output, so the stores are
// coalesced.  The two hashes of a mode are independent (ILP 2); the plane
// fix is a selection of the counter's coordinates, not a branch.
#include <cstdint>

#include <cuda_runtime.h>

#include "hermitian.cuh"
#include "sigma_common.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksPerPlane = 32;
constexpr int kMaxChunks = 16;  // ops/sample.py:CANONICAL_CHUNK_TARGET

enum Mode : int { kSpectrum = 0, kUnit = 1, kBits = 2 };

struct ChunkKeys {
  uint32_t k0[kMaxChunks];
  uint32_t k1[kMaxChunks];
};

template <int MODE>
__global__ void __launch_bounds__(kThreads)
draw_scale_kernel(float* __restrict__ re, float* __restrict__ im,
                  const float* __restrict__ knots, int n_knots,
                  const __grid_constant__ ChunkKeys keys, int cx, int nx,
                  int ny, int nz, int x_off, int y_off, int ny_loc,
                  float kx_scale, float ky_scale, float kz_scale,
                  float half_inv_ln10, float lk0, float inv_dlk,
                  float smoothing, float gain) {
  extern __shared__ float tab[];
  if (MODE == kSpectrum) rf::load_knots(tab, knots, n_knots);

  const int nzh = nz / 2 + 1;
  const int top = nz % 2 == 0 ? nzh - 1 : 0;  // the Nyquist plane, if any
  const int plane = ny_loc * nzh;
  const int gx = static_cast<int>(blockIdx.y) + x_off;
  const int px = rf::partner_index(gx, nx);
  const int ci = gx / cx;
  const int pci = px / cx;
  const uint32_t ok0 = keys.k0[ci], ok1 = keys.k1[ci];
  const uint32_t pk0 = keys.k0[pci], pk1 = keys.k1[pci];
  // counters: c * c_stride + row + kz ny + y within the chunk
  const unsigned long long c_stride =
      static_cast<unsigned long long>(cx) * nzh * ny;
  const unsigned long long orow =
      static_cast<unsigned long long>(gx - ci * cx) * nzh * ny;
  const unsigned long long prow =
      static_cast<unsigned long long>(px - pci * cx) * nzh * ny;
  const float kx = kx_scale * static_cast<float>(rf::signed_index(gx, nx));
  const float kx2 = kx * kx;
  float* rp = re + static_cast<long long>(blockIdx.y) * plane;
  float* ip = im + static_cast<long long>(blockIdx.y) * plane;

  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < plane;
       p += gridDim.x * blockDim.x) {
    const int yl = p / nzh;
    const int z = p - yl * nzh;
    const int gy = yl + y_off;
    const int py = rf::partner_index(gy, ny);
    const bool fixed = MODE == kSpectrum && (z == 0 || z == top);
    const bool partner = fixed && rf::not_canonical(gx, gy, px, py);
    const bool self_conj = fixed && rf::self_conjugate(gx, gy, px, py);
    const unsigned long long idx =
        (partner ? prow : orow) + static_cast<unsigned long long>(z) * ny +
        static_cast<unsigned>(partner ? py : gy);
    const uint32_t k0 = partner ? pk0 : ok0;
    const uint32_t k1 = partner ? pk1 : ok1;
    const uint32_t bre = rf::jax_bits(k0, k1, idx);
    const uint32_t bim = rf::jax_bits(k0, k1, idx + c_stride);
    if (MODE == kBits) {
      reinterpret_cast<uint32_t*>(rp)[p] = bre;
      reinterpret_cast<uint32_t*>(ip)[p] = bim;
      continue;
    }
    float vre = rf::jax_normal(bre);
    float vim = rf::jax_normal(bim);
    if (MODE == kSpectrum) {
      if (partner) vim = -vim;
      if (self_conj) {
        vre = __fmul_rn(vre, rf::kSqrt2);
        vim = 0.f;
      }
      const float ky =
          ky_scale * static_cast<float>(rf::signed_index(gy, ny));
      const float kz = kz_scale * static_cast<float>(z);
      const float amp = rf::k2_amplitude(tab, n_knots, kx2, ky, kz,
                                         half_inv_ln10, lk0, inv_dlk,
                                         smoothing, gain);
      vre = __fmul_rn(vre, amp);
      vim = __fmul_rn(vim, amp);
    }
    rp[p] = vre;
    ip[p] = vim;
  }
}

template <int MODE>
cudaError_t launch(float* re, float* im, const float* knots, int n_knots,
                   const ChunkKeys& keys, int cx, int nx, int ny, int nz,
                   int x_off, int nx_loc, int y_off, int ny_loc,
                   float kx_scale, float ky_scale, float kz_scale,
                   float half_inv_ln10, float lk0, float inv_dlk,
                   float smoothing, float gain, cudaStream_t stream) {
  const size_t smem =
      MODE == kSpectrum ? sizeof(float) * static_cast<size_t>(n_knots) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      draw_scale_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int plane = ny_loc * (nz / 2 + 1);
  int per_plane = (plane + kThreads - 1) / kThreads;
  if (per_plane > kMaxBlocksPerPlane) per_plane = kMaxBlocksPerPlane;
  const dim3 grid(static_cast<unsigned>(per_plane),
                  static_cast<unsigned>(nx_loc));
  draw_scale_kernel<MODE><<<grid, kThreads, smem, stream>>>(
      re, im, knots, n_knots, keys, cx, nx, ny, nz, x_off, y_off, ny_loc,
      kx_scale, ky_scale, kz_scale, half_inv_ln10, lk0, inv_dlk, smoothing,
      gain);
  return cudaGetLastError();
}

}  // namespace

// re, im: float32 (nx_loc, ny_loc, nz/2 + 1) outputs, contiguous, covering
// x rows [x_off, x_off + nx_loc) and y rows [y_off, y_off + ny_loc) of an
// (nx, ny, nz) scene (bits mode: uint32 bits in the same storage).  knots:
// float32 (n_knots,), n_knots >= 2 (read in spectrum mode only).
// chunk_keys: HOST uint32 array of the n_chunks (<= 16) chunk keys
// fold_in(key(seed), i), all k0 words and then all k1 words; n_chunks
// divides nx.  k_scale = 2 pi / (spacing * n) per axis and the table
// constants rounded to float32 as for rf_scale_sigma; gain is the float32
// factor folded into the amplitude (a render passes 1/sqrt(2)).  mode: 0
// spectrum, 1 unit normals, 2 bits.  Returns the CUDA error of the launch.
extern "C" int rf_draw_scale(void* re, void* im, const void* knots,
                             int n_knots, const void* chunk_keys,
                             int n_chunks, int nx, int ny, int nz, int x_off,
                             int nx_loc, int y_off, int ny_loc,
                             float kx_scale, float ky_scale, float kz_scale,
                             float half_inv_ln10, float lk0, float inv_dlk,
                             float smoothing, float gain, int mode,
                             void* stream) {
  if (n_chunks < 1 || n_chunks > kMaxChunks || nx % n_chunks != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ChunkKeys keys = {};
  const uint32_t* host = static_cast<const uint32_t*>(chunk_keys);
  for (int i = 0; i < n_chunks; ++i) {
    keys.k0[i] = host[i];
    keys.k1[i] = host[n_chunks + i];
  }
  const int cx = nx / n_chunks;
  auto* r = static_cast<float*>(re);
  auto* m = static_cast<float*>(im);
  auto* k = static_cast<const float*>(knots);
  auto* s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case kSpectrum:
      err = launch<kSpectrum>(r, m, k, n_knots, keys, cx, nx, ny, nz, x_off,
                              nx_loc, y_off, ny_loc, kx_scale, ky_scale,
                              kz_scale, half_inv_ln10, lk0, inv_dlk,
                              smoothing, gain, s);
      break;
    case kUnit:
      err = launch<kUnit>(r, m, k, n_knots, keys, cx, nx, ny, nz, x_off,
                          nx_loc, y_off, ny_loc, kx_scale, ky_scale, kz_scale,
                          half_inv_ln10, lk0, inv_dlk, smoothing, gain, s);
      break;
    case kBits:
      err = launch<kBits>(r, m, k, n_knots, keys, cx, nx, ny, nz, x_off,
                          nx_loc, y_off, ny_loc, kx_scale, ky_scale, kz_scale,
                          half_inv_ln10, lk0, inv_dlk, smoothing, gain, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
