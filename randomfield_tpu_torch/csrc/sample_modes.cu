// K1: the sampler='pallas' spectrum, drawn, made Hermitian and scaled in one
// pass.  Per mode of the packed 'xyz' (nx, ny, nz/2 + 1) half-spectrum:
// Threefry-2x32 bits of the flat mode index (threefry.cuh) -> 24-bit
// uniforms -> Box-Muller -> sigma(|k|) (sigma_common.cuh) / sqrt(2) -> the
// filter exp(-k^2 s^2 / 2) when s != 0 -> re and im, with DC = 0.  On the
// kz = 0 plane and, for even nz, the Nyquist plane the Hermitian fix runs in
// the thread (hermitian.cuh): a mode that is not canonical draws its
// partner's counter and stores (re', -im'); a self-conjugate mode stores
// (re sqrt(2), 0), re rounded before the factor as
// ops/transform.py:symmetrize_plane_reim rounds it.  The partner's |k|^2
// equals the mode's own bit for bit (signed_index negates), so the
// partner's draw takes the mode's own amplitude.
//
// Replaces randomfield_tpu/ops/pallas_sampler.py:_make_kernel with
// bins=None, via _sample_jit_reim / sample_spectrum_pallas_reim, together
// with the Hermitian fix after it.  The same float32 operations in the same
// order: u1 = (b1 >> 8) 2^-24 + 2^-25, u2 = (b2 >> 8) 2^-24, r = sqrt(-2 ln
// u1), theta = 2 pi u2, base = sigma / sqrt(2), amp = base exp(((-k^2 / 2)
// s) s), re = amp (r cos theta), im = amp (r sin theta); |k|^2 summed as
// the TPU's 'xzy' tile sums it, (kx^2 + kz^2) + ky^2.  Accurate logf,
// sqrtf and sincosf (no fast math).  The TPU kernel draws from its hardware
// PRNG per tile, which nothing else can replay; this one draws the
// counter-based stream of ops/modestream.py.
//
// K8, the same kernel over the ky rows [y_off, y_off + ny_loc) of a slab
// mesh's shard, replaces pallas_sampler.py:sample_shard_pallas_reim (the
// _make_kernel shard mode) and the sharded fix after it.  Every mode hashes
// its global flat 'xyz' counter (x ny + y) nzh + z and takes its global |k|,
// and a plane mode whose partner row lies on another rank draws the
// partner's counter itself, so the shards' union is the whole-grid K1
// output bit for bit with no exchange.
//
// What bounds it on the H100: the instruction issue rate.  It reads nothing
// per mode and writes the two float32 lattices once (8 bytes a mode, 4.303
// GB at 1024^3, 1.284 ms at 3.35 TB/s); per mode it issues the hash (about
// 75 integer instructions), a logf, a sqrtf and a sincosf, and for the
// amplitude a logf, the table lookup and (smoothing) an expf.  Design, to
// issue fewer instructions a mode:
// - a thread draws the x rows x and (-x) mod nx of one ky row together: the
//   two share |k|^2, so the amplitude (the logf, the lookup, the filter) is
//   computed once for two modes, and the two hashes are independent;
// - a warp walks a row pair's kz with its 32 lanes on 32 consecutive kz,
//   so the stores stay coalesced and the row's ky, counters and partner
//   selection are computed once a row, not a mode (no division a mode);
//   kz^2 comes from a table in shared memory;
// - the kz left over when nz/2 + 1 is not a multiple of 32 (the Nyquist
//   column at 1024^3) are drawn lane by row pair over the warp's 32 row
//   pairs, so no iteration runs with one lane in 32;
// - the plane fix is a selection of the counter and two selects after the
//   draw, not a branch or a second hash.
// The mode index is 64-bit (2048^3 has more than 2^32 modes).
#include <cstdint>

#include <cuda_runtime.h>

#include "hermitian.cuh"
#include "sigma_common.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPairsPerWarp = 32;  // row pairs a warp owns: one per lane

struct Params {
  float* re;
  float* im;
  const float* tab;  // the knots, in shared memory
  const float* kz2;  // (kz_scale kz)^2 for kz in [0, nzh), in shared memory
  int n_knots, nx, ny, nzh, top, y_off, ny_loc;
  uint32_t k0, k1;
  float kx_scale, ky_scale, half_inv_ln10, lk0, inv_dlk, smoothing;
};

// The rows x and (-x) mod nx of ky row y (one row when the two coincide,
// x = 0 or nx/2: both slots then hold it, and it is drawn twice, the same
// values to the same places).
struct RowPair {
  float kx2, ky2;
  unsigned long long base[2];   // own counter at kz = 0
  unsigned long long pbase[2];  // the plane partner's counter at kz = 0
  bool nc[2], sc[2];            // not canonical / self-conjugate on a plane
  long long out[2];             // output offset at kz = 0

  __device__ __forceinline__ RowPair(const Params& p, int q) {
    const int xp = q / p.ny_loc;
    const int yl = q - xp * p.ny_loc;
    const int y = yl + p.y_off;
    const int x[2] = {xp, rf::partner_index(xp, p.nx)};
    const int py = rf::partner_index(y, p.ny);
    const float kx =
        p.kx_scale * static_cast<float>(rf::signed_index(xp, p.nx));
    const float ky = p.ky_scale * static_cast<float>(rf::signed_index(y, p.ny));
    kx2 = __fmul_rn(kx, kx);
    ky2 = __fmul_rn(ky, ky);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int px = x[1 - r];  // (-x) mod nx of this row is the other row
      base[r] = (static_cast<unsigned long long>(x[r]) * p.ny + y) * p.nzh;
      pbase[r] = (static_cast<unsigned long long>(px) * p.ny + py) * p.nzh;
      nc[r] = rf::not_canonical(x[r], y, px, py);
      sc[r] = rf::self_conjugate(x[r], y, px, py);
      out[r] = (static_cast<long long>(x[r]) * p.ny_loc + yl) * p.nzh;
    }
  }

  // Draw, fix and store both rows' mode at kz = z.
  __device__ __forceinline__ void draw(const Params& p, int z) const {
    const float ksq = __fadd_rn(__fadd_rn(kx2, p.kz2[z]), ky2);
    float sig = 0.f;
    if (ksq > 0.f) {
      sig = rf::interp_sigma(p.tab, p.n_knots,
                             rf::log10_k(ksq, p.half_inv_ln10), p.lk0,
                             p.inv_dlk);
    }
    float amp = sig * 0.70710678118654752f;
    if (p.smoothing != 0.f) {
      amp = amp * expf(-0.5f * ksq * p.smoothing * p.smoothing);
    }
    const bool fixed = z == 0 || z == p.top;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool partner = fixed && nc[r];
      const uint2 b =
          rf::mode_bits(p.k0, p.k1, (partner ? pbase[r] : base[r]) + z);
      const float rr = sqrtf(-2.f * logf(rf::uniform_u1(b.x)));
      const float theta = 6.28318530717958648f * rf::uniform_u2(b.y);
      float s, c;
      sincosf(theta, &s, &c);
      float vre = amp * (rr * c);
      float vim = amp * (rr * s);
      if (partner) vim = -vim;
      if (fixed && sc[r]) {
        vre = __fmul_rn(vre, rf::kSqrt2);
        vim = 0.f;
      }
      p.re[out[r] + z] = vre;
      p.im[out[r] + z] = vim;
    }
  }
};

__global__ void __launch_bounds__(kThreads)
sample_modes_kernel(float* __restrict__ re, float* __restrict__ im,
                    const float* __restrict__ knots, int n_knots, int nx,
                    int ny, int nz, int y_off, int ny_loc, uint32_t k0,
                    uint32_t k1, float kx_scale, float ky_scale,
                    float kz_scale, float half_inv_ln10, float lk0,
                    float inv_dlk, float smoothing) {
  extern __shared__ float smem[];
  const int nzh = nz / 2 + 1;
  float* kz2 = smem + n_knots;
  for (int z = threadIdx.x; z < nzh; z += blockDim.x) {
    const float kz = kz_scale * static_cast<float>(z);
    kz2[z] = __fmul_rn(kz, kz);
  }
  rf::load_knots(smem, knots, n_knots);  // and the block's barrier

  const Params p{re, im, smem, kz2, n_knots, nx, ny, nzh,
                 nz % 2 == 0 ? nzh - 1 : 0, y_off, ny_loc, k0, k1,
                 kx_scale, ky_scale, half_inv_ln10, lk0, inv_dlk, smoothing};
  const int lane = threadIdx.x & 31;
  const int n_pairs = (nx / 2 + 1) * ny_loc;
  const int bulk = nzh & ~31;  // the kz a warp draws 32 at a time
  const int stride = gridDim.x * kWarps * kPairsPerWarp;
  for (int g = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kPairsPerWarp;
       g < n_pairs; g += stride) {
    const int end = min(g + kPairsPerWarp, n_pairs);
    for (int q = g; q < end; ++q) {
      const RowPair rows(p, q);
      for (int z = lane; z < bulk; z += 32) rows.draw(p, z);
    }
    if (bulk < nzh && g + lane < end) {
      const RowPair rows(p, g + lane);
      for (int z = bulk; z < nzh; ++z) rows.draw(p, z);
    }
  }
}

}  // namespace

// re, im: float32 (nx, ny_loc, nz/2 + 1) outputs, contiguous, the ky rows
// [y_off, y_off + ny_loc) of an (nx, ny, nz/2 + 1) spectrum (K1: y_off = 0,
// ny_loc = ny), Hermitian on the kz = 0 and Nyquist planes.  knots: float32
// (n_knots,), n_knots >= 2.  (k0, k1): the seed's stream key.  k_scale =
// 2 pi / (spacing * n) per axis and the table constants, rounded to float32
// as the TPU kernel rounds them.  Returns the CUDA error of the launch.
extern "C" int rf_sample_modes(void* re, void* im, const void* knots,
                               int n_knots, int nx, int ny, int nz,
                               int y_off, int ny_loc, uint32_t k0,
                               uint32_t k1, float kx_scale, float ky_scale,
                               float kz_scale, float half_inv_ln10, float lk0,
                               float inv_dlk, float smoothing, void* stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(n_knots) + nz / 2 + 1);
  cudaError_t err = cudaFuncSetAttribute(
      sample_modes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long groups =
      (static_cast<long long>(nx / 2 + 1) * ny_loc + kPairsPerWarp - 1) /
      kPairsPerWarp;
  long long blocks = (groups + kWarps - 1) / kWarps;
  if (blocks > 65535) blocks = 65535;  // the warps then stride over the rest
  sample_modes_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(re), static_cast<float*>(im),
      static_cast<const float*>(knots), n_knots, nx, ny, nz, y_off, ny_loc,
      k0, k1, kx_scale, ky_scale, kz_scale, half_inv_ln10, lk0, inv_dlk,
      smoothing);
  return static_cast<int>(cudaGetLastError());
}
