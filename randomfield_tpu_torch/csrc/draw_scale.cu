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
//    k2_amplitude_ksq, the arithmetic of scale_sigma.cu) at the mode's own
//    |k|^2, summed (kx^2 + ky^2) + kz^2.
//
// Unit mode skips 3 and 4 and writes the raw unit normals (generate_noise);
// bits mode writes step 1's bits, for checking the hash alone.  Fixed mode
// (generate_fixed_field, Angulo & Pontzen 2016; the JAX package computes it
// in XLA, randomfield_tpu/ops/sample.py:258-263) replaces each mode after
// step 3 by z / |z|, |z| = sqrt(re^2 + im^2) rounded as written (1 where
// |z| = 0; a self-conjugate mode becomes its sign), before step 4 with gain
// 1, or -1 for the paired field, so |c| is sigma times the filter exactly.
// z / |z| is phase.cuh:unit_phase, shared with KN: the fast paths of
// sqrt.rn and div.rn alone, one reciprocal for both components and the
// guard as selects, equal to the correctly rounded operations bit for bit.
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
// What bounds it on the H100: the instruction issue rate.  It writes 8
// bytes a mode (4.303 GB at 1024^3, 1.285 ms at 3.35 TB/s) and hashes twice
// a mode, about 150 32-bit integer operations, plus two log1pf and the
// erfinv polynomial, and a logf (and expf) for sigma.  Design, to issue
// fewer instructions a mode (the walk of K1, sample_modes.cu):
// - a thread draws the x rows gx and px = (-gx) mod nx of one ky row
//   together: the two share |k|^2 bit for bit (signed_index negates), so
//   one amplitude (the logf, the lookup, the filter) serves two modes; each
//   row keeps its own chunk key (gx and px may lie in different chunks), so
//   the pair runs four independent hashes; and a plane mode's partner lies
//   in the other row of its pair, so the plane fix selects between the
//   pair's own keys and counters;
// - a warp walks a row pair's kz with its 32 lanes on 32 consecutive kz:
//   the stores stay coalesced, there is no division a mode, kz^2 comes from
//   a table in shared memory, and the rows' keys, counters and partner
//   selection are computed once a row; only the 32 kz that hold a plane
//   (kz = 0, and the Nyquist kz) run the plane fix's selections;
// - the kz left over when nz/2 + 1 is not a multiple of 32 (the Nyquist
//   column at 1024^3) are drawn one lane per row pair over the warp's 32
//   row pairs;
// - the counter is 32-bit where every counter of a chunk fits (2 cx nzh ny
//   <= 2^32: 6.7e7 at 1024^3), so the hash's high word is the constant 0;
//   the launcher picks the 64-bit instance for grids where it does not fit;
// - erfinv's tail polynomial is a branch taken by 0.34% of the draws, and
//   its log1pf is libdevice's without the branch for arguments outside
//   (-1, 0] (threefry.cuh:erfinv_xla, log1pf_neg).
// Rows x = 0 and nx/2 pair with themselves and are drawn once; in a block
// of x rows, the rows of a pair outside it are drawn and not stored.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "hermitian.cuh"
#include "phase.cuh"
#include "sigma_common.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPairsPerWarp = 32;  // row pairs a warp owns: one per lane
constexpr int kMaxChunks = 16;     // ops/sample.py:CANONICAL_CHUNK_TARGET

enum Mode : int { kSpectrum = 0, kUnit = 1, kBits = 2, kFixed = 3 };

// The modes that fix the planes and scale: the spectrum and the fixed field.
__host__ __device__ constexpr bool scaled(int mode) {
  return mode == kSpectrum || mode == kFixed;
}

struct ChunkKeys {
  uint32_t k0[kMaxChunks];
  uint32_t k1[kMaxChunks];
};

struct Params {
  float* re;
  float* im;
  const float* tab;  // the knots, in shared memory
  const float* kz2;  // (kz_scale kz)^2 for kz in [0, nzh), in shared memory
  unsigned long long c_stride;  // cx nzh ny: the im draws' counter offset
  int n_knots, cx, nx, ny, nzh, top, x_off, nx_loc, y_off, ny_loc;
  float kx_scale, ky_scale, half_inv_ln10, lk0, inv_dlk, smoothing, gain;
};

// The rows x[0] = gx and x[1] = (-gx) mod nx of ky row y, gx <= nx / 2,
// and their modes' counters: within a chunk of cx x rows the counter of
// (x, y, kz) is (x mod cx) nzh ny + kz ny + y, and the im draw's is cx nzh
// ny further.  WIDE: 64-bit counters (a chunk of more than 2^32 draws).
template <int MODE, bool WIDE>
struct RowPair {
  using Counter =
      typename std::conditional<WIDE, unsigned long long, uint32_t>::type;
  uint32_t k0[2], k1[2];  // each row's chunk key
  Counter base[2];        // each row's counter at kz = 0
  Counter to_py;          // (-y) mod ny - y: a plane partner's counter shift
  float kxy;              // kx^2 + ky^2, the pair's
  bool nc[2], sc[2];      // not canonical / self-conjugate on a plane
  bool live[2];           // stored: inside the block, row 1 not row 0
  float* rp[2];
  float* ip[2];

  __device__ __forceinline__ RowPair(const Params& p, const ChunkKeys& keys,
                                     int q) {
    const int gx = q / p.ny_loc;
    const int yl = q - gx * p.ny_loc;
    const int y = yl + p.y_off;
    const int x[2] = {gx, rf::partner_index(gx, p.nx)};
    const int py = rf::partner_index(y, p.ny);
    const float kx =
        p.kx_scale * static_cast<float>(rf::signed_index(gx, p.nx));
    const float ky = p.ky_scale * static_cast<float>(rf::signed_index(y, p.ny));
    kxy = __fadd_rn(__fmul_rn(kx, kx), __fmul_rn(ky, ky));
    to_py = static_cast<Counter>(py) - static_cast<Counter>(y);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ci = x[r] / p.cx;
      k0[r] = keys.k0[ci];
      k1[r] = keys.k1[ci];
      base[r] = static_cast<Counter>(x[r] - ci * p.cx) *
                    static_cast<Counter>(p.nzh) * static_cast<Counter>(p.ny) +
                static_cast<Counter>(y);
      // the partner of row r is the pair's other row
      nc[r] = rf::not_canonical(x[r], y, x[1 - r], py);
      sc[r] = rf::self_conjugate(x[r], y, x[1 - r], py);
      live[r] = p.x_off <= x[r] && x[r] < p.x_off + p.nx_loc;
      const long long out =
          (static_cast<long long>(x[r] - p.x_off) * p.ny_loc + yl) * p.nzh;
      rp[r] = p.re + out;
      ip[r] = p.im + out;
    }
    live[1] = live[1] && x[1] != x[0];
  }

  // Draw, fix, scale and store both rows' mode at kz = z.  PLANES: z may
  // be a plane's (0 or the Nyquist kz); without it the draw has no
  // selection to make.
  template <bool PLANES>
  __device__ __forceinline__ void draw(const Params& p, int z) const {
    const Counter zc = static_cast<Counter>(z) * static_cast<Counter>(p.ny);
    const Counter c_stride = static_cast<Counter>(p.c_stride);
    const bool fixed =
        PLANES && scaled(MODE) && (z == 0 || z == p.top);
    uint32_t bre[2], bim[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // a plane mode that is not canonical hashes its partner's counters:
      // the other row's, at (-y) mod ny
      const bool partner = fixed && nc[r];
      const Counter idx = (partner ? base[1 - r] + to_py : base[r]) + zc;
      const uint32_t c0 = partner ? k0[1 - r] : k0[r];
      const uint32_t c1 = partner ? k1[1 - r] : k1[r];
      bre[r] = rf::jax_bits(c0, c1, idx);
      bim[r] = rf::jax_bits(c0, c1, static_cast<Counter>(idx + c_stride));
    }
    if (MODE == kBits) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (live[r]) {
          reinterpret_cast<uint32_t*>(rp[r])[z] = bre[r];
          reinterpret_cast<uint32_t*>(ip[r])[z] = bim[r];
        }
      }
      return;
    }
    float amp = 0.f;
    if (scaled(MODE)) {
      amp = rf::k2_amplitude_ksq(p.tab, p.n_knots, __fadd_rn(kxy, p.kz2[z]),
                                 p.half_inv_ln10, p.lk0, p.inv_dlk,
                                 p.smoothing, p.gain);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float vre = rf::jax_normal(bre[r]);
      float vim = rf::jax_normal(bim[r]);
      if (scaled(MODE)) {
        if (fixed && nc[r]) vim = -vim;
        if (fixed && sc[r]) {
          vre = __fmul_rn(vre, rf::kSqrt2);
          vim = 0.f;
        }
        if (MODE == kFixed) rf::unit_phase(vre, vim);
        vre = __fmul_rn(vre, amp);
        vim = __fmul_rn(vim, amp);
      }
      if (live[r]) {
        rp[r][z] = vre;
        ip[r][z] = vim;
      }
    }
  }
};

template <int MODE, bool WIDE>
__global__ void __launch_bounds__(kThreads, 4)
draw_scale_kernel(Params args, float kz_scale,
                  const __grid_constant__ ChunkKeys keys) {
  extern __shared__ float smem[];
  Params p = args;
  p.tab = smem;
  p.kz2 = smem + p.n_knots;
  if (scaled(MODE)) {
    float* kz2 = smem + p.n_knots;
    for (int z = threadIdx.x; z < p.nzh; z += blockDim.x) {
      const float kz = kz_scale * static_cast<float>(z);
      kz2[z] = __fmul_rn(kz, kz);
    }
    rf::load_knots(smem, args.tab, p.n_knots);  // and the block's barrier
  }

  const int lane = threadIdx.x & 31;
  const int n_pairs = (p.nx / 2 + 1) * p.ny_loc;
  const int bulk = p.nzh & ~31;  // the kz a warp draws 32 at a time
  // the 32 kz that hold the Nyquist plane, when the bulk holds it (nz/2 + 1
  // a multiple of 32); the first 32 hold kz = 0
  const int top32 = p.top >= 32 && p.top < bulk ? p.top & ~31 : bulk;
  const int stride = gridDim.x * kWarps * kPairsPerWarp;
  for (int g = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kPairsPerWarp;
       g < n_pairs; g += stride) {
    const int end = min(g + kPairsPerWarp, n_pairs);
    for (int q = g; q < end; ++q) {
      const RowPair<MODE, WIDE> rows(p, keys, q);
      if (bulk > 0) rows.template draw<true>(p, lane);
      for (int z = 32 + lane; z < top32; z += 32) {
        rows.template draw<false>(p, z);
      }
      if (top32 < bulk) rows.template draw<true>(p, top32 + lane);
    }
    if (bulk < p.nzh && g + lane < end) {
      const RowPair<MODE, WIDE> rows(p, keys, g + lane);
      for (int z = bulk; z < p.nzh; ++z) rows.template draw<true>(p, z);
    }
  }
}

template <int MODE, bool WIDE>
cudaError_t launch(const Params& p, float kz_scale, const ChunkKeys& keys,
                   cudaStream_t stream) {
  const size_t smem =
      scaled(MODE)
          ? sizeof(float) * (static_cast<size_t>(p.n_knots) + p.nzh)
          : 0;
  cudaError_t err = cudaFuncSetAttribute(
      draw_scale_kernel<MODE, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long groups =
      (static_cast<long long>(p.nx / 2 + 1) * p.ny_loc + kPairsPerWarp - 1) /
      kPairsPerWarp;
  long long blocks = (groups + kWarps - 1) / kWarps;
  if (blocks > 65535) blocks = 65535;  // the warps then stride over the rest
  draw_scale_kernel<MODE, WIDE>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p, kz_scale,
                                                                  keys);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mode(const Params& p, float kz_scale,
                        const ChunkKeys& keys, cudaStream_t stream) {
  // every counter of a chunk, im draws included, is below 2 cx nzh ny
  const bool wide = 2ull * p.c_stride > (1ull << 32);
  return wide ? launch<MODE, true>(p, kz_scale, keys, stream)
              : launch<MODE, false>(p, kz_scale, keys, stream);
}

__global__ void unit_phase_kernel(const float* __restrict__ re,
                                  const float* __restrict__ im,
                                  float* __restrict__ out_re,
                                  float* __restrict__ out_im, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i < n) {
    float a = re[i], b = im[i];
    rf::unit_phase(a, b);
    out_re[i] = a;
    out_im[i] = b;
  }
}

__global__ void jax_normal_kernel(const uint32_t* __restrict__ bits,
                                  float* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i < n) out[i] = rf::jax_normal(bits[i]);
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
// factor folded into the amplitude (a render passes 1/sqrt(2); the fixed
// field 1, the paired field -1).  mode: 0 spectrum, 1 unit normals, 2 bits,
// 3 fixed.  Returns the CUDA error of the launch.
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
  const int nzh = nz / 2 + 1;
  Params p{static_cast<float*>(re), static_cast<float*>(im),
           static_cast<const float*>(knots), nullptr,
           static_cast<unsigned long long>(cx) * nzh * ny, n_knots, cx, nx,
           ny, nzh, nz % 2 == 0 ? nzh - 1 : 0, x_off, nx_loc, y_off, ny_loc,
           kx_scale, ky_scale, half_inv_ln10, lk0, inv_dlk, smoothing, gain};
  auto* s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case kSpectrum:
      err = launch_mode<kSpectrum>(p, kz_scale, keys, s);
      break;
    case kUnit:
      err = launch_mode<kUnit>(p, kz_scale, keys, s);
      break;
    case kBits:
      err = launch_mode<kBits>(p, kz_scale, keys, s);
      break;
    case kFixed:
      err = launch_mode<kFixed>(p, kz_scale, keys, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// jax_normal of each of n uint32 words, as the kernels above map their bits:
// a check of the device function alone (the exhaustive comparison in
// chip_smoke.py), on no render's path.  bits: uint32 (n,); out: float32
// (n,).  Returns the CUDA error of the launch.
extern "C" int rf_jax_normal(const void* bits, void* out, long long n,
                             void* stream) {
  if (n <= 0) return 0;
  constexpr int threads = 256;
  jax_normal_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                      threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// rf::unit_phase of each of n pairs (re, im), as the fixed modes map their
// modes: a check of the device function alone (chip_smoke.py holds it to
// torch's sqrt and division), on no render's path.  re, im, out_re, out_im:
// float32 (n,).  Returns the CUDA error of the launch.
extern "C" int rf_unit_phase(const void* re, const void* im, void* out_re,
                             void* out_im, long long n, void* stream) {
  if (n <= 0) return 0;
  constexpr int threads = 256;
  unit_phase_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                      threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<float*>(out_re), static_cast<float*>(out_im), n);
  return static_cast<int>(cudaGetLastError());
}
