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
//
// KN, the same kernel on the resolution-nested stream of sampler='nested'
// (ops/sample.py:nested_unit_draws; the JAX package draws it in XLA, not in
// Pallas).  What differs from K1, mode by mode:
// - the key is key(seed) itself, with no stream tag folded in, and the
//   counter words are (code, 0), code = (sx & 1023) << 20 | (sy & 1023) << 10
//   | kz of the signed lattice indices (sx, sy) (the Nyquist row is -n/2),
//   so grids of different size over one box share every common mode;
// - both uniforms carry the half-ulp offset, u = (b >> 8) 2^-24 + 2^-25;
// - a non-canonical plane mode takes its partner's draw, im negated;
// - the amplitude is K2's (sigma_common.cuh:k2_amplitude_ksq at |k|^2
//   summed (kx^2 + ky^2) + kz^2, times the gain), so the spectrum equals
//   the Hermitian fix and scale_sigma.cu applied to the unit mode's
//   normals bit for bit (generate_from_noise(generate_noise(s)) is the
//   render of s), and every product of the draw is rounded as written.
// Its modes: the spectrum (gain 1/sqrt(2)); the raw unit normals, no fix
// and no scale (generate_noise); the fixed field, z / |z| after the fix
// (phase.cuh, shared with K2F's fixed mode: 1 where |z| = 0; a
// self-conjugate mode becomes its sign), times the
// amplitude with gain 1, or -1 for the paired field; and the bits, a
// check of the hash alone.  What bounds it: K1's instruction issue, and
// once its own walk below cut that, its stores (at 1024^3 on the H100 its
// SASS a mode issue in 2.95 ms and it takes 3.56).  Its own walk:
// - a thread draws the quad of rows (+-x, +-y) of one |kx|, |ky| (one
//   amplitude for four modes); on a plane a mode's partner, (-x, -y), is in
//   the quad, and a non-canonical mode takes (re, -im) of its draw;
// - the (quad, kz) pairs in quad-major order are cut into runs of 256, one
//   a warp, its lanes on 32 consecutive kz: no tail of kz drawn lane by
//   row; at most 4 blocks an SM (fewer rows written at once measured
//   faster on the H100 than all that fit, and a persistent grid slower);
// - the counter's second word is 0 and the key fixed, so the hash's first
//   add (k0 + k1 into the code) and first rotation (of k1) are folded per
//   row and per launch (threefry.cuh:threefry2x32_w0);
// - sincos_turn: a quadrant reduction for the angles 2 pi u < 2 pi alone.
//
// KN on the ky rows [y_off, y_off + ny_loc) of a slab mesh's shard
// (nested_shard_kernel; the JAX package draws the nested stream in XLA
// under GSPMD, randomfield_tpu/parallel/render.py:196, _sampled_spectrum
// with nested=True).  On a ky slab the rows y and (-y) mod ny of a quad
// mostly lie on different ranks, so a shard quad is one local row y and
// its partner row: (x, y), (-x, y), (x, -y), (-x, -y) as above, x in
// [0, nx/2], the quads in (x, local y) order.  A row outside the shard is
// not stored; it is hashed only on the kz = 0 and Nyquist planes, where
// the fix of a stored row takes its draw (so nothing is exchanged).  Where
// both y and -y lie in the shard, the quad of the smaller one stores all
// four rows and the other quad stores nothing.  Each mode is the
// whole-grid kernel's bit for bit.
#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "hermitian.cuh"
#include "phase.cuh"
#include "sigma_common.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPairsPerWarp = 32;  // row pairs a warp owns: one per lane
// KN: the (quad, kz) elements of a warp's run, and the blocks an SM takes
// at most: 4 of the 6 (spectrum, fixed) or 8 (unit, bits) that fit, which
// measured faster (fewer rows written at once)
constexpr uint32_t kRun = 256;
constexpr int kNestedBlocksPerSM = 4;

struct Params {
  float* re;
  float* im;
  const float* tab;  // the knots, in shared memory
  const float* kz2;  // (kz_scale kz)^2 for kz in [0, nzh), in shared memory
  int n_knots, nx, ny, nzh, top, y_off, ny_loc;
  uint32_t k0, k1;
  float kx_scale, ky_scale, half_inv_ln10, lk0, inv_dlk, smoothing, gain;
  // KN: k0 + k1 and rotl(k1, 13) (threefry2x32_w0)
  uint32_t k01 = 0, rk = 0;
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

// KN's modes
enum NestedMode : int { kSpectrum = 0, kUnit = 1, kFixed = 2, kBits = 3 };

// The nested stream's code of row x, column y at kz = 0: the signed indices
// (the array index, or index - n from (n + 1) / 2 on) as 10-bit fields.
__device__ __forceinline__ uint32_t lattice_code(int x, int y, int nx,
                                                 int ny) {
  const int sx = x < (nx + 1) / 2 ? x : x - nx;
  const int sy = y < (ny + 1) / 2 ? y : y - ny;
  return (static_cast<uint32_t>(sx & 1023) << 20) |
         (static_cast<uint32_t>(sy & 1023) << 10);
}

// sin and cos of theta in [0, 2 pi], the only angles Box-Muller gives:
// the quadrant j = rint(theta 2 / pi) (a magic-number rounding), r = theta
// - j pi / 2 with pi / 2 in three float32 parts (the first product exact),
// r in [-pi / 4, pi / 4] through Cephes' sinf and cosf polynomials, then
// the quadrant's swap and signs.  No branch for large arguments, which
// sincosf carries; within 1.5 ulp of the true values (1 ulp of the
// correctly rounded ones) on every angle the 24-bit uniforms give
// (tests/test_torch_nested_quads.py replays it on all 2^24).
__device__ __forceinline__ void sincos_turn(float theta, float* s,
                                            float* c) {
  constexpr float kMagic = 12582912.f;  // 1.5 2^23: rounds to an integer
  const float t = __fmaf_rn(theta, 0x1.45f306p-1f, kMagic);
  const unsigned q = __float_as_uint(t);  // j in its low bits
  const float j = __fsub_rn(t, kMagic);
  float r = __fmaf_rn(-j, 0x1.921fb6p+0f, theta);
  r = __fmaf_rn(-j, -0x1.777a5cp-25f, r);
  r = __fmaf_rn(-j, -0x1p-49f, r);
  const float r2 = __fmul_rn(r, r);
  float ps = __fmaf_rn(-0x1.9943f2p-13f, r2, 0x1.11073cp-7f);
  ps = __fmaf_rn(ps, r2, -0x1.555546p-3f);
  ps = __fmul_rn(ps, r2);
  const float sn = __fmaf_rn(ps, r, r);
  float pc = __fmaf_rn(0x1.99eb9cp-16f, r2, -0x1.6c0c34p-10f);
  pc = __fmaf_rn(pc, r2, 0x1.55554ap-5f);
  pc = __fmaf_rn(pc, r2, -0.5f);
  const float cs = __fmaf_rn(pc, r2, 1.f);
  const bool swap = q & 1u;
  *s = __uint_as_float(__float_as_uint(swap ? cs : sn) ^ ((q & 2u) << 30));
  *c = __uint_as_float(__float_as_uint(swap ? sn : cs) ^
                       (((q + 1u) & 2u) << 30));
}

// KN's quad: the rows (x, y), (-x, y), (x, -y), (-x, -y) of one |kx|, |ky|
// (x in [0, nx/2], y in [0, ny/2]), in that order, so that on a kz = 0 or
// Nyquist plane row r's Hermitian partner is row 3 - r.  The four share
// kx^2 + ky^2, so one amplitude serves four modes.  A row that repeats an
// earlier one (x or y its own partner, 0 or n/2) is drawn but not stored,
// so each mode is written once.  Offsets are 32-bit: KN's grids (every axis
// at most 1024) hold fewer than 2^30 modes.
template <int MODE>
struct NestedQuad {
  float kxy;            // kx^2 + ky^2, the quad's
  uint32_t first[4];    // code + k0 + k1 at kz = 0: the hash's first word
                        // after its first add
  uint32_t out[4];      // output offset at kz = 0
  uint32_t nc, sc, live;  // bit r: row r not canonical on a plane /
                          // self-conjugate / stored

  __device__ __forceinline__ NestedQuad(const Params& p, int q) {
    const int nyq = p.ny / 2 + 1;
    const int x = q / nyq;
    const int y = q - x * nyq;
    const int px = rf::partner_index(x, p.nx);
    const int py = rf::partner_index(y, p.ny);
    const int xs[4] = {x, px, x, px};
    const int ys[4] = {y, y, py, py};
    const float kx = p.kx_scale * static_cast<float>(rf::signed_index(x, p.nx));
    const float ky = p.ky_scale * static_cast<float>(rf::signed_index(y, p.ny));
    kxy = __fadd_rn(__fmul_rn(kx, kx), __fmul_rn(ky, ky));
    live = 1u | (px != x ? 2u : 0u) | (py != y ? 4u : 0u) |
           (px != x && py != y ? 8u : 0u);
    nc = sc = 0u;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      first[r] = lattice_code(xs[r], ys[r], p.nx, p.ny) + p.k01;
      out[r] = (static_cast<uint32_t>(xs[r]) * p.ny + ys[r]) * p.nzh;
      nc |= rf::not_canonical(xs[r], ys[r], xs[3 - r], ys[3 - r]) ? 1u << r
                                                                   : 0u;
      sc |= rf::self_conjugate(xs[r], ys[r], xs[3 - r], ys[3 - r]) ? 1u << r
                                                                    : 0u;
    }
  }

  // Draw (and for the spectrum and fixed modes fix and scale) and store
  // the quad's modes at kz = z.
  __device__ __forceinline__ void draw(const Params& p, int z) const {
    constexpr bool kFix = MODE == kSpectrum || MODE == kFixed;
    float amp = 0.f;
    if (kFix) {
      amp = rf::k2_amplitude_ksq(p.tab, p.n_knots, __fadd_rn(kxy, p.kz2[z]),
                                 p.half_inv_ln10, p.lk0, p.inv_dlk,
                                 p.smoothing, p.gain);
    }
    float vre[4], vim[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint2 b = rf::threefry2x32_w0(p.k0, p.k1,
                                          first[r] + static_cast<uint32_t>(z),
                                          p.rk);
      if (MODE == kBits) {
        if (live & (1u << r)) {
          reinterpret_cast<uint32_t*>(p.re)[out[r] + z] = b.x;
          reinterpret_cast<uint32_t*>(p.im)[out[r] + z] = b.y;
        }
        continue;
      }
      const float rr = sqrtf(__fmul_rn(-2.f, logf(rf::uniform_u1(b.x))));
      const float theta =
          __fmul_rn(6.28318530717958648f, rf::uniform_u1(b.y));
      float s, c;
      sincos_turn(theta, &s, &c);
      vre[r] = __fmul_rn(rr, c);
      vim[r] = __fmul_rn(rr, s);
    }
    if (MODE == kBits) return;
    if (kFix) {
      if (z == 0 || z == p.top) {
        // a mode that is not canonical takes its partner's draw (row 3 - r,
        // canonical, so not changed here) with im negated; a self-conjugate
        // one re sqrt(2), im 0
        const float re0[4] = {vre[0], vre[1], vre[2], vre[3]};
        const float im0[4] = {vim[0], vim[1], vim[2], vim[3]};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (nc & (1u << r)) {
            vre[r] = re0[3 - r];
            vim[r] = -im0[3 - r];
          } else if (sc & (1u << r)) {
            vre[r] = __fmul_rn(vre[r], rf::kSqrt2);
            vim[r] = 0.f;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (MODE == kFixed) rf::unit_phase(vre[r], vim[r]);
        vre[r] = __fmul_rn(vre[r], amp);
        vim[r] = __fmul_rn(vim[r], amp);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (live & (1u << r)) {
        p.re[out[r] + z] = vre[r];
        p.im[out[r] + z] = vim[r];
      }
    }
  }
};

// KN's quad on a shard of ky rows [y_off, y_off + ny_loc): local row
// yl = q mod ny_loc, x = q / ny_loc, the rows in NestedQuad's order (row
// r's partner is row 3 - r).  Bit r of ``live``: row r lies in the shard
// and is stored by this quad; a quad whose partner row -y lies in the
// shard at a smaller y stores nothing (that row's quad stores both).
template <int MODE>
struct NestedShardQuad {
  float kxy;
  uint32_t first[4];
  uint32_t out[4];
  uint32_t nc, sc, live;

  __device__ __forceinline__ NestedShardQuad(const Params& p, int q) {
    const int x = q / p.ny_loc;
    const int yl = q - x * p.ny_loc;
    const int y = p.y_off + yl;
    const int px = rf::partner_index(x, p.nx);
    const int py = rf::partner_index(y, p.ny);
    const bool py_here = static_cast<unsigned>(py - p.y_off) <
                         static_cast<unsigned>(p.ny_loc);
    const int xs[4] = {x, px, x, px};
    const int ys[4] = {y, y, py, py};
    const float kx = p.kx_scale * static_cast<float>(rf::signed_index(x, p.nx));
    const float ky = p.ky_scale * static_cast<float>(rf::signed_index(y, p.ny));
    kxy = __fadd_rn(__fmul_rn(kx, kx), __fmul_rn(ky, ky));
    const bool second = py != y && py_here;
    live = py_here && py < y
               ? 0u
               : 1u | (px != x ? 2u : 0u) | (second ? 4u : 0u) |
                     (px != x && second ? 8u : 0u);
    nc = sc = 0u;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      first[r] = lattice_code(xs[r], ys[r], p.nx, p.ny) + p.k01;
      const int yr = r < 2 ? yl : py - p.y_off;
      out[r] = live & (1u << r)
                   ? (static_cast<uint32_t>(xs[r]) * p.ny_loc + yr) * p.nzh
                   : 0u;
      nc |= rf::not_canonical(xs[r], ys[r], xs[3 - r], ys[3 - r]) ? 1u << r
                                                                   : 0u;
      sc |= rf::self_conjugate(xs[r], ys[r], xs[3 - r], ys[3 - r]) ? 1u << r
                                                                    : 0u;
    }
  }

  // NestedQuad::draw, hashing only the rows it needs: the stored ones,
  // and on a plane of the spectrum and fixed modes all four (a stored
  // row's fix may take its partner row's draw).
  __device__ __forceinline__ void draw(const Params& p, int z) const {
    if (live == 0u) return;
    constexpr bool kFix = MODE == kSpectrum || MODE == kFixed;
    const bool plane = kFix && (z == 0 || z == p.top);
    const uint32_t need = plane ? 15u : live;
    float amp = 0.f;
    if (kFix) {
      amp = rf::k2_amplitude_ksq(p.tab, p.n_knots, __fadd_rn(kxy, p.kz2[z]),
                                 p.half_inv_ln10, p.lk0, p.inv_dlk,
                                 p.smoothing, p.gain);
    }
    float vre[4] = {0.f, 0.f, 0.f, 0.f}, vim[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (!(need & (1u << r))) continue;
      const uint2 b = rf::threefry2x32_w0(p.k0, p.k1,
                                          first[r] + static_cast<uint32_t>(z),
                                          p.rk);
      if (MODE == kBits) {
        if (live & (1u << r)) {
          reinterpret_cast<uint32_t*>(p.re)[out[r] + z] = b.x;
          reinterpret_cast<uint32_t*>(p.im)[out[r] + z] = b.y;
        }
        continue;
      }
      const float rr = sqrtf(__fmul_rn(-2.f, logf(rf::uniform_u1(b.x))));
      const float theta =
          __fmul_rn(6.28318530717958648f, rf::uniform_u1(b.y));
      float s, c;
      sincos_turn(theta, &s, &c);
      vre[r] = __fmul_rn(rr, c);
      vim[r] = __fmul_rn(rr, s);
    }
    if (MODE == kBits) return;
    if (kFix) {
      if (plane) {
        const float re0[4] = {vre[0], vre[1], vre[2], vre[3]};
        const float im0[4] = {vim[0], vim[1], vim[2], vim[3]};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (nc & (1u << r)) {
            vre[r] = re0[3 - r];
            vim[r] = -im0[3 - r];
          } else if (sc & (1u << r)) {
            vre[r] = __fmul_rn(vre[r], rf::kSqrt2);
            vim[r] = 0.f;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (MODE == kFixed) rf::unit_phase(vre[r], vim[r]);
        vre[r] = __fmul_rn(vre[r], amp);
        vim[r] = __fmul_rn(vim[r], amp);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (live & (1u << r)) {
        p.re[out[r] + z] = vre[r];
        p.im[out[r] + z] = vim[r];
      }
    }
  }
};

// KN's walk: the (quad, kz) pairs in quad-major order, quad q's kz at
// q nzh + kz, cut into runs of kRun (a multiple of 32), one a warp; lane l
// takes a run's elements l, l + 32, ...: a warp's 32 lanes draw 32
// consecutive kz (coalesced stores; at a quad's end, two quads' rows).
template <class Quad>
__device__ __forceinline__ void walk_quads(const Params& p,
                                           uint32_t n_quads) {
  const uint32_t total = n_quads * static_cast<uint32_t>(p.nzh);
  const uint32_t begin = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRun;
  if (begin >= total) return;
  const uint32_t end = min(begin + kRun, total);
  uint32_t e = begin + (threadIdx.x & 31);
  uint32_t q = e / p.nzh;
  int z = static_cast<int>(e - q * p.nzh);
  Quad quad(p, static_cast<int>(min(q, n_quads - 1)));
  for (; e < end; e += 32) {
    quad.draw(p, z);
    z += 32;
    if (z >= p.nzh) {
      do {
        z -= p.nzh;
        ++q;
      } while (z >= p.nzh);
      if (q < n_quads) quad = Quad(p, static_cast<int>(q));
    }
  }
}

// K1's (and K8's) walk: a warp owns 32 row pairs and walks each pair's kz
// with its 32 lanes; the kz left over past a multiple of 32 are drawn lane
// by row pair.
template <class Rows>
__device__ __forceinline__ void walk_row_pairs(const Params& p) {
  const int lane = threadIdx.x & 31;
  const int n_pairs = (p.nx / 2 + 1) * p.ny_loc;
  const int bulk = p.nzh & ~31;  // the kz a warp draws 32 at a time
  const int stride = gridDim.x * kWarps * kPairsPerWarp;
  for (int g = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kPairsPerWarp;
       g < n_pairs; g += stride) {
    const int end = min(g + kPairsPerWarp, n_pairs);
    for (int q = g; q < end; ++q) {
      const Rows rows(p, q);
      for (int z = lane; z < bulk; z += 32) rows.draw(p, z);
    }
    if (bulk < p.nzh && g + lane < end) {
      const Rows rows(p, g + lane);
      for (int z = bulk; z < p.nzh; ++z) rows.draw(p, z);
    }
  }
}

// Fill the block's kz^2 table and knots (and the block's barrier).
__device__ __forceinline__ float* load_tables(float* smem,
                                              const float* knots, int n_knots,
                                              int nzh, float kz_scale) {
  float* kz2 = smem + n_knots;
  for (int z = threadIdx.x; z < nzh; z += blockDim.x) {
    const float kz = kz_scale * static_cast<float>(z);
    kz2[z] = __fmul_rn(kz, kz);
  }
  rf::load_knots(smem, knots, n_knots);
  return kz2;
}

__global__ void __launch_bounds__(kThreads)
sample_modes_kernel(float* __restrict__ re, float* __restrict__ im,
                    const float* __restrict__ knots, int n_knots, int nx,
                    int ny, int nz, int y_off, int ny_loc, uint32_t k0,
                    uint32_t k1, float kx_scale, float ky_scale,
                    float kz_scale, float half_inv_ln10, float lk0,
                    float inv_dlk, float smoothing) {
  extern __shared__ float smem[];
  const int nzh = nz / 2 + 1;
  const float* kz2 = load_tables(smem, knots, n_knots, nzh, kz_scale);
  const Params p{re, im, smem, kz2, n_knots, nx, ny, nzh,
                 nz % 2 == 0 ? nzh - 1 : 0, y_off, ny_loc, k0, k1,
                 kx_scale, ky_scale, half_inv_ln10, lk0, inv_dlk, smoothing,
                 1.f};
  walk_row_pairs<RowPair>(p);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
nested_modes_kernel(float* __restrict__ re, float* __restrict__ im,
                    const float* __restrict__ knots, int n_knots, int nx,
                    int ny, int nz, uint32_t k0, uint32_t k1, float kx_scale,
                    float ky_scale, float kz_scale, float half_inv_ln10,
                    float lk0, float inv_dlk, float smoothing, float gain) {
  extern __shared__ float smem[];
  const int nzh = nz / 2 + 1;
  const float* kz2 = load_tables(smem, knots, n_knots, nzh, kz_scale);
  const Params p{re, im, smem, kz2, n_knots, nx, ny, nzh,
                 nz % 2 == 0 ? nzh - 1 : 0, 0, ny, k0, k1, kx_scale,
                 ky_scale, half_inv_ln10, lk0, inv_dlk, smoothing, gain,
                 k0 + k1, rf::rotl32(k1, 13)};
  walk_quads<NestedQuad<MODE>>(
      p, static_cast<uint32_t>(nx / 2 + 1) * (ny / 2 + 1));
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
nested_shard_kernel(float* __restrict__ re, float* __restrict__ im,
                    const float* __restrict__ knots, int n_knots, int nx,
                    int ny, int nz, int y_off, int ny_loc, uint32_t k0,
                    uint32_t k1, float kx_scale, float ky_scale,
                    float kz_scale, float half_inv_ln10, float lk0,
                    float inv_dlk, float smoothing, float gain) {
  extern __shared__ float smem[];
  const int nzh = nz / 2 + 1;
  const float* kz2 = load_tables(smem, knots, n_knots, nzh, kz_scale);
  const Params p{re, im, smem, kz2, n_knots, nx, ny, nzh,
                 nz % 2 == 0 ? nzh - 1 : 0, y_off, ny_loc, k0, k1, kx_scale,
                 ky_scale, half_inv_ln10, lk0, inv_dlk, smoothing, gain,
                 k0 + k1, rf::rotl32(k1, 13)};
  walk_quads<NestedShardQuad<MODE>>(
      p, static_cast<uint32_t>(nx / 2 + 1) * ny_loc);
}

// The grid of a walk over (nx/2 + 1) ny_loc row pairs.
unsigned walk_blocks(int nx, int ny_loc) {
  const long long groups =
      (static_cast<long long>(nx / 2 + 1) * ny_loc + kPairsPerWarp - 1) /
      kPairsPerWarp;
  long long blocks = (groups + kWarps - 1) / kWarps;
  if (blocks > 65535) blocks = 65535;  // the warps then stride over the rest
  return static_cast<unsigned>(blocks);
}

template <int MODE>
cudaError_t launch_nested(float* re, float* im, const float* knots,
                          int n_knots, int nx, int ny, int nz, int y_off,
                          int ny_loc, uint32_t k0, uint32_t k1,
                          float kx_scale, float ky_scale, float kz_scale,
                          float half_inv_ln10, float lk0, float inv_dlk,
                          float smoothing, float gain, cudaStream_t stream) {
  // the tables, or kNestedBlocksPerSM's share of an SM's shared memory (in
  // the 128-byte units shared memory is given in), which caps the blocks
  // an SM holds
  int dev = 0, sm_smem = 0, reserved = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  }
  if (err != cudaSuccess) return err;
  const size_t share =
      static_cast<size_t>(sm_smem / kNestedBlocksPerSM - reserved) / 128 * 128;
  const size_t smem = std::max(
      sizeof(float) * (static_cast<size_t>(n_knots) + nz / 2 + 1), share);
  // the whole grid walks quads of |kx|, |ky|; a shard quads of its rows
  const bool shard = y_off != 0 || ny_loc != ny;
  const long long quads = static_cast<long long>(nx / 2 + 1) *
                          (shard ? ny_loc : ny / 2 + 1);
  const long long runs = (quads * (nz / 2 + 1) + kRun - 1) / kRun;
  const unsigned blocks = static_cast<unsigned>((runs + kWarps - 1) / kWarps);
  if (shard) {
    err = cudaFuncSetAttribute(nested_shard_kernel<MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    nested_shard_kernel<MODE><<<blocks, kThreads, smem, stream>>>(
        re, im, knots, n_knots, nx, ny, nz, y_off, ny_loc, k0, k1, kx_scale,
        ky_scale, kz_scale, half_inv_ln10, lk0, inv_dlk, smoothing, gain);
    return cudaGetLastError();
  }
  err = cudaFuncSetAttribute(
      nested_modes_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  nested_modes_kernel<MODE><<<blocks, kThreads, smem, stream>>>(
      re, im, knots, n_knots, nx, ny, nz, k0, k1, kx_scale, ky_scale,
      kz_scale, half_inv_ln10, lk0, inv_dlk, smoothing, gain);
  return cudaGetLastError();
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
  sample_modes_kernel<<<walk_blocks(nx, ny_loc), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(re), static_cast<float*>(im),
      static_cast<const float*>(knots), n_knots, nx, ny, nz, y_off, ny_loc,
      k0, k1, kx_scale, ky_scale, kz_scale, half_inv_ln10, lk0, inv_dlk,
      smoothing);
  return static_cast<int>(cudaGetLastError());
}

// KN: re, im float32 (nx, ny_loc, nz/2 + 1) outputs, contiguous (bits mode:
// uint32 bits in the same storage), the ky rows [y_off, y_off + ny_loc) of
// the spectrum (the whole grid: y_off = 0, ny_loc = ny).  knots: float32
// (n_knots,), n_knots >= 2.  (k0, k1): key(seed) itself.  k_scale and the table constants as for
// rf_sample_modes; gain folded into K2's amplitude (spectrum: 1/sqrt(2);
// fixed: 1, or -1 for the paired field).  mode: 0 spectrum, 1 unit
// normals, 2 fixed, 3 bits.  Returns the CUDA error of the launch.
extern "C" int rf_sample_nested(void* re, void* im, const void* knots,
                                int n_knots, int nx, int ny, int nz,
                                int y_off, int ny_loc, uint32_t k0,
                                uint32_t k1, float kx_scale, float ky_scale,
                                float kz_scale, float half_inv_ln10,
                                float lk0, float inv_dlk, float smoothing,
                                float gain, int mode, void* stream) {
  if (y_off < 0 || ny_loc < 1 || y_off + ny_loc > ny) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* r = static_cast<float*>(re);
  auto* i = static_cast<float*>(im);
  const auto* t = static_cast<const float*>(knots);
  auto* s = static_cast<cudaStream_t>(stream);
  decltype(&launch_nested<kSpectrum>) launch = nullptr;
  switch (mode) {
    case kSpectrum:
      launch = launch_nested<kSpectrum>;
      break;
    case kUnit:
      launch = launch_nested<kUnit>;
      break;
    case kFixed:
      launch = launch_nested<kFixed>;
      break;
    case kBits:
      launch = launch_nested<kBits>;
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err =
      launch(r, i, t, n_knots, nx, ny, nz, y_off, ny_loc, k0, k1, kx_scale,
             ky_scale, kz_scale, half_inv_ln10, lk0, inv_dlk, smoothing, gain,
             s);
  return static_cast<int>(err);
}
