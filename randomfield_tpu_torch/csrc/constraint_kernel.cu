// KC: the constraint functionals of a Hoffman-Ribak constrained render, on
// a packed 'xyz' (nx, ny, nz/2 + 1) spectrum held as float32 re and im.
//
// Replaces randomfield_tpu/models/constrained.py:224 _measure_chunked and
// :250 _correction_chunked, which build an (M, cx, ny, nzh) complex kernel
// stack for each x-slab under lax.map.  The kernel of constraint i,
//
//   K_i(k) = exp(-k^2 R_i^2 / 2) exp(i k.x_i),
//
// is separable by axis: the host builds e_{a,i}(k_a) = exp(-k_a^2 R_i^2 / 2)
// (cos, sin)(k_a x_{i,a}) in float64 and rounds each table to float32 once
// (ops/constraint.py:axis_tables), and the thread forms K_i = (e_x e_y) e_z,
// each complex product rounded as written, its imaginary part zeroed at
// the truly self-conjugate modes (every axis index its own partner).  No
// array of M x modes exists.
//
// MEASURE (rf_constraint_measure): Gamma_i = sum m_k Re(c_k K_i) with m_k
// the Hermitian multiplicity, each mode's term in float64, summed per lane,
// then per warp (a fixed butterfly), then over the (block, warp) partials
// in order by a second kernel: one call for any M.  With ``scale`` it first
// multiplies the unit draws in place by the per-mode sigma grid and the
// filter exp(-k^2 s^2 / 2), (c sigma) f, the reference's sample_spectrum
// then filter_modes.
//
// CORRECT (rf_constraint_correct): c += se2 sum_i alpha_i conj(K_i) in
// place, se2 = (sigma f)^2, the sum over i in order in float32, every
// product and sum rounded as written (__fmul_rn, __fadd_rn), the order of
// ops/constraint.py:correct_plain, which the kernel equals bit for bit.
//
// What bounds it on the H100: device-memory bytes, the lattices and the
// sigma grid read and the lattices written (20 bytes a mode), until M grows:
// then MEASURE's float32 -> float64 conversions (F2F.F64.F32, a quarter of
// the float64 rate: two a mode and constraint, the kernel's parts, and two
// a mode and pass for c) and CORRECT's float32 issue (about 12
// instructions a mode and constraint).  Design: KB's line staging
// (line_ring.cuh), tiles of four kz lines in a ring of shared-memory stages
// on a persistent grid; a line to two warps, their lanes on consecutive kz;
// the kz tables e_z of a pass's constraints and the k vectors in shared
// memory; e_x e_y once a line and constraint, their loads issued a tile
// ahead.  Both kernels take the constraints in passes within one launch,
// each pass a walk over the block's tiles with no table reloaded inside it.
// MEASURE's passes hold 8 constraints, their sums in registers over the
// whole walk (straight-line code), and stream the lattices once a pass: on
// the H100 that beat holding every table in shared memory, where one block
// an SM leaves too few warps for the float64 chains.  CORRECT takes all M
// in one pass when their tables fit (about 40 at nzh = 513), else as many
// as fit a pass, the alpha sums of each mode kept between passes in a grid
// of float32 pairs; only its last pass reads the lattices, so it reads them
// once for any M.  It takes four kz of a lane at once through every
// constraint.  The zeroing of the self-conjugate modes is compiled only
// into the code of the four lines that hold them.
#include <cstdint>

#include <cuda_runtime.h>

#include "line_ring.cuh"

namespace {

constexpr int kWarps = 8;  // two a line of a tile
constexpr int kThreads = 32 * kWarps;
constexpr int kHalves = kWarps / rf::kTileRows;
constexpr int kRegBlock = 8;  // MEASURE's constraints in registers
constexpr int kCorrectSteps = 4;  // CORRECT's kz a lane takes at once
constexpr int kStages = 2;
constexpr int kReduceThreads = 128;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory, H100
constexpr size_t kRingOffset = 128;

struct Args {
  float* re;
  float* im;
  const float* sig;      // (nx, ny, nzh) sigma grid, or null
  const float* kvec;     // nx + ny + nzh float32 k vectors (the filter)
  const float2* tab;     // (M, nx + ny + nzh) e tables
  const float* alpha;    // (M,) float32 (CORRECT)
  double* partials;      // (blocks, kWarps, M) float64 (MEASURE)
  float2* carry;         // (nx, ny, nzh) alpha sums between passes (CORRECT)
  int nx, ny, nz, nzh, m, cb;  // cb: the constraints of a pass
  float smoothing;
};

struct Layout {  // offsets into dynamic shared memory
  size_t kvec, ztab, alpha, exy, total;
};

// The ring, the k vectors and the tables of a pass's cb constraints: e_z,
// alpha, each warp's e_x e_y.  Nothing grows with M.
__host__ __device__ inline Layout layout_of(int arrays, int nzh, int cb,
                                            int axes) {
  Layout l;
  l.kvec = kRingOffset + rf::LineRing::bytes(arrays, kStages, nzh);
  l.ztab = l.kvec + sizeof(float) * ((static_cast<size_t>(axes) + 1) / 2 * 2);
  l.alpha = l.ztab + sizeof(float2) * static_cast<size_t>(cb) * nzh;
  l.exy = l.alpha + sizeof(float2) * ((static_cast<size_t>(cb) + 1) / 2);
  l.total = l.exy + sizeof(float2) * static_cast<size_t>(kWarps) * cb;
  return l;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                     __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

__device__ __forceinline__ bool own_partner(int i, int n) {
  return i == 0 || (n % 2 == 0 && i == n / 2);
}

// (sigma f) of a mode: f = exp(((-0.5 k^2) s) s), k^2 = (kx^2 + ky^2) + kz^2
__device__ __forceinline__ float filter(const Args& p, float kx, float ky,
                                        float kz) {
  if (p.smoothing == 0.f) return 1.f;
  const float k2 = __fadd_rn(__fadd_rn(__fmul_rn(kx, kx), __fmul_rn(ky, ky)),
                             __fmul_rn(kz, kz));
  return expf(__fmul_rn(__fmul_rn(__fmul_rn(-0.5f, k2), p.smoothing),
                        p.smoothing));
}

// v[0..8): a lane's sums of 8 constraints.  After it lane 4j + r (r < 4)
// holds the warp's sum of constraint j: halves exchanged at distances 16,
// 8, 4, then whole values at 2 and 1 (an order fixed by the lanes).
template <int D, int N>
__device__ __forceinline__ void halve(double (&v)[kRegBlock], int lane) {
  const bool up = lane & D;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const double send = up ? v[j] : v[j + N];
    const double keep = up ? v[j + N] : v[j];
    v[j] = keep + __shfl_xor_sync(0xFFFFFFFFu, send, D);
  }
}

__device__ __forceinline__ double warp_sums8(double (&v)[kRegBlock]) {
  const int lane = threadIdx.x & 31;
  halve<16, 4>(v, lane);
  halve<8, 2>(v, lane);
  halve<4, 1>(v, lane);
  double s = v[0];
  s += __shfl_xor_sync(0xFFFFFFFFu, s, 2);
  s += __shfl_xor_sync(0xFFFFFFFFu, s, 1);
  return s;
}

// The shared-memory tables of constraints [c0, c0 + cn): e_z, and alpha.
__device__ __forceinline__ void load_tables(const Args& p, float2* ztab,
                                            float* alpha, int c0, int cn) {
  const int len = p.nx + p.ny + p.nzh;
  for (int i = threadIdx.x; i < cn * p.nzh; i += blockDim.x) {
    const int j = i / p.nzh, z = i - j * p.nzh;
    ztab[i] = p.tab[static_cast<long long>(c0 + j) * len + p.nx + p.ny + z];
  }
  if (p.alpha) {
    for (int j = threadIdx.x; j < cn; j += blockDim.x) {
      alpha[j] = p.alpha[c0 + j];
    }
  }
}

// e_x e_y of the calling warp's line (x, y) for constraints [c0, c0 + cn).
__device__ __forceinline__ void line_exy(const Args& p, float2* exy, int x,
                                         int y, int c0, int cn) {
  const int len = p.nx + p.ny + p.nzh;
  for (int j = threadIdx.x & 31; j < cn; j += 32) {
    const float2* t = p.tab + static_cast<long long>(c0 + j) * len;
    exy[j] = cmul(t[x], t[p.nx + y]);
  }
  __syncwarp();
}

// With a pass of at most 32 kPrefetch constraints, a warp loads the e_x,
// e_y of its next tile's line while it works on this one: lane l holds
// constraints c0 + l, c0 + l + 32, ...
constexpr int kPrefetch = 2;

struct ExyLoads {
  float2 ex[kPrefetch], ey[kPrefetch];
};

__device__ __forceinline__ ExyLoads load_exy(const Args& p, long long line,
                                             int c0, int cn) {
  ExyLoads l;
  const int len = p.nx + p.ny + p.nzh;
  if (line < static_cast<long long>(p.nx) * p.ny) {
    const int x = static_cast<int>(line / p.ny);
    const int y = static_cast<int>(line - static_cast<long long>(x) * p.ny);
#pragma unroll
    for (int g = 0; g < kPrefetch; ++g) {
      const int j = (threadIdx.x & 31) + 32 * g;
      if (j < cn) {
        const float2* t = p.tab + static_cast<long long>(c0 + j) * len;
        l.ex[g] = t[x];
        l.ey[g] = t[p.nx + y];
      }
    }
  }
  return l;
}

__device__ __forceinline__ void store_exy(float2* exy, const ExyLoads& l,
                                          int cn) {
#pragma unroll
  for (int g = 0; g < kPrefetch; ++g) {
    const int j = (threadIdx.x & 31) + 32 * g;
    if (j < cn) exy[j] = cmul(l.ex[g], l.ey[g]);
  }
  __syncwarp();
}

// The pass's e_x e_y of the calling warp's line (x, y) of tile i into exy:
// from the loads issued a tile ahead (``prefetch``), then those of tile
// i + 1 issued; else loaded now.
__device__ __forceinline__ void pass_exy(const Args& p, float2* exy,
                                         ExyLoads& next, bool prefetch,
                                         bool mine_line, long long next_line,
                                         int x, int y, int c0, int cn) {
  if (prefetch) {
    if (mine_line) store_exy(exy, next, cn);
    if (next_line >= 0) next = load_exy(p, next_line, c0, cn);
  } else if (mine_line) {
    line_exy(p, exy, x, y, c0, cn);
  }
}

// MEASURE over the modes of the calling warp's half line: kz = 32 s + lane
// for steps s = h, h + 2, ...; the pass's constraints [0, cn) (of the
// shared-memory tables ztab, exy), in the first RB slots of acc (RB >= cn).
// SELF: the line holds truly self-conjugate modes (x and y each their own
// partner: 4 lines a grid).
template <bool SELF, int RB>
__device__ __forceinline__ void measure_half(
    const Args& p, const float* re_s, const float* im_s, const float2* ztab,
    const float2* exy, int h, int cn, double (&acc)[kRegBlock]) {
  const int lane = threadIdx.x & 31;
  // a block's unused slots (j >= cn) read constraint cn - 1's table with
  // e = 0: straight-line code, their sums unused
  float2 e[RB];
  int at[RB];
#pragma unroll
  for (int j = 0; j < RB; ++j) {
    e[j] = j < cn ? exy[j] : make_float2(0.f, 0.f);
    at[j] = min(j, cn - 1) * p.nzh;
  }
  const int steps = (p.nzh + 31) >> 5;
  for (int s = h; s < steps; s += kHalves) {
    const int zr = (s << 5) + lane;
    const bool act = zr < p.nzh;
    const int z = act ? zr : p.nzh - 1;
    const float cr = re_s[z], ci = im_s[z];
    const bool sz = z == 0 || (p.nz % 2 == 0 && z == p.nzh - 1);
    const bool self_conj = SELF && sz;
    const double mult = act ? (sz ? 1.0 : 2.0) : 0.0;
    const double crd = static_cast<double>(cr);
    const double cid = static_cast<double>(ci);
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const float2 k = cmul(e[j], ztab[at[j] + z]);
      const double ki = self_conj ? 0.0 : static_cast<double>(k.y);
      const double t = fma(-cid, ki, crd * static_cast<double>(k.x));
      acc[j] = fma(mult, t, acc[j]);
    }
  }
}

// measure_half with the narrowest register block that holds cn
__device__ __forceinline__ void measure_block(
    bool self, int cn, const Args& p, const float* re_s, const float* im_s,
    const float2* ztab, const float2* exy, int h, double (&acc)[kRegBlock]) {
  if (self) {
    measure_half<true, kRegBlock>(p, re_s, im_s, ztab, exy, h, cn, acc);
  } else if (cn == 1) {
    measure_half<false, 1>(p, re_s, im_s, ztab, exy, h, cn, acc);
  } else if (cn <= 4) {
    measure_half<false, 4>(p, re_s, im_s, ztab, exy, h, cn, acc);
  } else {
    measure_half<false, kRegBlock>(p, re_s, im_s, ztab, exy, h, cn, acc);
  }
}

// The ring of a kernel's NA lattices in dynamic shared memory.
__device__ __forceinline__ rf::LineRing make_ring(unsigned char* smem,
                                                  const Args& p, int arrays) {
  rf::LineRing ring;
  ring.bars = reinterpret_cast<uint64_t*>(smem);
  ring.buf = reinterpret_cast<float*>(smem + kRingOffset);
  ring.stride = rf::LineRing::stride_of(p.nzh);
  ring.arrays = arrays;
  ring.stages = kStages;
  ring.nzh = p.nzh;
  ring.rows = static_cast<long long>(p.nx) * p.ny;
  return ring;
}

// MEASURE in passes of cb <= kRegBlock constraints, each a walk over the
// block's tiles that streams the lattices through the ring and keeps the
// pass's sums in registers.  With ``SCALE`` every pass scales the staged
// raw draws (the scale is per mode, not per constraint), and only the last
// writes the scaled draws back: no pass reads what another wrote.
template <bool SCALE>
__global__ void __launch_bounds__(kThreads)
measure_kernel(const Args p) {
  constexpr int NA = SCALE ? 3 : 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int passes = (p.m + p.cb - 1) / p.cb;
  const int axes = p.nx + p.ny + p.nzh;
  const Layout lay = layout_of(NA, p.nzh, p.cb, axes);
  const rf::LineRing ring = make_ring(smem, p, NA);
  float2* ztab = reinterpret_cast<float2*>(smem + lay.ztab);
  float2* exy = reinterpret_cast<float2*>(smem + lay.exy) + warp * p.cb;
  double* out = p.partials +
                (static_cast<long long>(blockIdx.x) * kWarps + warp) * p.m;
  const float* src[3] = {p.re, p.im, p.sig};
  float* kv = reinterpret_cast<float*>(smem + lay.kvec);
  for (int i = threadIdx.x; i < axes; i += blockDim.x) kv[i] = p.kvec[i];
  if (threadIdx.x == 0) ring.init();

  const long long tiles = rf::tile_count(ring.rows);
  const long long mine =
      tiles > blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const auto row0_of = [&](long long i) {
    return (blockIdx.x + i * gridDim.x) * rf::kTileRows;
  };
  const int rr = warp / kHalves, h = warp % kHalves;
  for (int pass = 0; pass < passes; ++pass) {
    const int c0 = pass * p.cb, cn = min(p.cb, p.m - c0);
    const bool last = pass == passes - 1;
    const long long fill = pass * mine;  // the ring's fills before the pass
    __syncthreads();  // the previous pass is done with the tables and ring
    load_tables(p, ztab, nullptr, c0, cn);
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < kStages && i < mine; ++i) {
        ring.issue(static_cast<int>((fill + i) % kStages), src, row0_of(i));
      }
    }
    double acc[kRegBlock];
#pragma unroll
    for (int j = 0; j < kRegBlock; ++j) acc[j] = 0.0;
    ExyLoads next;
    if (mine > 0) next = load_exy(p, row0_of(0) + rr, c0, cn);
    for (long long i = 0; i < mine; ++i) {
      const int s = static_cast<int>((fill + i) % kStages);
      ring.wait(s, static_cast<int>((fill + i) / kStages));
      const long long line = row0_of(i) + rr;
      const bool mine_line = line < ring.rows;
      const int x = static_cast<int>(line / p.ny);
      const int y = static_cast<int>(line - static_cast<long long>(x) * p.ny);
      float* re_s = ring.stage(s, 0) + rr * p.nzh;
      float* im_s = ring.stage(s, 1) + rr * p.nzh;
      const float* sig_s = ring.stage(s, NA - 1) + rr * p.nzh;
      pass_exy(p, exy, next, true, mine_line,
               i + 1 < mine ? row0_of(i + 1) + rr : -1, x, y, c0, cn);
      if (SCALE && mine_line) {
        // the warp's kz of the line scaled, in the stage
        const float kx = kv[x], ky = kv[p.nx + y];
        for (int z = (h << 5) + lane; z < p.nzh; z += kHalves << 5) {
          const float f = filter(p, kx, ky, kv[p.nx + p.ny + z]);
          const float sg = sig_s[z];
          const float cr = __fmul_rn(__fmul_rn(re_s[z], sg), f);
          const float ci = __fmul_rn(__fmul_rn(im_s[z], sg), f);
          re_s[z] = cr;
          im_s[z] = ci;
          if (last) {
            p.re[line * p.nzh + z] = cr;
            p.im[line * p.nzh + z] = ci;
          }
        }
        __syncwarp();
      }
      if (mine_line) {
        const bool self = own_partner(x, p.nx) && own_partner(y, p.ny);
        measure_block(self, cn, p, re_s, im_s, ztab, exy, h, acc);
        __syncwarp();  // exy is rewritten for the next tile
      }
      __syncthreads();  // every warp is done with stage s
      if (threadIdx.x == 0 && i + kStages < mine) {
        ring.issue(s, src, row0_of(i + kStages));
      }
    }
    // the pass's sums to the warp's row of the partials
    const double v = warp_sums8(acc);
    if ((lane & 3) == 0 && (lane >> 2) < cn) out[c0 + (lane >> 2)] = v;
  }
}

// CORRECT's sums over the pass's constraints [0, cn), in order, for a
// lane's kCorrectSteps kz (zc): ar += alpha Re K, ai += alpha Im K, Im K
// zeroed at the self-conjugate modes of a SELF line.
template <bool SELF>
__device__ __forceinline__ void alpha_sums(
    const float2* exy, const float* alpha, const float2* ztab, int cn,
    int nzh, const int (&zc)[kCorrectSteps],
    const bool (&self_conj)[kCorrectSteps], float (&ar)[kCorrectSteps],
    float (&ai)[kCorrectSteps]) {
  // four constraints an iteration: their table loads issue together (each
  // sum still adds the constraints in order)
#pragma unroll 4
  for (int j = 0; j < cn; ++j) {
    const float2 e = exy[j];
    const float a = alpha[j];
    const float2* zt = ztab + static_cast<long long>(j) * nzh;
    float2 ez[kCorrectSteps];
#pragma unroll
    for (int u = 0; u < kCorrectSteps; ++u) ez[u] = zt[zc[u]];
#pragma unroll
    for (int u = 0; u < kCorrectSteps; ++u) {
      const float2 k = cmul(e, ez[u]);
      ar[u] = __fadd_rn(ar[u], __fmul_rn(a, k.x));
      ai[u] = __fadd_rn(ai[u],
                        __fmul_rn(a, SELF && self_conj[u] ? 0.f : k.y));
    }
  }
}

// CORRECT in passes of cb constraints.  Every pass but the last adds its
// constraints to the alpha sums of each mode and keeps them in p.carry (no
// lattice read); the last streams the lattices and the sigma grid through
// the ring and writes c + se2 (ar, -ai) once.  PASSES: more than one.
template <bool PASSES>
__global__ void __launch_bounds__(kThreads) correct_kernel(const Args p) {
  constexpr int NA = 3;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int passes = PASSES ? (p.m + p.cb - 1) / p.cb : 1;
  const int axes = p.nx + p.ny + p.nzh;
  const Layout lay = layout_of(NA, p.nzh, p.cb, axes);
  const rf::LineRing ring = make_ring(smem, p, NA);
  float2* ztab = reinterpret_cast<float2*>(smem + lay.ztab);
  float* alpha = reinterpret_cast<float*>(smem + lay.alpha);
  float2* exy = reinterpret_cast<float2*>(smem + lay.exy) + warp * p.cb;
  const float* src[3] = {p.re, p.im, p.sig};
  float* kv = reinterpret_cast<float*>(smem + lay.kvec);
  for (int i = threadIdx.x; i < axes; i += blockDim.x) kv[i] = p.kvec[i];
  if (threadIdx.x == 0) ring.init();

  const long long tiles = rf::tile_count(ring.rows);
  const long long mine =
      tiles > blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const auto row0_of = [&](long long i) {
    return (blockIdx.x + i * gridDim.x) * rf::kTileRows;
  };
  const int rr = warp / kHalves, h = warp % kHalves;
  const int steps = (p.nzh + 31) >> 5;
  const bool prefetch = p.cb <= 32 * kPrefetch;
  for (int pass = 0; pass < passes; ++pass) {
    const int c0 = pass * p.cb, cn = min(p.cb, p.m - c0);
    const bool last = pass == passes - 1;
    __syncthreads();  // the previous pass is done with the tables
    load_tables(p, ztab, alpha, c0, cn);
    __syncthreads();
    if (last && threadIdx.x == 0) {
      for (int i = 0; i < kStages && i < mine; ++i) {
        ring.issue(i, src, row0_of(i));
      }
    }
    ExyLoads next;
    if (prefetch && mine > 0) next = load_exy(p, row0_of(0) + rr, c0, cn);
    for (long long i = 0; i < mine; ++i) {
      const int s = static_cast<int>(i % kStages);
      if (last) ring.wait(s, static_cast<int>(i / kStages));
      const long long line = row0_of(i) + rr;
      const bool mine_line = line < ring.rows;
      const int x = static_cast<int>(line / p.ny);
      const int y = static_cast<int>(line - static_cast<long long>(x) * p.ny);
      const bool sxy = own_partner(x, p.nx) && own_partner(y, p.ny);
      pass_exy(p, exy, next, prefetch, mine_line,
               i + 1 < mine ? row0_of(i + 1) + rr : -1, x, y, c0, cn);
      if (mine_line) {
        const float kx = kv[x], ky = kv[p.nx + y];
        const float* re_s = ring.stage(s, 0) + rr * p.nzh;
        const float* im_s = ring.stage(s, 1) + rr * p.nzh;
        const float* sig_s = ring.stage(s, 2) + rr * p.nzh;
        float2* carry = PASSES ? p.carry + line * p.nzh : nullptr;
        // kCorrectSteps of the lane's steps at once through every
        // constraint of the pass
        for (int s0 = h; s0 < steps; s0 += kHalves * kCorrectSteps) {
          float ar[kCorrectSteps], ai[kCorrectSteps];
          int zs[kCorrectSteps];
          bool self_conj[kCorrectSteps];
#pragma unroll
          for (int u = 0; u < kCorrectSteps; ++u) {
            const int z = ((s0 + kHalves * u) << 5) + lane;
            zs[u] = z < p.nzh ? z : -1;
            self_conj[u] =
                sxy && (z == 0 || (p.nz % 2 == 0 && z == p.nzh - 1));
            ar[u] = 0.f;
            ai[u] = 0.f;
            if (PASSES && pass > 0 && zs[u] >= 0) {
              const float2 c = carry[z];
              ar[u] = c.x;
              ai[u] = c.y;
            }
          }
          // the sums of a kz past the line (zs < 0) are computed on its
          // last kz and dropped: straight-line code
          int zc[kCorrectSteps];
#pragma unroll
          for (int u = 0; u < kCorrectSteps; ++u) {
            zc[u] = zs[u] >= 0 ? zs[u] : p.nzh - 1;
          }
          if (sxy) {
            alpha_sums<true>(exy, alpha, ztab, cn, p.nzh, zc, self_conj, ar,
                             ai);
          } else {
            alpha_sums<false>(exy, alpha, ztab, cn, p.nzh, zc, self_conj,
                              ar, ai);
          }
#pragma unroll
          for (int u = 0; u < kCorrectSteps; ++u) {
            const int z = zs[u];
            if (z < 0) continue;
            if (PASSES && !last) {
              carry[z] = make_float2(ar[u], ai[u]);
              continue;
            }
            const float se = __fmul_rn(
                sig_s[z], filter(p, kx, ky, kv[p.nx + p.ny + z]));
            const float se2 = __fmul_rn(se, se);
            p.re[line * p.nzh + z] = __fadd_rn(re_s[z], __fmul_rn(se2, ar[u]));
            p.im[line * p.nzh + z] = __fsub_rn(im_s[z], __fmul_rn(se2, ai[u]));
          }
        }
        __syncwarp();  // exy is rewritten for the next tile
      }
      if (last) {
        __syncthreads();  // every warp is done with stage s
        if (threadIdx.x == 0 && i + kStages < mine) {
          ring.issue(s, src, row0_of(i + kStages));
        }
      }
    }
  }
}

// out[j] = sum over rows r of partials[r][j], rows in order.
__global__ void __launch_bounds__(kReduceThreads)
reduce_rows_kernel(const double* __restrict__ partials,
                   double* __restrict__ out, int rows, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  double sum = 0.0;
  for (int r = 0; r < rows; ++r) {
    sum += partials[static_cast<long long>(r) * n + j];
  }
  out[j] = sum;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem, long long rows,
                      int* blocks) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return rf::persistent_blocks(kernel, kThreads, smem, rf::tile_count(rows),
                               blocks);
}

// constraints a pass takes: MEASURE a register block, CORRECT all M if
// their tables fit, else the most that fit (at least 1); or `want` if the
// caller names fewer
int pass_block(int arrays, int nzh, int m, int want, bool correct,
               int axes) {
  int cb = correct ? m : min(m, kRegBlock);
  if (want > 0 && want < cb) cb = want;
  while (cb > 1 && layout_of(arrays, nzh, cb, axes).total > kMaxSmem) --cb;
  return cb;
}

cudaError_t make_plan(bool correct, bool scale, int nx, int ny, int nz,
                      int m, int want, int* out) {
  const int nzh = nz / 2 + 1;
  const int arrays = correct || scale ? 3 : 2;
  const int axes = nx + ny + nzh;
  const int cb = pass_block(arrays, nzh, m, want, correct, axes);
  const bool passes = cb < m;
  const size_t smem = layout_of(arrays, nzh, cb, axes).total;
  const long long rows = static_cast<long long>(nx) * ny;
  int blocks = 0;
  cudaError_t err;
  if (correct) {
    err = passes ? configure(correct_kernel<true>, smem, rows, &blocks)
                 : configure(correct_kernel<false>, smem, rows, &blocks);
  } else {
    err = scale ? configure(measure_kernel<true>, smem, rows, &blocks)
                : configure(measure_kernel<false>, smem, rows, &blocks);
  }
  if (err != cudaSuccess) return err;
  out[0] = cb;
  out[1] = kStages;
  out[2] = blocks;
  out[3] = static_cast<int>(smem);
  return cudaSuccess;
}

Args make_args(void* re, void* im, const void* sig, const void* kvec,
               const void* tab, const void* alpha, void* partials,
               void* carry, int nx, int ny, int nz, int m, int cb,
               float smoothing) {
  return Args{static_cast<float*>(re),
              static_cast<float*>(im),
              static_cast<const float*>(sig),
              static_cast<const float*>(kvec),
              static_cast<const float2*>(tab),
              static_cast<const float*>(alpha),
              static_cast<double*>(partials),
              static_cast<float2*>(carry),
              nx, ny, nz, nz / 2 + 1, m, cb, smoothing};
}

bool aligned16(const void* p) {
  return p && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// The plan of a pass on (nx, ny, nz/2 + 1) lattices with m constraints:
// plan[0..4) = constraints a pass of the kernel takes (all m when their
// tables fit in shared memory; at most pass_cap when that is > 0), stages,
// blocks, dynamic shared memory in bytes.  correct: the CORRECT kernel;
// scale: MEASURE's scaling first.
extern "C" int rf_constraint_plan(int correct, int scale, int nx, int ny,
                                  int nz, int m, int pass_cap,
                                  void* plan_out) {
  int* plan = static_cast<int*>(plan_out);
  if (nx < 1 || ny < 1 || nz < 1 || m < 1 || !plan) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(make_plan(correct != 0, scale != 0, nx, ny, nz,
                                    m, pass_cap, plan));
}

// re, im: float32 (nx, ny, nz/2 + 1) contiguous, 16-byte aligned; sig: the
// same, read when scale != 0 (then re and im are scaled in place first);
// kvec: float32 nx + ny + nz/2 + 1 k vectors; tab: float32 pairs (m, nx +
// ny + nz/2 + 1); out: float64 (m,); partials: float64 scratch of blocks x
// 8 x m; cb, blocks from rf_constraint_plan.  One launch (and its fixed-
// order sum of the partials) for any m.  Returns the CUDA error of the
// launches.
extern "C" int rf_constraint_measure(void* re, void* im, const void* sig,
                                     const void* kvec, const void* tab,
                                     void* out, void* partials, int nx,
                                     int ny, int nz, int m, int cb,
                                     int blocks, float smoothing, int scale,
                                     void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || m < 1 || cb < 1 || cb > m ||
      cb > kRegBlock || blocks < 1 || !aligned16(re) || !aligned16(im) ||
      (scale && !aligned16(sig))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args args = make_args(re, im, scale ? sig : nullptr, kvec, tab,
                              nullptr, partials, nullptr, nx, ny, nz, m, cb,
                              smoothing);
  const size_t smem =
      layout_of(scale ? 3 : 2, nz / 2 + 1, cb, nx + ny + nz / 2 + 1).total;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = scale ? allow_smem(measure_kernel<true>, smem)
                          : allow_smem(measure_kernel<false>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (scale) {
    measure_kernel<true><<<blocks, kThreads, smem, st>>>(args);
  } else {
    measure_kernel<false><<<blocks, kThreads, smem, st>>>(args);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_rows_kernel<<<(m + kReduceThreads - 1) / kReduceThreads,
                       kReduceThreads, 0, st>>>(
      static_cast<const double*>(partials), static_cast<double*>(out),
      blocks * kWarps, m);
  return static_cast<int>(cudaGetLastError());
}

// c += (sigma f)^2 sum_i alpha_i conj(K_i) in place over the whole grid;
// alpha: float32 (m,) on the device; sig as above (required); carry:
// float32 pairs (nx, ny, nz/2 + 1), the alpha sums between passes, needed
// when cb < m (else unused, may be null); cb, blocks from
// rf_constraint_plan.
extern "C" int rf_constraint_correct(void* re, void* im, const void* sig,
                                     const void* kvec, const void* tab,
                                     const void* alpha, void* carry, int nx,
                                     int ny, int nz, int m, int cb,
                                     int blocks, float smoothing,
                                     void* stream) {
  const bool passes = cb < m;
  if (nx < 1 || ny < 1 || nz < 1 || m < 1 || cb < 1 || cb > m ||
      blocks < 1 || !aligned16(re) || !aligned16(im) || !aligned16(sig) ||
      (passes && !carry)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args args = make_args(re, im, sig, kvec, tab, alpha, nullptr, carry,
                              nx, ny, nz, m, cb, smoothing);
  const size_t smem =
      layout_of(3, nz / 2 + 1, cb, nx + ny + nz / 2 + 1).total;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = passes ? allow_smem(correct_kernel<true>, smem)
                           : allow_smem(correct_kernel<false>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (passes) {
    correct_kernel<true><<<blocks, kThreads, smem, st>>>(args);
  } else {
    correct_kernel<false><<<blocks, kThreads, smem, st>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}
