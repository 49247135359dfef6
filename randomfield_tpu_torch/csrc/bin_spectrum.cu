// KB: the spectrum binning of every Fourier-space estimator.  One pass over
// a packed 'xyz' half-spectrum (nx, ny_loc, nz/2+1) that lies in device
// memory adds, per mode, (w, w p, w |k|) to the bin of the estimator's edge
// search on |k|, with w the Hermitian multiplicity (1 on the kz = 0 and, for
// even nz, Nyquist planes, 2 elsewhere) and p the mode's value:
//
//   KIND auto        p = (re^2 + im^2) factor;
//   KIND cross       p = (re1 re2 + im1 im2) factor, Re(c1 c2*);
//   KIND interlaced  c = (c1 + c2 e^{i phi}) / 2, phi = (kx + ky + kz) a / 2,
//                    p = |c|^2 factor (e^{i phi} from per-axis tables);
//   KIND grid        p = the float32 value of a power grid (predictions);
//
// then, with a window of order q (ngp 1, cic 2, tsc 3), p / W^(2q), W =
// (sx sy) sz from per-axis sinc tables; and one of three outputs: the
// isotropic sum (OUT iso); up to three even multipoles, p (2l + 1) L_l(mu^2)
// with mu = k_los / |k| (OUT poles); or nmu |mu| wedges as a second bin
// index, bin nmu + min(int(|mu| nmu), nmu - 1) (OUT wedges).  Every float32
// operation is rounded as written (__fmul_rn, __fadd_rn, __fdiv_rn), in the
// order of the plain version (ops/binning.py:bin_spectrum_plain), so each
// mode's float32 term is the plain version's bit for bit; the counts are
// exact and the sums differ only by the order of their float64 additions.
//
// Replaces XLA's one-hot contraction randomfield_tpu/validate/stats.py:77
// _dot_bin behind :98 _masked_bins and its callers (:130 _binned, :164
// _binned_multipoles, :475 _wedge_bins_from_power, :1181 _binned_cross and
// the *_grid binners): "TPU scatter-add serializes colliding updates", so
// the TPU contracts against a one-hot matrix on the MXU.  The GPU's
// counterpart of that decision is K5's: no atomic a mode.  The bin is the
// edge search itself on the float32 |k| of ops/grid.py:kmag ((kx^2 + ky^2) +
// kz^2 of float32 k vectors), so a mode lands where the plain version puts
// it; counts are integers and sums float64, added in an order fixed by the
// shapes alone (per run, warp, block, then the block partials in block order
// by a second kernel), so two calls agree bit for bit.
//
// What bounds it on the H100: the bytes of the spectrum, read once (8 a mode
// for auto, 16 for cross and interlaced, 4 for grid: 1.285 ms for auto at
// 1024^3), and the issue and latency of its per-mode work.  Design:
//
// * Two passes.  The counts and the |k| sums of the bins depend on the
//   grid alone, not on the spectrum: a geometry pass (KIND geo, which reads
//   no lattice) adds (w, w |k|) per key, and ops/binning.py keeps its result
//   for the geometry (shape, spacing, edges, rows, wedges); the data pass
//   adds w p alone.
// * The bin is a compare of the float32 k^2 = (kx^2 + ky^2) + kz^2 with an
//   edge's threshold: the least float32 k^2 whose sqrtf passes the edge
//   (the edge search on |k| exactly, with no square root where no |k| is
//   needed).  Along a line k^2 never falls.
// * The data pass streams tiles of four whole kz lines (line_ring.cuh: one
//   16-byte-aligned span of 16 nzh bytes a lattice, a 1-D bulk copy into a
//   ring of shared-memory stages) on a persistent grid, so the next tile's
//   bytes are in flight while the warps bin the current one from shared
//   memory.  A warp takes a line, each lane a span of consecutive kz (17 at
//   nz = 1024: an odd stride, conflict-free).  The counts at a span's two
//   ends bound every count in it, so on a line where no span crosses two
//   edges (all but the lowest |k| lines) a mode's key is one compare with a
//   threshold held in a register and its value goes to one of the lane's
//   two float64 sums by a selected weight, with no branch; the line's keys
//   then go to the warp's accumulator in one butterfly.  Other lines, and
//   wedges, carry each lane's count and runs, the done runs waiting in
//   registers until the line's end.  The geometry pass walks the same way
//   with the values (1, |k|) and no lattice.
// * The sums of a line go to a slot of its tile's line; chunks of
//   consecutive tiles (their count fixed by the shapes) sum their slots in
//   order, and a last kernel the chunks in order, so no sum's grouping
//   depends on the grid or the kind: two calls, and the cross power of a
//   field with itself and its power, agree bit for bit.
#include <cstdint>

#include <cuda_runtime.h>

#include "line_ring.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxWarps = 4;
constexpr int kThreads = 32 * kMaxWarps;
constexpr int kReduceThreads = 256;
// shared memory a block may take on the H100 (227 KB), an SM's
constexpr size_t kMaxSmem = 232448;
constexpr size_t kRingOffset = 128;  // the stages' barriers first

// kGeo: the geometry pass (counts and |k| sums; no lattice)
enum Kind { kAuto = 0, kCross = 1, kInterlaced = 2, kGrid = 3, kGeo = 4 };
// kProbe: the data pass's staging, the floats only summed (a read probe)
enum Out { kIso = 0, kPoles = 1, kWedges = 2, kProbe = 3 };

struct Params {
  const float* a[rf::kMaxRingArrays];  // re, im[, re2, im2]; the grid alone
  const float* kvec;   // nx + ny + nzh: the estimator's float32 kx, ky, kz
  const float* wtab;   // nx + ny + nzh: per-axis sinc(k a / 2), if order
  const float* ptab;   // cos then sin of k a / 2 per axis, if interlaced
  const float* thr;    // nbins + 1: the least float32 k^2 past each edge
  double* partials;    // a chunk's sums (per_slot values) a chunk
  int nx, ny, nz, nzh, y_off, ny_loc, nbins, nmu, los_axis, order, stages;
  int chunk;           // tiles a chunk
  int ells[3];  // the multipoles' l (0, 2, 4), -1 for none
  float factor;
};

__host__ __device__ constexpr int arrays_of(int kind) {
  return kind == kAuto ? 2 : kind == kGrid ? 1 : kind == kGeo ? 0 : 4;
}

__host__ __device__ constexpr int sums_of(int out) {
  return out == kPoles ? 3 : 1;
}

// float64 sums a key takes: the geometry's (w, w |k|), the data's NP
__host__ __device__ constexpr int values_of(int kind, int out) {
  return kind == kGeo ? 2 : sums_of(out);
}

// float64 rows (of nb) a slot accumulates: the geometry's count and |k|
// sum, the data's NP value sums; the probe's one value
__host__ __device__ inline int per_slot_of(int kind, int out, int nbins,
                                           int nmu) {
  if (out == kProbe) return 1;
  const int nb = out == kWedges ? nbins * nmu : nbins;
  return (kind == kGeo ? 2 : sums_of(out)) * nb;
}

// the stages, the slots' sums (a slot a line of a tile), the edges'
// thresholds and the k table (nx + ny + nzh floats: axes)
__host__ __device__ inline size_t smem_of(int kind, int out, int stages,
                                          int nzh, int nbins, int nmu,
                                          int axes) {
  return kRingOffset + rf::LineRing::bytes(arrays_of(kind), stages, nzh) +
         sizeof(double) * rf::kTileRows * per_slot_of(kind, out, nbins, nmu) +
         sizeof(float) * static_cast<size_t>(nbins + 2 + axes);
}

// Tiles a chunk: chunks (at most 16384, and 64 MB of partials) fixed by
// the shapes alone, as many as load-balance a persistent grid.
__host__ __device__ inline int chunk_of(long long tiles, int per_slot) {
  long long chunks = 16384;
  const long long cap = (8LL << 20) / (per_slot > 0 ? per_slot : 1);
  if (chunks > cap) chunks = cap;
  if (chunks > tiles) chunks = tiles;
  if (chunks < 1) chunks = 1;
  return static_cast<int>((tiles + chunks - 1) / chunks);
}

// The per-axis tables, each nx + ny + nzh long: k (kx, ky, kz) in shared
// memory; the window's sinc, the phase's cos and sin in device memory.
struct Tabs {
  const float* k;
  const float* w;
  const float* c;
  const float* s;
};

// v (2l + 1) L_l(mu^2), rounded as ops/binning.py:_legendre_weighted.
__device__ __forceinline__ float legendre_weighted(int ell, float mu2,
                                                   float v) {
  if (ell == 0) return v;
  if (ell == 2) {
    const float l2 = __fmul_rn(0.5f, __fsub_rn(__fmul_rn(3.f, mu2), 1.f));
    return __fmul_rn(v, __fmul_rn(5.f, l2));
  }
  if (ell == 4) {
    const float a = __fmul_rn(__fmul_rn(35.f, mu2), mu2);
    const float b = __fadd_rn(__fsub_rn(a, __fmul_rn(30.f, mu2)), 3.f);
    return __fmul_rn(v, __fmul_rn(9.f, __fmul_rn(0.125f, b)));
  }
  return 0.f;
}

// The per-line constants of the terms: kx, ky, (kx^2 + ky^2), the window's
// sx sy and the interlacing phase's e^{i (kx + ky) a / 2}.
struct LineConst {
  float bx, by, kxy2, wxy = 1.f, exy_re = 1.f, exy_im = 0.f;
};

template <int KIND>
__device__ __forceinline__ LineConst line_const(const Params& p,
                                                const Tabs& t, int x, int y) {
  LineConst c;
  c.bx = t.k[x];
  c.by = t.k[p.nx + y];
  c.kxy2 = __fadd_rn(__fmul_rn(c.bx, c.bx), __fmul_rn(c.by, c.by));
  if (KIND != kGeo && p.order) c.wxy = __fmul_rn(t.w[x], t.w[p.nx + y]);
  if (KIND == kInterlaced) {
    const float cx = t.c[x], cy = t.c[p.nx + y];
    const float sx = t.s[x], sy = t.s[p.nx + y];
    c.exy_re = __fsub_rn(__fmul_rn(cx, cy), __fmul_rn(sx, sy));
    c.exy_im = __fadd_rn(__fmul_rn(cx, sy), __fmul_rn(sx, cy));
  }
  return c;
}

// The terms of the mode at kz index z of a line: k^2, the V values (the
// data's w-less value(s), or the geometry's 1 and |k|) and the mu bin
// (wedges), every float32 operation rounded in the plain version's order.
template <int KIND, int OUT, int V>
__device__ __forceinline__ void mode_terms(const Params& p, const Tabs& t,
                                           const float* const* line,
                                           const LineConst& c, int z,
                                           float& k2, float (&vals)[V],
                                           int& mi) {
  constexpr bool GEO = KIND == kGeo;
  constexpr int NA = arrays_of(KIND) > 0 ? arrays_of(KIND) : 1;
  const int zi = p.nx + p.ny + z;  // the kz entry of the tables
  const float bz = t.k[zi];
  k2 = __fadd_rn(c.kxy2, __fmul_rn(bz, bz));
  // a |k|: the geometry's sums, mu
  float km = 0.f;
  if (GEO || OUT != kIso) km = sqrtf(k2);
  const float klos = p.los_axis == 0 ? c.bx : p.los_axis == 1 ? c.by : bz;
  mi = 0;
  if (OUT == kWedges) {
    const float mu = __fdiv_rn(fabsf(klos), km);
    const int m = static_cast<int>(__fmul_rn(mu, static_cast<float>(p.nmu)));
    mi = min(max(m, 0), p.nmu - 1);
  }
  if constexpr (GEO) {
    vals[0] = 1.f;
    vals[1] = km;
    return;
  }
  float v;
  if (KIND == kAuto) {
    const float re = line[0][z], im = line[1 % NA][z];
    v = __fmul_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)), p.factor);
  } else if (KIND == kCross) {
    const float r1 = line[0][z], i1 = line[1 % NA][z];
    const float r2 = line[2 % NA][z], i2 = line[3 % NA][z];
    v = __fmul_rn(__fadd_rn(__fmul_rn(r1, r2), __fmul_rn(i1, i2)), p.factor);
  } else if (KIND == kInterlaced) {
    const float cz = t.c[zi], sz = t.s[zi];
    const float e_re = __fsub_rn(__fmul_rn(c.exy_re, cz),
                                 __fmul_rn(c.exy_im, sz));
    const float e_im = __fadd_rn(__fmul_rn(c.exy_re, sz),
                                 __fmul_rn(c.exy_im, cz));
    const float r2 = line[2 % NA][z], i2 = line[3 % NA][z];
    const float t_re = __fsub_rn(__fmul_rn(r2, e_re), __fmul_rn(i2, e_im));
    const float t_im = __fadd_rn(__fmul_rn(r2, e_im), __fmul_rn(i2, e_re));
    const float c_re = __fmul_rn(0.5f, __fadd_rn(line[0][z], t_re));
    const float c_im = __fmul_rn(0.5f, __fadd_rn(line[1 % NA][z], t_im));
    v = __fmul_rn(__fadd_rn(__fmul_rn(c_re, c_re), __fmul_rn(c_im, c_im)),
                  p.factor);
  } else {
    v = line[0][z];
  }
  if (p.order) {
    const float w = __fmul_rn(c.wxy, t.w[zi]);
    const float w2 = __fmul_rn(w, w);
    float wp = w2;
    for (int o = 1; o < p.order; ++o) wp = __fmul_rn(wp, w2);
    v = __fdiv_rn(v, wp);
  }
  if (OUT == kPoles) {
    // mu^2 = 0 at |k| = 0, as the plain version's (a masked mode)
    const float t = __fdiv_rn(klos, km);
    const float mu2 = km > 0.f ? __fmul_rn(t, t) : 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) vals[e] = legendre_weighted(p.ells[e], mu2, v);
  } else {
    vals[0] = v;
  }
}

// The count of thresholds at or below k2 (the edges below its |k|).
__device__ __forceinline__ int count_below(const float* thr, int nbins,
                                           float k2) {
  int lo = 0, hi = nbins + 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (thr[mid] <= k2) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// A lane's runs in the data pass: [0] the current one, [1] and [2] done
// ones of the line not yet added (key -1: none).
template <int V>
struct Spans {
  int k[3] = {-1, -1, -1};
  double v[3][V] = {};
};

// Add the runs [first, 3) of every lane of the warp to its accumulator,
// key by key in ascending order, each key summed over the warp by a
// butterfly; those runs are emptied.
template <int V>
__device__ __forceinline__ void flush_spans(double* acc, int nb,
                                            Spans<V>& r, int first) {
  while (true) {
    int low = 0x7FFFFFFF;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j >= first && r.k[j] >= 0) low = min(low, r.k[j]);
    }
    const int key = __reduce_min_sync(kFull, low);
    if (key == 0x7FFFFFFF) break;
    double s[V] = {};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j >= first && r.k[j] == key) {
#pragma unroll
        for (int e = 0; e < V; ++e) s[e] += r.v[j][e];
        r.k[j] = -1;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int e = 0; e < V; ++e) s[e] += __shfl_xor_sync(kFull, s[e], off);
    }
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e * nb + key] += s[e];
    }
    __syncwarp();
  }
}

// The key of count c (the edges below |k|) and mu bin m, -1 out of range.
template <int OUT>
__device__ __forceinline__ int key_of(const Params& p, int c, int m) {
  if (c < 1 || c > p.nbins) return -1;
  return OUT == kWedges ? (c - 1) * p.nmu + m : c - 1;
}

// A line's end when every lane holds at most two runs (keys k0 < k1 or -1,
// one sum each) and the warp's keys lie in [lo, lo + 4): one butterfly of
// four sums, each key's, then lane 0 adds them.
__device__ __forceinline__ void flush_pairs(double* acc, int lo, int hi,
                                            int k0, double s0, int k1,
                                            double s1) {
  double v[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    v[d] = (k0 == lo + d ? s0 : 0.0) + (k1 == lo + d ? s1 : 0.0);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int d = 0; d < 4; ++d) v[d] += __shfl_xor_sync(kFull, v[d], off);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      if (lo + d <= hi) acc[lo + d] += v[d];
    }
  }
  __syncwarp();
}

// One pass over one line (x, y), its lattices in shared memory at
// line[0..NA) (none for the geometry): lane l of the calling warp takes a
// span of consecutive kz (an odd stride in shared memory is conflict-free
// for most lengths).  Along a span k^2 never falls (each float32 step is
// monotone), so the counts at its two ends bound every count in it: when
// each lane's span crosses at most one edge, as in all but the lowest |k|
// lines, a mode's key is one compare with the edge's threshold and its
// value goes to one of the lane's two sums with no branch; otherwise (and
// for wedges, whose rounded mu need not be monotone) each lane carries its
// count and runs, the done ones waiting in registers.
template <int KIND, int OUT>
__device__ __forceinline__ void bin_line(const Params& p, const float* thr,
                                         const Tabs& t, double* acc, int nb,
                                         const float* const* line, int x,
                                         int y) {
  constexpr int V = values_of(KIND, OUT);
  constexpr int U = OUT == kPoles ? 2 : 4;
  const int lane = threadIdx.x & 31;
  const int z_nyq = p.nz % 2 == 0 ? p.nzh - 1 : -1;
  const LineConst c = line_const<KIND>(p, t, x, y);
  const int span = (p.nzh + 31) >> 5;
  const int z0 = lane * span;
  const int len = max(0, min(span, p.nzh - z0));
  // the counts at the span's two ends
  int ca = 0, cz = 0;
  if (len > 0) {
    const float ba = t.k[p.nx + p.ny + z0];
    const float bz = t.k[p.nx + p.ny + z0 + len - 1];
    ca = count_below(thr, p.nbins, __fadd_rn(c.kxy2, __fmul_rn(ba, ba)));
    cz = count_below(thr, p.nbins, __fadd_rn(c.kxy2, __fmul_rn(bz, bz)));
  }
  const bool simple =
      OUT != kWedges && __all_sync(kFull, len == 0 || cz - ca <= 1);
  if (simple) {
    // count ca, or ca + 1 from the threshold t1 on
    const float t1 = thr[ca];
    const int k0 = len > 0 ? key_of<OUT>(p, ca, 0) : -1;
    const int k1 = len > 0 && cz > ca ? key_of<OUT>(p, ca + 1, 0) : -1;
    double s0[V] = {}, s1[V] = {};
    for (int i0 = 0; i0 < span; i0 += U) {
      float k2[U], vals[U][V];
      int mi[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // a kz past the span reads the line's last: branch-free, unused
        const int z = min(z0 + i0 + u, p.nzh - 1);
        mode_terms<KIND, OUT, V>(p, t, line, c, z, k2[u], vals[u], mi[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int z = z0 + i0 + u;
        const double wd = i0 + u >= len ? 0.0
                          : (z == 0 || z == z_nyq) ? 1.0
                                                    : 2.0;
        const bool up = k2[u] >= t1;
        const double w0 = up || k0 < 0 ? 0.0 : wd;
        const double w1 = up && k1 >= 0 ? wd : 0.0;
        // a masked mode's value (any float32) selected away, not scaled
        const bool in = wd != 0.0 && (up ? k1 >= 0 : k0 >= 0);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const double v = static_cast<double>(in ? vals[u][e] : 0.f);
          s0[e] = fma(w0, v, s0[e]);
          s1[e] = fma(w1, v, s1[e]);
        }
      }
    }
    const int lo = __reduce_min_sync(
        kFull, k0 >= 0 ? k0 : k1 >= 0 ? k1 : 0x7FFFFFFF);
    const int hi = __reduce_max_sync(kFull, max(k0, k1));
    if (V == 1 && hi >= lo && hi - lo < 4) {
      flush_pairs(acc, lo, hi, k0, s0[0], k1, s1[0]);
      return;
    }
    Spans<V> r;
    r.k[1] = k0;
    r.k[2] = k1;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      r.v[1][e] = s0[e];
      r.v[2][e] = s1[e];
    }
    flush_spans<V>(acc, nb, r, 1);
    return;
  }
  int cnt = ca;
  float thi = thr[cnt];
  Spans<V> r;
  for (int i0 = 0; i0 < span; i0 += U) {
    float k2[U], vals[U][V];
    int mi[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // a kz past the span reads the line's last: branch-free, unused
      const int z = min(z0 + i0 + u, p.nzh - 1);
      mode_terms<KIND, OUT, V>(p, t, line, c, z, k2[u], vals[u], mi[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u;
      if (i >= span) break;
      int key = -1;
      if (i < len) {
        if (k2[u] >= thi) {
          do {
            thi = thr[++cnt];
          } while (k2[u] >= thi);
        }
        key = key_of<OUT>(p, cnt, mi[u]);
      }
      const bool change = key >= 0 && key != r.k[0];
      // a lane with two done runs and a third: the warp adds the done ones
      if (__any_sync(kFull, change && r.k[0] >= 0 && r.k[2] >= 0)) {
        flush_spans<V>(acc, nb, r, 1);
      }
      if (change) {
        if (r.k[0] >= 0) {
          if (r.k[1] < 0) {
            r.k[1] = r.k[0];
#pragma unroll
            for (int e = 0; e < V; ++e) r.v[1][e] = r.v[0][e];
          } else {
            r.k[2] = r.k[0];
#pragma unroll
            for (int e = 0; e < V; ++e) r.v[2][e] = r.v[0][e];
          }
        }
        r.k[0] = key;
#pragma unroll
        for (int e = 0; e < V; ++e) r.v[0][e] = 0.0;
      }
      if (key >= 0) {
        const int z = z0 + i;
        const double wd = (z == 0 || z == z_nyq) ? 1.0 : 2.0;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          r.v[0][e] = fma(wd, static_cast<double>(vals[u][e]), r.v[0][e]);
        }
      }
    }
  }
  flush_spans<V>(acc, nb, r, 0);
}

template <int KIND, int OUT>
__global__ void __launch_bounds__(kThreads)
bin_spectrum_kernel(const Params p) {
  constexpr int NA = arrays_of(KIND);
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nb = OUT == kWedges ? p.nbins * p.nmu : p.nbins;
  const int per_slot = per_slot_of(KIND, OUT, p.nbins, p.nmu);
  rf::LineRing ring;
  ring.bars = reinterpret_cast<uint64_t*>(smem);
  ring.buf = reinterpret_cast<float*>(smem + kRingOffset);
  ring.stride = rf::LineRing::stride_of(p.nzh);
  ring.arrays = NA;
  ring.stages = p.stages;
  ring.nzh = p.nzh;
  ring.rows = static_cast<long long>(p.nx) * p.ny_loc;
  double* slots = reinterpret_cast<double*>(
      smem + kRingOffset + rf::LineRing::bytes(NA, p.stages, p.nzh));
  float* thr = reinterpret_cast<float*>(slots + rf::kTileRows * per_slot);
  float* tab = thr + p.nbins + 2;
  const int axes = p.nx + p.ny + p.nzh;
  Tabs t;
  t.k = tab;
  t.w = p.wtab;
  t.c = p.ptab;
  t.s = p.ptab + axes;
  for (int i = threadIdx.x; i < rf::kTileRows * per_slot; i += blockDim.x) {
    slots[i] = 0.0;
  }
  for (int i = threadIdx.x; i <= p.nbins + 1; i += blockDim.x) {
    thr[i] = i <= p.nbins ? p.thr[i] : __int_as_float(0x7F800000);
  }
  for (int i = threadIdx.x; i < axes; i += blockDim.x) tab[i] = p.kvec[i];
  if (NA > 0 && threadIdx.x == 0) ring.init();
  __syncthreads();

  // chunks of p.chunk consecutive tiles, chunk c to block c mod gridDim.x;
  // a tile's line rr to warp rr mod warps and to slot rr; a chunk's slots,
  // summed in order, are its partial: every sum's grouping is the shapes'
  const long long tiles = rf::tile_count(ring.rows);
  const long long chunks = (tiles + p.chunk - 1) / p.chunk;
  const long long nch =
      chunks > blockIdx.x ? (chunks - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  long long mine = nch * p.chunk;  // the block's tiles, the last chunk's cut
  if (nch > 0 && blockIdx.x + (nch - 1) * gridDim.x == chunks - 1) {
    mine -= chunks * p.chunk - tiles;
  }
  const auto chunk_index = [&](long long i) {
    return blockIdx.x + (i / p.chunk) * gridDim.x;
  };
  const auto row0_of = [&](long long i) {
    return (chunk_index(i) * p.chunk + i % p.chunk) * rf::kTileRows;
  };
  if (NA > 0 && threadIdx.x == 0) {
    for (int i = 0; i < p.stages && i < mine; ++i) {
      ring.issue(i, p.a, row0_of(i));
    }
  }
  float probe = 0.f;
  for (long long i = 0; i < mine; ++i) {
    const int s = static_cast<int>(i % (p.stages > 0 ? p.stages : 1));
    if constexpr (NA > 0) ring.wait(s, static_cast<int>(i / p.stages));
    const long long row0 = row0_of(i);
    const int nrows = static_cast<int>(
        ring.rows - row0 < rf::kTileRows ? ring.rows - row0 : rf::kTileRows);
    for (int rr = warp; rr < nrows; rr += warps) {
      double* acc = slots + rr * per_slot;
      const float* line[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        line[a] = NA > 0 ? ring.stage(s, a < NA ? a : 0) + rr * p.nzh
                         : nullptr;
      }
      if constexpr (OUT == kProbe) {
        for (int z = lane; z < p.nzh; z += 32) {
#pragma unroll
          for (int a = 0; a < NA; ++a) probe += line[a][z];
        }
      } else {
        const long long r = row0 + rr;
        const int x = static_cast<int>(r / p.ny_loc);
        const int y = p.y_off + static_cast<int>(r - static_cast<long long>(x) *
                                                         p.ny_loc);
        bin_line<KIND, OUT>(p, thr, t, acc, nb, line, x, y);
      }
    }
    __syncthreads();  // every warp is done with stage s and the slots
    if (NA > 0 && threadIdx.x == 0 && i + p.stages < mine) {
      ring.issue(s, p.a, row0_of(i + p.stages));
    }
    if ((i + 1) % p.chunk == 0 || i + 1 == mine) {
      // the chunk's end: its partial, the slots in order, then empty slots
      if constexpr (OUT == kProbe) {
        for (int off = 16; off > 0; off >>= 1) {
          probe += __shfl_xor_sync(kFull, probe, off);
        }
        if (lane == 0) slots[warp] = static_cast<double>(probe);
        probe = 0.f;
        __syncthreads();
      }
      double* out = p.partials + chunk_index(i) * per_slot;
      for (int j = threadIdx.x; j < per_slot; j += blockDim.x) {
        double sum = 0.0;
        for (int k = 0; k < rf::kTileRows; ++k) {
          sum += slots[k * per_slot + j];
          slots[k * per_slot + j] = 0.0;
        }
        out[j] = sum;
      }
      __syncthreads();
    }
  }
}

// acc[i] = the sum over chunks of partials[chunk][i]: block i, thread t
// summing chunks t, t + 256, ... in order, then a tree of fixed shape.
__global__ void __launch_bounds__(kReduceThreads)
reduce_chunks_kernel(const double* __restrict__ partials,
                     double* __restrict__ acc, long long chunks, int n_vals) {
  __shared__ double part[kReduceThreads];
  const int i = blockIdx.x;
  double sum = 0.0;
  for (long long c = threadIdx.x; c < chunks; c += kReduceThreads) {
    sum += partials[c * n_vals + i];
  }
  part[threadIdx.x] = sum;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) acc[i] = part[0];
}

template <int KIND, int OUT>
cudaError_t make_plan(int nzh, long long rows, int nbins, int nmu, int axes,
                      int* out) {
  // of the (warps, stages) whose shared memory fits, the one with the most
  // warps an SM; of equals the first (two stages, a tile's loads in flight
  // while the block bins the one before; then fewer warps a block)
  static const int kChoices[][2] = {{4, 2}, {2, 2}, {1, 2},
                                    {4, 1}, {2, 1}, {1, 1}};
  int best = -1, best_warps = 0;
  for (int i = 0; i < 6; ++i) {
    const int* c = kChoices[i];
    const size_t smem = smem_of(KIND, OUT, c[1], nzh, nbins, nmu, axes);
    if (smem > kMaxSmem) continue;
    cudaError_t err = cudaFuncSetAttribute(
        bin_spectrum_kernel<KIND, OUT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bin_spectrum_kernel<KIND, OUT>, 32 * c[0], smem);
    if (err != cudaSuccess) return err;
    if (per_sm * c[0] > best_warps) {
      best = i;
      best_warps = per_sm * c[0];
    }
  }
  if (best < 0) return cudaErrorInvalidValue;
  const int* c = kChoices[best];
  const size_t smem = smem_of(KIND, OUT, c[1], nzh, nbins, nmu, axes);
  cudaError_t err = cudaFuncSetAttribute(
      bin_spectrum_kernel<KIND, OUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long tiles = rf::tile_count(rows);
  const int chunk = chunk_of(tiles, per_slot_of(KIND, OUT, nbins, nmu));
  const long long chunks = (tiles + chunk - 1) / chunk;
  int blocks = 0;
  err = rf::persistent_blocks(bin_spectrum_kernel<KIND, OUT>, 32 * c[0], smem,
                              chunks, &blocks);
  if (err != cudaSuccess) return err;
  out[0] = c[0];
  out[1] = c[1];
  out[2] = blocks;
  out[3] = static_cast<int>(smem);
  out[4] = chunk;
  out[5] = static_cast<int>(chunks);
  return cudaSuccess;
}

template <int KIND, int OUT>
cudaError_t launch(const Params& p, double* acc, int warps, int n_blocks,
                   cudaStream_t s) {
  const int n_vals = per_slot_of(KIND, OUT, p.nbins, p.nmu);
  const long long chunks =
      (rf::tile_count(static_cast<long long>(p.nx) * p.ny_loc) + p.chunk - 1) /
      p.chunk;
  const size_t smem = smem_of(KIND, OUT, p.stages, p.nzh, p.nbins, p.nmu,
                              p.nx + p.ny + p.nzh);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bin_spectrum_kernel<KIND, OUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bin_spectrum_kernel<KIND, OUT><<<n_blocks, 32 * warps, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_chunks_kernel<<<n_vals, kReduceThreads, 0, s>>>(p.partials, acc,
                                                         chunks, n_vals);
  return cudaGetLastError();
}

// fn<KIND, OUT>(args...) for run-time codes; the geometry pass has the
// isotropic and wedge keys alone (the multipoles' are the isotropic ones)
template <template <int, int> class F, typename... A>
cudaError_t dispatch(int kind, int out, A... args) {
#define RF_KB_OUTS(K)                                        \
  switch (out) {                                             \
    case kIso:                                               \
      return F<K, kIso>::run(args...);                       \
    case kPoles:                                             \
      return F<K, kPoles>::run(args...);                     \
    case kWedges:                                            \
      return F<K, kWedges>::run(args...);                    \
    case kProbe:                                             \
      return F<K, kProbe>::run(args...);                     \
    default:                                                 \
      return cudaErrorInvalidValue;                          \
  }
  switch (kind) {
    case kAuto:
      RF_KB_OUTS(kAuto)
    case kCross:
      RF_KB_OUTS(kCross)
    case kInterlaced:
      RF_KB_OUTS(kInterlaced)
    case kGrid:
      RF_KB_OUTS(kGrid)
    case kGeo:
      return out == kIso      ? F<kGeo, kIso>::run(args...)
             : out == kWedges ? F<kGeo, kWedges>::run(args...)
                              : cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
#undef RF_KB_OUTS
}

template <int KIND, int OUT>
struct PlanFn {
  static cudaError_t run(int nzh, long long rows, int nbins, int nmu,
                         int axes, int* out) {
    return make_plan<KIND, OUT>(nzh, rows, nbins, nmu, axes, out);
  }
};

template <int KIND, int OUT>
struct LaunchFn {
  static cudaError_t run(const Params* p, double* acc, int warps,
                         int n_blocks, cudaStream_t s) {
    return launch<KIND, OUT>(*p, acc, warps, n_blocks, s);
  }
};

}  // namespace

// The launch plan of (kind, out) on lattices of nx ny_loc lines (of an nx
// ny grid) of nz/2+1 floats with nbins edges (nmu wedges): plan[0..6) =
// warps a block, stages, blocks, dynamic shared memory in bytes, tiles a
// chunk, chunks.  kind 4 is the geometry pass (out 0 or 2), out 3 the read
// probe.
extern "C" int rf_bin_spectrum_plan(int kind, int out, int nx, int ny,
                                    int ny_loc, int nz, int nbins, int nmu,
                                    void* plan_out) {
  int* plan = static_cast<int*>(plan_out);
  if (nx < 1 || ny < 1 || ny_loc < 1 || nz < 1 || nbins < 1 || nmu < 1 ||
      !plan) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(dispatch<PlanFn>(
      kind, out, nz / 2 + 1, static_cast<long long>(nx) * ny_loc, nbins, nmu,
      nx + ny + nz / 2 + 1, plan));
}

// acc: float64 rows of nb out (nb = nbins, nbins nmu for wedges): for kind
// 4, the geometry pass, (sum w, sum w |k|) by key; for the others the
// value sums (sum w p_0 .. p_{NP-1}), NP = 3 for multipoles and 1
// otherwise; for the probe (out 3) one float64, the sum of the lattices'
// floats.  partials: float64 scratch of chunks times those.  kind: 0
// auto, 1 cross, 2 interlaced, 3 grid, 4 geometry; out: 0 iso, 1 poles, 2
// wedges, 3 probe.  a0..a3: float32 (nx, ny_loc, nz/2+1) lattices (re,
// im[, re2, im2]; a0 alone for grid; none for the geometry), 16-byte
// aligned, the ky rows [y_off, y_off + ny_loc) of the spectrum.  kvec:
// float32 (nx + ny + nz/2+1), the estimator's kx, ky, kz; wtab: the
// per-axis sinc tables of the same layout (read when order > 0); ptab: the
// per-axis cos then sin tables (read for interlaced); thr: float32 (nbins +
// 1), for each edge the least float32 k^2 whose sqrtf is above it
// (ops/binning.py:edge_thresholds).  ells: the multipoles' l, -1 for an
// unused slot.  warps, stages, n_blocks, chunk: from rf_bin_spectrum_plan.
// Returns the CUDA error of the launches.
extern "C" int rf_bin_spectrum(int kind, int out, const void* a0,
                               const void* a1, const void* a2, const void* a3,
                               const void* kvec, const void* wtab,
                               const void* ptab, const void* thr, void* acc,
                               void* partials, int warps, int stages,
                               int n_blocks, int chunk, int nx, int ny,
                               int nz,
                               int y_off, int ny_loc, int nbins, int nmu,
                               int los_axis, int order, int ell0, int ell1,
                               int ell2, float factor, void* stream) {
  const void* arrays[rf::kMaxRingArrays] = {a0, a1, a2, a3};
  if (kind < 0 || kind > kGeo || n_blocks < 1 || chunk < 1 || nbins < 1 ||
      nmu < 1 ||
      ny_loc < 1 || nx < 1 || y_off < 0 || y_off + ny_loc > ny ||
      los_axis < 0 || los_axis > 2 || order < 0 || order > 3 ||
      (warps != 1 && warps != 2 && warps != 4) ||
      stages < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  for (int a = 0; a < rf::kMaxRingArrays; ++a) {
    p.a[a] = static_cast<const float*>(arrays[a]);
    if (a < arrays_of(kind) &&
        (!p.a[a] || reinterpret_cast<uintptr_t>(p.a[a]) % 16 != 0)) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  p.kvec = static_cast<const float*>(kvec);
  p.wtab = static_cast<const float*>(wtab);
  p.ptab = static_cast<const float*>(ptab);
  p.thr = static_cast<const float*>(thr);
  p.partials = static_cast<double*>(partials);
  p.nx = nx;
  p.ny = ny;
  p.nz = nz;
  p.nzh = nz / 2 + 1;
  p.y_off = y_off;
  p.ny_loc = ny_loc;
  p.nbins = nbins;
  p.nmu = nmu;
  p.los_axis = los_axis;
  p.order = order;
  p.stages = stages;
  p.chunk = chunk;
  p.ells[0] = ell0;
  p.ells[1] = ell1;
  p.ells[2] = ell2;
  p.factor = factor;
  return static_cast<int>(dispatch<LaunchFn>(
      kind, out, static_cast<const Params*>(&p), static_cast<double*>(acc),
      warps, n_blocks, static_cast<cudaStream_t>(stream)));
}
