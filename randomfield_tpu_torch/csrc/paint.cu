// KP: mass assignment of particles onto a periodic (nx, ny, nz) grid, in
// int64 fixed point, and the pass that turns the mass into a contrast.
//
// Replaces the XLA scatter-add of randomfield_tpu/models/zeldovich.py:118
// _paint (one float32 .at[].add per particle and window cell), which the
// JAX package keeps at validation scale.  Per particle, with u = (x +
// shift) / a in float32 (a divided, never multiplied by its reciprocal:
// a particle on a cell face then lands in the reference's cell):
//
//   NGP: the cell floor(u) (mod n, Python's non-negative modulo);
//   CIC: uc = u - 1/2, i0 = floor(uc), f = uc - i0; the 8 cells i0 + o
//        with weights w prod_a (o_a ? f_a : 1 - f_a);
//   TSC: uc = u - 1/2, i0 = rint(uc) (round half to even, jnp.round),
//        s = uc - i0; the 27 cells i0 + o - 1 with weights w prod_a
//        W_o(s_a), W = (0.5 (0.5 - s)^2, 0.75 - s^2, 0.5 (0.5 + s)^2);
//
// each product rounded in the reference's order (w first, then x, y, z).
// ``shift`` is the interlacing offset a/2, added in float32 before the
// division as the reference adds it to the positions, so no shifted copy of
// the positions exists; a scalar weight is an argument, never an array.
//
// Determinism: each window weight is rounded once to an int64 count of
// 2^-s units (__double2ll_rn, round half to even) and the counts are added
// as integers, so the sums do not depend on the order of the additions:
// two calls give the same bits, and so does the plain version
// (ops/paint.py:deposit_plain, index_add_ of the same int64 terms).  The
// host picks s with sum |w| 2^s < 2^62, so no cell and no total overflows.
//
// What bounds it on the H100: the positions read once (12 bytes a particle)
// and the int64 grid written once (8 bytes a cell).  What held the first
// design back was neither: one global 64-bit atomic a window term (1, 8 or
// 27 a particle) cost about 18 ms a term at 1024^3.  So the deposit is
// binned by Eulerian tile and summed in shared memory, with no global
// atomic a term (the passes move about 3x the bound's bytes: the positions
// three times, an int32 index, the shells):
//
//   1. count_kernel: each particle's anchor, the lowest cell of its window
//      (NGP floor(u), CIC i0, TSC i0 - 1; wrapped), and the anchor's tile
//      of kTile^3 cells (fewer at the grid's far edges); the particles a
//      tile, one atomic per distinct tile in a warp (__match_any_sync).
//   2. (host) cursor = the inclusive scan of the counts.
//   3. scatter_kernel: each particle's index into its tile's slots, the
//      cursor counted down a warp group at a time, so it ends at each
//      tile's exclusive start.  The order inside a tile is free.
//   4. deposit_kernel: a block a tile.  It zeroes an extended tile of
//      E^3 = (kTile + r)^3 int64 sums in shared memory (r = ORDER - 1, the
//      window's reach past its anchor), loads kBatch particles a thread
//      through the index before it adds their terms there, writes its own
//      cells once with plain stores (every cell has one owner: the grid is
//      never zeroed) and the rest, the shell past its far faces, to a
//      scratch slot of its own; the sum of what it wrote goes into the
//      catalog's total (one atomic a block), the contrast's mean.
//   5. gather_kernel (CIC, TSC): a block a tile; each cell at a local place
//      below r on some axis adds the shell slots that land on it, read on
//      the owner's side: no atomic at all (a second kernel of global
//      atomics for the shell was the other way; 0.42 of them a particle).
//
// Shared-memory sums: a 64-bit atomicAdd on shared memory is a
// compare-and-swap loop on sm_90a (ATOMS.CAST.SPIN.64; chip_smoke phase 0
// prints what it compiles to), so each cell keeps its low and high 32-bit
// words in two arrays; a term adds its low word, then its high word plus
// the carry out of the low one (ATOMS.ADD twice at most).  That is exact
// modulo 2^64, so still order-free.
//
// The x window of a slab mesh's rank (the counterpart of the local frame of
// randomfield_tpu/parallel/paint.py:178 _make_paint): with nx_loc > 0 the
// grid is the rank's nx_loc owned x planes [x0, x0 + nx_loc) of a global nx
// and a margin of m planes each side, the window's reach past the reference
// cell (0 for NGP, 1 for CIC and TSC).
// Every operation above runs as on the whole grid (u, the reference cell,
// the wrap on the global nx); a particle belongs to the rank whose planes
// hold its reference cell (NGP floor(u), CIC i0, TSC rint(uc):
// _axis_owner's rule), the others are skipped where they are counted, and
// an owned particle's anchor plane is wrap(ref) - x0 + m + (anchor - ref),
// so its window lies inside the rank's planes and margins whichever side of
// the periodic seam it sits on.  The window's tiles are those of an
// (nx_loc + 2m, ny, nz) grid; the gather's wrap along x there adds only the
// empty shell past its far face.  Folding the margins into the neighbours
// (ops/paint.py, parallel/paint.py) then gives the whole-grid deposit's
// rows bit for bit.
//
// The last kernel of the file writes float32((acc 2^-s) (1 / mean) - 1),
// each float64 operation rounded as written, in the plain version's order
// (a product by the host's reciprocal: PyTorch divides a CUDA tensor by a
// scalar that way, so the plain version does the same on every device).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;   // B: ops/paint.py:TILE
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* pos;       // (3, n) contiguous: x, then y, then z
  const float* weights;   // (n,) or null for the scalar w0
  float w0;
  long long n;
  int dims[3];
  int tiles[3];           // ceil(dims / kTile)
  int box[3];             // min(dims, kTile): the largest tile extent
  float spacing;
  float shift;
  double scale;           // 2^s
  int x0, nx_loc, gnx;    // the x window (nx_loc 0: the whole grid)
  int margin;             // the window's planes past each side
};

template <int ORDER>
struct Reach {
  static constexpr int R = ORDER - 1;
  static constexpr int E = kTile + R;   // the extended tile's side
};

// Python's non-negative i mod n; a cell inside [0, n) skips the division
__device__ __forceinline__ int wrap(int i, int n) {
  if (static_cast<unsigned>(i) < static_cast<unsigned>(n)) return i;
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// A particle's window: the wrapped anchor (its lowest cell) and each axis's
// factor for the cells anchor + o, o = 0..r (no factor for NGP).
template <int ORDER>
struct Window {
  int anchor[3];
  float fac[ORDER][3];
  bool owned;   // in the x window (always, on the whole grid)
};

// The anchor along x of a particle whose reference cell is ``ref`` and
// whose anchor is ref + rel (unwrapped): wrapped on the grid, or its place
// in the rank's x window (owned or not).
__device__ __forceinline__ int x_anchor(const Args& p, int ref, int rel,
                                        bool* owned) {
  if (p.nx_loc == 0) {
    *owned = true;
    return wrap(ref + rel, p.dims[0]);
  }
  const int r = wrap(ref, p.gnx) - p.x0;
  *owned = r >= 0 && r < p.nx_loc;
  return r + p.margin + rel;
}

// the window of a particle at x (length units)
template <int ORDER>
__device__ __forceinline__ Window<ORDER> window_of(const Args& p,
                                                   const float x[3]) {
  Window<ORDER> win;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float u = __fdiv_rn(__fadd_rn(x[a], p.shift), p.spacing);
    if (ORDER == 1) {
      const int ref = static_cast<int>(floorf(u));
      win.anchor[a] = a == 0 ? x_anchor(p, ref, 0, &win.owned)
                             : wrap(ref, p.dims[a]);
      win.fac[0][a] = 1.f;
    } else if (ORDER == 2) {
      const float uc = __fsub_rn(u, 0.5f);
      const int i0 = static_cast<int>(floorf(uc));
      const float f = __fsub_rn(uc, static_cast<float>(i0));
      win.anchor[a] = a == 0 ? x_anchor(p, i0, 0, &win.owned)
                             : wrap(i0, p.dims[a]);
      win.fac[0][a] = __fsub_rn(1.f, f);
      win.fac[1][a] = f;
    } else {
      const float uc = __fsub_rn(u, 0.5f);
      const int i0 = static_cast<int>(rintf(uc));
      const float s = __fsub_rn(uc, static_cast<float>(i0));
      const float lo = __fsub_rn(0.5f, s);
      const float hi = __fadd_rn(0.5f, s);
      win.anchor[a] = a == 0 ? x_anchor(p, i0, -1, &win.owned)
                             : wrap(i0 - 1, p.dims[a]);
      win.fac[0][a] = __fmul_rn(0.5f, __fmul_rn(lo, lo));
      win.fac[1][a] = __fsub_rn(0.75f, __fmul_rn(s, s));
      win.fac[2][a] = __fmul_rn(0.5f, __fmul_rn(hi, hi));
    }
  }
  return win;
}

__device__ __forceinline__ int tile_of(const Args& p, const int anchor[3]) {
  return (anchor[0] / kTile * p.tiles[1] + anchor[1] / kTile) * p.tiles[2] +
         anchor[2] / kTile;
}

__device__ __forceinline__ void load_position(const Args& p, long long i,
                                              float x[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) x[a] = p.pos[a * p.n + i];
}

// the anchor's tile of particle i, or -1 past the end (a warp's tail) and
// for a particle the x window does not own
template <int ORDER>
__device__ __forceinline__ int tile_or_none(const Args& p, long long i) {
  if (i >= p.n) return -1;
  float x[3];
  load_position(p, i, x);
  const Window<ORDER> win = window_of<ORDER>(p, x);
  return win.owned ? tile_of(p, win.anchor) : -1;
}

// A tile's shell slots: the extended-local cells (lx, ly, lz) past its far
// faces, with extents (ex, ey, ez), in three slabs laid out with the
// strides of the largest tile (bx, by and Ea = box_a + r):
//   lx >= ex:            (lx - ex) Ey Ez + ly Ez + lz
//   lx < ex, ly >= ey:   r Ey Ez + (lx r + ly - ey) Ez + lz
//   lx < ex, ly < ey:    r Ey Ez + bx r Ez + (lx by + ly) r + lz - ez
// (a tile smaller than the largest leaves its slots past its extents
// unused; ops/paint.py:shell_slots is the same rule).
struct Shell {
  int ext[3];   // Ea = box_a + r
  int bx, by, r;
  int size;

  __device__ __forceinline__ Shell(const Args& p, int r_) : r(r_) {
    for (int a = 0; a < 3; ++a) ext[a] = p.box[a] + r_;
    bx = p.box[0];
    by = p.box[1];
    size = r * ext[1] * ext[2] + bx * r * ext[2] + bx * by * r;
  }
  __device__ __forceinline__ int slab_x(int jx, int ly, int lz) const {
    return (jx * ext[1] + ly) * ext[2] + lz;
  }
  __device__ __forceinline__ int slab_y(int lx, int jy, int lz) const {
    return r * ext[1] * ext[2] + (lx * r + jy) * ext[2] + lz;
  }
  __device__ __forceinline__ int slab_z(int lx, int ly, int jz) const {
    return r * ext[1] * ext[2] + bx * r * ext[2] + (lx * by + ly) * r + jz;
  }
};

template <int ORDER>
__global__ void __launch_bounds__(kThreads)
count_kernel(const Args p, unsigned long long* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // whole warps walk together, so every lane reaches __match_any_sync
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x +
                        (threadIdx.x & ~31);
       base < p.n; base += stride) {
    const int t = tile_or_none<ORDER>(p, base + lane);
    const unsigned peers = __match_any_sync(kFull, t);
    if (t >= 0 && lane == __ffs(peers) - 1) {
      atomicAdd(counts + t, static_cast<unsigned long long>(__popc(peers)));
    }
  }
}

template <int ORDER, class Idx>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const Args p, unsigned long long* __restrict__ cursor,
               Idx* __restrict__ index) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x +
                        (threadIdx.x & ~31);
       base < p.n; base += stride) {
    const long long i = base + lane;
    const int t = tile_or_none<ORDER>(p, i);
    const unsigned peers = __match_any_sync(kFull, t);
    const int leader = __ffs(peers) - 1;
    const int cnt = __popc(peers);
    unsigned long long end = 0;
    if (t >= 0 && lane == leader) {
      end = atomicAdd(cursor + t, static_cast<unsigned long long>(
                                      -static_cast<long long>(cnt)));
    }
    end = __shfl_sync(kFull, end, leader);
    if (t >= 0) {
      const int rank = __popc(peers & ((1u << lane) - 1u));
      index[end - cnt + rank] = static_cast<Idx>(i);
    }
  }
}

// add a term to a shared int64 sum kept as two 32-bit words: the low word,
// then the high word plus the carry out of the low one (exact mod 2^64)
__device__ __forceinline__ void shared_add(unsigned* lo, unsigned* hi,
                                           int cell, unsigned long long q) {
  const unsigned qlo = static_cast<unsigned>(q);
  const unsigned old = atomicAdd(lo + cell, qlo);
  const unsigned up = static_cast<unsigned>(q >> 32) + (old + qlo < old);
  if (up) atomicAdd(hi + cell, up);
}

// a cell of the shared sums
__device__ __forceinline__ long long shared_sum(const unsigned* lo,
                                                const unsigned* hi, int s) {
  return static_cast<long long>(
      (static_cast<unsigned long long>(hi[s]) << 32) | lo[s]);
}

// particles a thread loads at once (their indices, then their positions
// and weights) before it adds any of their terms: a catalog in random
// order gathers its positions from anywhere, so several loads are in flight
constexpr int kBatch = 4;

template <int ORDER, class Idx>
__global__ void __launch_bounds__(kThreads)
deposit_kernel(const Args p, const unsigned long long* __restrict__ starts,
               const unsigned long long* __restrict__ counts,
               const Idx* __restrict__ index, long long* __restrict__ grid,
               long long* __restrict__ shell,
               unsigned long long* __restrict__ total) {
  constexpr int R = Reach<ORDER>::R, E = Reach<ORDER>::E, CELLS = E * E * E;
  __shared__ unsigned lo[CELLS], hi[CELLS];
  __shared__ unsigned long long warp_sums[kThreads / 32];
  const int t = blockIdx.x;
  const int tz = t % p.tiles[2], ty = (t / p.tiles[2]) % p.tiles[1],
            tx = t / (p.tiles[2] * p.tiles[1]);
  const int org[3] = {tx * kTile, ty * kTile, tz * kTile};
  int ext[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) ext[a] = min(kTile, p.dims[a] - org[a]);
  for (int c = threadIdx.x; c < CELLS; c += blockDim.x) lo[c] = hi[c] = 0u;
  __syncthreads();

  const long long first = static_cast<long long>(starts[t]);
  const long long count = static_cast<long long>(counts[t]);
  for (long long k0 = threadIdx.x; k0 < count;
       k0 += kBatch * static_cast<long long>(blockDim.x)) {
    long long ids[kBatch];
    float x[kBatch][3], w[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const long long k = k0 + b * static_cast<long long>(blockDim.x);
      ids[b] = k < count ? static_cast<long long>(index[first + k]) : -1;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (ids[b] < 0) continue;
      load_position(p, ids[b], x[b]);
      w[b] = p.weights ? p.weights[ids[b]] : p.w0;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (ids[b] < 0) continue;
      const Window<ORDER> win = window_of<ORDER>(p, x[b]);
      const int l0 = win.anchor[0] - org[0], l1 = win.anchor[1] - org[1],
                l2 = win.anchor[2] - org[2];
      // w fx, then (w fx) fy, then ((w fx) fy) fz: the reference's order
#pragma unroll
      for (int ox = 0; ox <= R; ++ox) {
        const float wx = ORDER == 1 ? w[b] : __fmul_rn(w[b], win.fac[ox][0]);
#pragma unroll
        for (int oy = 0; oy <= R; ++oy) {
          const float wy = ORDER == 1 ? wx : __fmul_rn(wx, win.fac[oy][1]);
#pragma unroll
          for (int oz = 0; oz <= R; ++oz) {
            const float wz = ORDER == 1 ? wy : __fmul_rn(wy, win.fac[oz][2]);
            shared_add(lo, hi, ((l0 + ox) * E + l1 + oy) * E + l2 + oz,
                       static_cast<unsigned long long>(__double2ll_rn(
                           __dmul_rn(static_cast<double>(wz), p.scale))));
          }
        }
      }
    }
  }
  __syncthreads();

  // the tile's own cells, each written once; every term lands in one of
  // them or in the shell, so their sum and the shell's is the tile's total
  unsigned long long sum = 0;
  for (int c = threadIdx.x; c < kTile * kTile * kTile; c += blockDim.x) {
    const int lz = c % kTile, ly = (c / kTile) % kTile,
              lx = c / (kTile * kTile);
    if (lx < ext[0] && ly < ext[1] && lz < ext[2]) {
      const long long v = shared_sum(lo, hi, (lx * E + ly) * E + lz);
      grid[(static_cast<long long>(org[0] + lx) * p.dims[1] + org[1] + ly) *
               p.dims[2] + org[2] + lz] = v;
      sum += static_cast<unsigned long long>(v);
    }
  }
  if constexpr (R > 0) {
    // the shell past the far faces, to this tile's scratch slot
    const Shell sh(p, R);
    long long* out = shell + static_cast<long long>(t) * sh.size;
    const int slab_x = R * sh.ext[1] * sh.ext[2];
    const int slab_y = sh.bx * R * sh.ext[2];
    for (int c = threadIdx.x; c < sh.size; c += blockDim.x) {
      int lx, ly, lz;
      bool valid;
      if (c < slab_x) {
        lx = ext[0] + c / (sh.ext[1] * sh.ext[2]);
        ly = (c / sh.ext[2]) % sh.ext[1];
        lz = c % sh.ext[2];
        valid = ly < ext[1] + R && lz < ext[2] + R;
      } else if (c < slab_x + slab_y) {
        const int d = c - slab_x;
        lx = d / (R * sh.ext[2]);
        ly = ext[1] + (d / sh.ext[2]) % R;
        lz = d % sh.ext[2];
        valid = lx < ext[0] && lz < ext[2] + R;
      } else {
        const int d = c - slab_x - slab_y;
        lx = d / (sh.by * R);
        ly = (d / R) % sh.by;
        lz = ext[2] + d % R;
        valid = lx < ext[0] && ly < ext[1];
      }
      if (valid) {
        const long long v = shared_sum(lo, hi, (lx * E + ly) * E + lz);
        out[c] = v;
        sum += static_cast<unsigned long long>(v);
      }
    }
  }
  // the catalog's total: exact int64 sums by warp and block, one atomic
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_down_sync(kFull, sum, off);
  }
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s = 0;
    for (int i = 0; i < kThreads / 32; ++i) s += warp_sums[i];
    if (s) atomicAdd(total, s);
  }
}

// The shell slots that land on coordinate x of an axis: a slot at depth j
// (0 <= j < r) past the far face of tile t' lands on (end(t') + j) mod n,
// end(t') = min((t' + 1) kTile, n); so for each j with (x - j) mod n a
// tile end (a multiple of kTile, or 0 for the last tile), that tile and
// depth.  Only an x at a local place below r has any.  Returns how many.
template <int R>
__device__ __forceinline__ int halo_sources(int x, int n, int tiles,
                                            int src[R], int depth[R]) {
  int m = 0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int y = wrap(x - j, n);
    if (y % kTile == 0) {
      src[m] = y == 0 ? tiles - 1 : y / kTile - 1;
      depth[m] = j;
      ++m;
    }
  }
  return m;
}

// A block a tile: the band of its cells with a local place below r on
// some axis (the only cells a shell lands on), each adding every shell
// slot that lands on it: per axis the cell's own (tile, place) or one of
// its shell sources, every combination but all-own.
template <int ORDER>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const Args p, const long long* __restrict__ shell,
              long long* __restrict__ grid) {
  constexpr int R = Reach<ORDER>::R, B = kTile;
  constexpr int SLAB_X = R * B * B, SLAB_Y = (B - R) * R * B;
  constexpr int BAND = SLAB_X + SLAB_Y + (B - R) * (B - R) * R;
  const int t = blockIdx.x;
  const int tz = t % p.tiles[2], ty = (t / p.tiles[2]) % p.tiles[1],
            tx = t / (p.tiles[2] * p.tiles[1]);
  const int own[3] = {tx, ty, tz};
  const Shell sh(p, R);
  for (int c = threadIdx.x; c < BAND; c += blockDim.x) {
    int l[3];
    if (c < SLAB_X) {
      l[0] = c / (B * B);
      l[1] = (c / B) % B;
      l[2] = c % B;
    } else if (c < SLAB_X + SLAB_Y) {
      const int d = c - SLAB_X;
      l[0] = R + d / (R * B);
      l[1] = (d / B) % R;
      l[2] = d % B;
    } else {
      const int d = c - SLAB_X - SLAB_Y;
      l[0] = R + d / ((B - R) * R);
      l[1] = R + (d / R) % (B - R);
      l[2] = d % R;
    }
    int x[3];
    bool inside = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      x[a] = own[a] * B + l[a];
      inside = inside && x[a] < p.dims[a];
    }
    if (!inside) continue;
    int src[3][R], depth[3][R], m[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      m[a] = l[a] < R ? halo_sources<R>(x[a], p.dims[a], p.tiles[a], src[a],
                                        depth[a])
                      : 0;
    }
    long long add = 0;
#pragma unroll
    for (int kx = 0; kx <= R; ++kx) {
#pragma unroll
      for (int ky = 0; ky <= R; ++ky) {
#pragma unroll
        for (int kz = 0; kz <= R; ++kz) {
          if (kx + ky + kz == 0 || kx > m[0] || ky > m[1] || kz > m[2]) {
            continue;
          }
          const int k[3] = {kx, ky, kz};
          int tile[3], loc[3];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            if (k[a] == 0) {
              tile[a] = own[a];
              loc[a] = l[a];
            } else {
              // the source tile's extent plus the depth
              tile[a] = src[a][k[a] - 1];
              loc[a] = min(B, p.dims[a] - tile[a] * B) + depth[a][k[a] - 1];
            }
          }
          const int slot =
              kx ? sh.slab_x(depth[0][kx - 1], loc[1], loc[2])
                 : ky ? sh.slab_y(loc[0], depth[1][ky - 1], loc[2])
                      : sh.slab_z(loc[0], loc[1], depth[2][kz - 1]);
          const long long from =
              (static_cast<long long>(tile[0]) * p.tiles[1] + tile[1]) *
                  p.tiles[2] + tile[2];
          add += shell[from * sh.size + slot];
        }
      }
    }
    grid[(static_cast<long long>(x[0]) * p.dims[1] + x[1]) * p.dims[2] +
         x[2]] += add;
  }
}

__global__ void __launch_bounds__(kThreads)
contrast_kernel(const long long* __restrict__ acc, float* __restrict__ out,
                long long cells, double inv_scale, double inv_mean) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < cells; i += stride) {
    const double m = __dmul_rn(static_cast<double>(acc[i]), inv_scale);
    out[i] = __double2float_rn(__dsub_rn(__dmul_rn(m, inv_mean), 1.0));
  }
}

unsigned grid_blocks(long long n) {
  const long long want = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(want < 132 * 64 ? (want > 0 ? want : 1)
                                               : 132 * 64);
}

// nx_loc > 0: the x window of planes [x0, x0 + nx_loc) of the global nx
// with a margin of one plane a side for CIC and TSC (none for NGP); the
// grid is then (nx_loc + 2 margin, ny, nz), and nx must be that extent.
bool make_args(const void* pos, const void* weights, float w0, long long n,
               int nx, int ny, int nz, float spacing, float shift,
               double scale, int order, int tile, int x0, int nx_loc,
               int gnx, Args* args) {
  const int margin = order == 1 ? 0 : 1;
  if (order < 1 || order > 3 || nx < 1 || ny < 1 || nz < 1 || n < 0 ||
      tile != kTile || nx_loc < 0 ||
      (nx_loc > 0 && (x0 < 0 || x0 + nx_loc > gnx ||
                      nx != nx_loc + 2 * margin))) {
    return false;
  }
  *args = Args{static_cast<const float*>(pos),
               static_cast<const float*>(weights), w0, n, {nx, ny, nz},
               {}, {}, spacing, shift, scale, x0, nx_loc, gnx, margin};
  for (int a = 0; a < 3; ++a) {
    args->tiles[a] = (args->dims[a] + kTile - 1) / kTile;
    args->box[a] = args->dims[a] < kTile ? args->dims[a] : kTile;
  }
  return true;
}

template <int ORDER, class Idx>
int launch_deposit(const Args& a, const unsigned long long* counts,
                   unsigned long long* cursor, void* index, void* shell,
                   void* grid, void* total, cudaStream_t st) {
  Idx* idx = static_cast<Idx*>(index);
  if (a.n > 0) {
    scatter_kernel<ORDER, Idx><<<grid_blocks(a.n), kThreads, 0, st>>>(
        a, cursor, idx);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned tiles =
      static_cast<unsigned>(a.tiles[0]) * a.tiles[1] * a.tiles[2];
  deposit_kernel<ORDER, Idx><<<tiles, kThreads, 0, st>>>(
      a, cursor, counts, idx, static_cast<long long*>(grid),
      static_cast<long long*>(shell),
      static_cast<unsigned long long*>(total));
  const cudaError_t e = cudaGetLastError();
  if constexpr (ORDER > 1) {
    if (e == cudaSuccess) {
      gather_kernel<ORDER><<<tiles, kThreads, 0, st>>>(
          a, static_cast<const long long*>(shell),
          static_cast<long long*>(grid));
      return static_cast<int>(cudaGetLastError());
    }
  }
  return static_cast<int>(e);
}

}  // namespace

// Pass 1.  pos: float32 (3, n) contiguous positions in length units;
// counts: int64 (tiles,) zeroed, tiles = prod ceil(dims / tile); tile must
// be kTile.  order: 1 NGP, 2 CIC, 3 TSC.  x0, nx_loc, gnx: the x window
// (nx_loc 0 for the whole grid; make_args).  Returns the CUDA error.
extern "C" int rf_paint_count(const void* pos, long long n, int nx, int ny,
                              int nz, float spacing, float shift, int order,
                              int tile, int x0, int nx_loc, int gnx,
                              void* counts, void* stream) {
  Args a;
  if (!make_args(pos, nullptr, 0.f, n, nx, ny, nz, spacing, shift, 1.0, order,
                 tile, x0, nx_loc, gnx, &a)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<unsigned long long*>(counts);
  const unsigned blocks = grid_blocks(n);
  if (order == 1) {
    count_kernel<1><<<blocks, kThreads, 0, st>>>(a, c);
  } else if (order == 2) {
    count_kernel<2><<<blocks, kThreads, 0, st>>>(a, c);
  } else {
    count_kernel<3><<<blocks, kThreads, 0, st>>>(a, c);
  }
  return static_cast<int>(cudaGetLastError());
}

// Passes 3-5.  weights: float32 (n,) or null (then every particle weighs
// w0); counts: pass 1's; cursor: their inclusive scan (int64, counted down
// to the exclusive starts); index: (n,) int32 (index_bytes 4) or int64 (8);
// shell: int64 (tiles, shell slots) scratch (ops/paint.py:shell_slots; none
// for NGP); grid: int64 (nx, ny, nz), written whole, in 2^-s units with
// scale = 2^s; total: int64 (1,) zeroed, gets the sum of every term;
// x0, nx_loc, gnx: pass 1's window (only its particles are indexed).
// Returns the CUDA error of the first launch that failed.
extern "C" int rf_paint_deposit(const void* pos, const void* weights,
                                float w0, long long n, int nx, int ny, int nz,
                                float spacing, float shift, double scale,
                                int order, int tile, int x0, int nx_loc,
                                int gnx, const void* counts, void* cursor,
                                void* index, int index_bytes, void* shell,
                                void* grid, void* total, void* stream) {
  Args a;
  if (!make_args(pos, weights, w0, n, nx, ny, nz, spacing, shift, scale,
                 order, tile, x0, nx_loc, gnx, &a) ||
      (index_bytes != 4 && index_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const unsigned long long*>(counts);
  auto* cur = static_cast<unsigned long long*>(cursor);
  const bool wide = index_bytes == 8;
  if (order == 1) {
    return wide ? launch_deposit<1, long long>(a, c, cur, index, shell, grid,
                                               total, st)
                : launch_deposit<1, int>(a, c, cur, index, shell, grid,
                                         total, st);
  }
  if (order == 2) {
    return wide ? launch_deposit<2, long long>(a, c, cur, index, shell, grid,
                                               total, st)
                : launch_deposit<2, int>(a, c, cur, index, shell, grid,
                                         total, st);
  }
  return wide ? launch_deposit<3, long long>(a, c, cur, index, shell, grid,
                                             total, st)
              : launch_deposit<3, int>(a, c, cur, index, shell, grid, total,
                                       st);
}

// acc: int64 (cells,) sums in units of 2^-s, inv_scale = 2^-s; out: float32
// (cells,) = (acc inv_scale) inv_mean - 1.  Returns the CUDA error.
extern "C" int rf_paint_contrast(const void* acc, void* out, long long cells,
                                 double inv_scale, double inv_mean,
                                 void* stream) {
  if (cells <= 0) return 0;
  contrast_kernel<<<grid_blocks(cells), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(acc), static_cast<float*>(out), cells,
      inv_scale, inv_mean);
  return static_cast<int>(cudaGetLastError());
}
