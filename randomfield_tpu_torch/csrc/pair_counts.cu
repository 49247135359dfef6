// KQ: weighted periodic pair counts DD(r[, mu]) and DD_ell(r) of two
// catalogs, over the ordered pairs (i, j) with i from catalog 1 and j from
// catalog 2 (the auto case passes one catalog twice) that lie in
// neighbouring cells of a cell list built on the card.
//
// Replaces XLA's randomfield_tpu/validate/paircount.py:79 _pair_count_loop
// (chunked (chunk, N2) separation blocks and the one-hot MXU contraction
// :63 _dot_rows), which has no pl.pallas_call.  Each pair runs the JAX
// chain in float32, every step rounded as written (__fsub_rn, __fdiv_rn,
// rintf, __fmul_rn, __fadd_rn, __fsqrt_rn), so no fused multiply-add moves
// a pair across an edge or a wedge:
//   d = p1 - p2;  d -= box rint(d / box)       (round half to even)
//   r2 = (dx^2 + dy^2) + dz^2;  bin = #(edges^2 < r2) - 1
//   valid: 0 <= bin < nbins and r2 > 0
//   mu2 = d_los^2 / r2;  wedge = min(int(sqrt(mu2) nmu), nmu - 1)
//   rows: w_i w_j, (w_i w_j) r, and w_i w_j ((2l + 1) L_l(mu2)) per ell
// Each term is rounded once to an int64 count of 2^-s units
// (__double2ll_rn, round half to even; ops/paircount.py:fixed_point_exponent
// picks s so that no bin can overflow) and added as an integer, so the sums
// do not depend on the order of the additions: the kernel equals its plain
// version (ops/paircount.py:pair_sums_plain, every pair by brute force,
// index_add_ of the same int64 terms) bit for bit, and two calls give the
// same bits, whatever order the cell sort leaves inside a cell.
//
// What bounds it on the H100: the chain's operations on the pairs examined
// (the catalogs are a few MB).  The first design streamed all of catalog 2
// past every row, 2^34 pairs at 2^17 objects, of which 98.8% lie in cells
// that cannot reach r_max.  This one examines only the pairs in
// neighbouring cells of side >= r_max (ops/paircount.py:cell_grid, which
// widens the side by a margin for float32 rounding):
//
//   1. cell_count_kernel: each object's cell, from the float64 remainder
//      of its float32 coordinates, into an int32 array; int64 atomics into
//      the cells' counts.
//   2. (host) cursor = the inclusive scan of the counts (torch.cumsum).
//   3. cell_scatter_kernel: each object's float4 row into its cell's range,
//      the cursor counted down, so it ends at each cell's exclusive start.
//      The order inside a cell is free.  The auto case sorts once.
//   4. (host) the work items: a run of at most kRows sorted catalog-1 rows
//      of one cell, ceil(n1(c) / kRows) of them a cell, their inclusive
//      scan a cell; item_cell_kernel writes each item's cell.
//   5. pair_cells_kernel: persistent blocks take items from an atomic
//      counter (so a clustered catalog's heavy items balance).  A warp's
//      lanes hold the item's rows in registers; the block streams catalog
//      2's objects of the cell's distinct neighbour cells (offsets -1, 0,
//      +1 on an axis of 3 cells or more, 0 and 1 on an axis of 2, 0 on an
//      axis of 1, so no pair is examined twice) through two shared-memory
//      tiles, the next tile's loads in flight while the warps take every
//      kWarps-th object of this one as a broadcast.  A pair in range goes
//      to its warp's queue in shared memory; each time the queue holds 32,
//      every lane bins one (edge search, root, wedge or Legendre rows,
//      atomics), so that work runs with no lane idle where a lane-a-pair
//      loop would run it for the 13% of pairs in range at the cost of all.
//
// The minimum image divides only where it can matter: for |d| <= box / 2
// (exact in float32) the quotient d / box lies in [-1/2, 1/2], rint gives
// +-0 and the component is d itself, so the branch skips __fdiv_rn for
// almost every pair a cell list examines; the pairs that wrap run the full
// chain.  The bits do not change.
//
// A valid pair's terms go into its warp's histogram in shared memory (one
// per block when the histograms would not fit), each int64 sum kept as two
// 32-bit words (a 64-bit atomicAdd on shared memory is a compare-and-swap
// loop on sm_90a; csrc/paint.cu does the same).  A block adds its
// histograms into the output with int64 atomics once, after its last item,
// and its count of pairs examined into a total, which the caller compares
// with the cell walk's own count (ops/paircount.py:expected_pairs).
// Offsets, counts and item indices are 64-bit, so catalogs of 2^31 objects
// and more do not wrap them.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads a block: ops/paircount.py:THREADS
constexpr int kRows = 32;      // catalog-1 rows an item (a warp's lanes): ROWS
constexpr int kTile = 256;     // catalog-2 objects a stage: paircount.TILE
constexpr int kWarps = kThreads / 32;
constexpr int kNeighbours = 27;
constexpr int kQueue = 64;     // a warp's queue of pairs in range
constexpr unsigned kFull = 0xffffffffu;

using u64 = unsigned long long;

// the cell grid: cells per axis, the float64 sides and nc / side
struct Grid {
  int nx, ny, nz;
  double bx, by, bz, ix, iy, iz;
};

struct Args {
  const float4* p1;      // catalog 1 sorted by cell: (x, y, z, w) a row
  const float4* p2;      // catalog 2 sorted by cell
  const u64* start1;     // each cell's first sorted row, catalog 1
  const u64* count1;     // its rows
  const u64* start2;
  const u64* count2;
  const u64* item_ends;  // inclusive scan of ceil(count1 / kRows)
  const int* item_cell;  // each item's cell
  const float* edges2;   // nbins + 1 squared edges, ascending
  u64* out;              // (rows, slots / rows) int64 sums
  u64* visited;          // pairs examined
  u64* work;             // the items taken
  float bx, by, bz, hx, hy, hz;  // the sides and their halves (exact)
  double scale;                  // 2^s
  int nx, ny, nz, cells;
  int nbins, nmu, n_ells, ell0, ell1, ell2, los;
  int total;   // bins a row: nbins nmu (wedges) or nbins
  int slots;   // rows x total
  int copies;  // histograms a block: kWarps or 1
};

// the cell of one coordinate: floor(remainder(x, box) nc / box) in float64,
// each step rounded as written (ops/paircount.py:cell_index repeats them),
// clamped to [0, nc - 1]; NaN goes to 0
__device__ __forceinline__ int axis_cell(float x, double box, double inv,
                                         int nc) {
  double u = fmod(static_cast<double>(x), box);
  if (u < 0.0) u = __dadd_rn(u, box);
  const double t = floor(__dmul_rn(u, inv));
  if (!(t >= 0.0)) return 0;
  return t < static_cast<double>(nc) ? static_cast<int>(t) : nc - 1;
}

__device__ __forceinline__ int flat_cell(const float4 p, const Grid& g) {
  return (axis_cell(p.x, g.bx, g.ix, g.nx) * g.ny +
          axis_cell(p.y, g.by, g.iy, g.ny)) * g.nz +
         axis_cell(p.z, g.bz, g.iz, g.nz);
}

__global__ void cell_count_kernel(const float4* rows, long long n, Grid g,
                                  int* cell, u64* counts) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int c = flat_cell(rows[i], g);
    cell[i] = c;
    atomicAdd(counts + c, 1ull);
  }
}

__global__ void cell_scatter_kernel(const float4* rows, long long n,
                                    const int* cell, u64* cursor,
                                    float4* sorted) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const u64 slot = atomicAdd(cursor + cell[i], ~0ull) - 1ull;
    sorted[slot] = rows[i];
  }
}

// item k's cell: the first cell whose inclusive item end exceeds k
__global__ void item_cell_kernel(const u64* item_ends, int cells,
                                 long long max_items, int* item_cell) {
  const long long n_items = static_cast<long long>(item_ends[cells - 1]);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       k < n_items && k < max_items; k += stride) {
    int lo = 0, hi = cells - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (static_cast<long long>(item_ends[mid]) > k) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    item_cell[k] = lo;
  }
}

// add a term to a shared int64 sum kept as two 32-bit words: the low word,
// then the high word plus the carry out of the low one (exact mod 2^64)
__device__ __forceinline__ void shared_add(unsigned* lo, unsigned* hi,
                                           int slot, u64 q) {
  const unsigned qlo = static_cast<unsigned>(q);
  const unsigned old = atomicAdd(lo + slot, qlo);
  const unsigned up = static_cast<unsigned>(q >> 32) + (old + qlo < old);
  if (up) atomicAdd(hi + slot, up);
}

__device__ __forceinline__ void add_term(unsigned* lo, unsigned* hi, int slot,
                                         float term, double scale) {
  const long long q = __double2ll_rn(static_cast<double>(term) * scale);
  if (q) shared_add(lo, hi, slot, static_cast<u64>(q));
}

// the minimum-image component d - box rint(d / box); where |d| <= box / 2
// that is d itself (rint of a quotient in [-1/2, 1/2] is +-0), so the
// division runs only for the pairs that wrap
__device__ __forceinline__ float min_image(float a, float b, float box,
                                           float half) {
  const float d = __fsub_rn(a, b);
  if (fabsf(d) <= half) return d;
  return __fsub_rn(d, __fmul_rn(box, rintf(__fdiv_rn(d, box))));
}

// (2 ell + 1) L_ell(mu2) as the JAX package's _LEGENDRE_EVEN rounds it
__device__ __forceinline__ float legendre_row(int ell, float mu2) {
  if (ell == 0) return 1.f;
  if (ell == 2) {
    return __fmul_rn(5.f, __fmul_rn(0.5f, __fsub_rn(__fmul_rn(3.f, mu2), 1.f)));
  }
  const float p = __fsub_rn(__fmul_rn(__fmul_rn(35.f, mu2), mu2),
                            __fmul_rn(30.f, mu2));
  return __fmul_rn(9.f, __fmul_rn(0.125f, __fadd_rn(p, 3.f)));
}

// a pair in range: its bin (and wedge), then its terms into the warp's
// histogram; dl is the line-of-sight component of the minimum image
template <int MODE>
__device__ __forceinline__ void bin_pair(const Args& a, float r2, float wij,
                                         float dl, const float* e2,
                                         unsigned* lo, unsigned* hi) {
  int lo_i = 1, hi_i = a.nbins;  // first edge >= r2 lies in [1, nbins]
  while (lo_i < hi_i) {
    const int mid = (lo_i + hi_i) >> 1;
    if (e2[mid] < r2) lo_i = mid + 1; else hi_i = mid;
  }
  int slot = lo_i - 1;
  const float r = __fsqrt_rn(r2);
  float mu2 = 0.f;
  if (MODE != 0) mu2 = __fdiv_rn(__fmul_rn(dl, dl), r2);
  if (MODE == 1) {
    int m = static_cast<int>(
        __fmul_rn(__fsqrt_rn(mu2), static_cast<float>(a.nmu)));
    m = min(max(m, 0), a.nmu - 1);
    slot = slot * a.nmu + m;
  }
  add_term(lo, hi, slot, wij, a.scale);
  add_term(lo, hi, a.total + slot, __fmul_rn(wij, r), a.scale);
  if (MODE == 2) {
    const int ells[3] = {a.ell0, a.ell1, a.ell2};
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      if (e < a.n_ells) {
        add_term(lo, hi, (2 + e) * a.total + slot,
                 __fmul_rn(wij, legendre_row(ells[e], mu2)), a.scale);
      }
    }
  }
}

// the neighbour offsets of an axis of n cells: 3 (-1, 0, +1), 2 (0, 1) or
// 1 (0), so that no cell is listed twice
__device__ __forceinline__ int axis_span(int n) { return n >= 3 ? 3 : n; }

__device__ __forceinline__ int wrap(int c, int o, int n) {
  const int v = c + o;
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

// the object at flat place f of an item's neighbour ranges: the last range
// that starts at or before f (ranges of no objects are skipped)
__device__ __forceinline__ float4 fetch(const float4* p2,
                                        const long long* start,
                                        const long long* pref, int n,
                                        long long f) {
  int r = 0, top = n - 1;
  while (r < top) {
    const int mid = (r + top + 1) >> 1;
    if (pref[mid] <= f) r = mid; else top = mid - 1;
  }
  return p2[start[r] + (f - pref[r])];
}

// MODE 0: isotropic, 1: nmu wedges, 2: Legendre rows
template <int MODE>
__global__ void __launch_bounds__(kThreads)
pair_cells_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* tile = reinterpret_cast<float4*>(smem);  // two stages
  float* e2 = reinterpret_cast<float*>(tile + 2 * kTile);
  unsigned* lo = reinterpret_cast<unsigned*>(e2 + ((a.nbins + 4) & ~3));
  unsigned* hi = lo + a.copies * a.slots;
  __shared__ long long nb_start[kNeighbours];     // a neighbour's first row
  __shared__ long long nb_pref[kNeighbours + 1];  // objects before it
  __shared__ long long s_item, s_row0;
  __shared__ int s_rows, s_neighbours;
  // each warp's queue: r2, w_i w_j, the line-of-sight component
  __shared__ float queue[kWarps][3][kQueue];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k = tid; k < 2 * a.copies * a.slots; k += kThreads) lo[k] = 0u;
  for (int k = tid; k <= a.nbins; k += kThreads) e2[k] = a.edges2[k];
  const int copy = a.copies == 1 ? 0 : warp;
  unsigned* my_lo = lo + copy * a.slots;
  unsigned* my_hi = hi + copy * a.slots;
  const long long n_items = static_cast<long long>(a.item_ends[a.cells - 1]);
  float* q_r2 = queue[warp][0];
  float* q_w = queue[warp][1];
  float* q_dl = queue[warp][2];
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  int queued = 0;                            // the same in every lane
  const int sx = axis_span(a.nx), sy = axis_span(a.ny), sz = axis_span(a.nz);
  u64 examined = 0;  // thread 0's count of the block's pairs

  for (;;) {
    if (tid == 0) s_item = static_cast<long long>(atomicAdd(a.work, 1ull));
    __syncthreads();
    const long long item = s_item;
    if (item >= n_items) break;
    if (warp == 0) {
      // the item's rows and its cell's distinct neighbours, a lane each
      const int c = a.item_cell[item];
      const long long n_c = static_cast<long long>(a.count1[c]);
      const long long first = static_cast<long long>(a.item_ends[c]) -
                              (n_c + kRows - 1) / kRows;
      const long long k = item - first;
      const int cz = c % a.nz, cy = (c / a.nz) % a.ny, cx = c / (a.nz * a.ny);
      long long cnt = 0, st = 0;
      if (lane < sx * sy * sz) {
        const int ix = lane / (sy * sz), iy = (lane / sz) % sy, iz = lane % sz;
        const int nb = (wrap(cx, sx == 3 ? ix - 1 : ix, a.nx) * a.ny +
                        wrap(cy, sy == 3 ? iy - 1 : iy, a.ny)) * a.nz +
                       wrap(cz, sz == 3 ? iz - 1 : iz, a.nz);
        cnt = static_cast<long long>(a.count2[nb]);
        st = static_cast<long long>(a.start2[nb]);
      }
      long long incl = cnt;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const long long v = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += v;
      }
      if (lane < kNeighbours) {
        nb_start[lane] = st;
        nb_pref[lane + 1] = incl;
      }
      if (lane == 0) {
        nb_pref[0] = 0;
        s_row0 = static_cast<long long>(a.start1[c]) + k * kRows;
        const long long left = n_c - k * kRows;
        s_rows = left < kRows ? static_cast<int>(left) : kRows;
        s_neighbours = sx * sy * sz;
      }
    }
    __syncthreads();
    const int nrows = s_rows, nn = s_neighbours;
    const long long total = nb_pref[nn];
    const bool live = lane < nrows;
    const float4 p = live ? a.p1[s_row0 + lane]
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    if (tid == 0) {
      examined += static_cast<u64>(nrows) * static_cast<u64>(total);
    }
    const float e_lo = e2[0], e_hi = e2[a.nbins];

    float4 next = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tid < total) next = fetch(a.p2, nb_start, nb_pref, nn, tid);
    int buf = 0;
    for (long long base = 0; base < total; base += kTile) {
      const long long left = total - base;
      const int count = left < kTile ? static_cast<int>(left) : kTile;
      float4* stage = tile + buf * kTile;
      if (tid < count) stage[tid] = next;
      __syncthreads();
      if (base + kTile + tid < total) {
        next = fetch(a.p2, nb_start, nb_pref, nn, base + kTile + tid);
      }
      // every lane of the warp takes every kWarps-th staged object; the
      // pairs in range go to the warp's queue, and each time it holds 32
      // of them every lane bins one, so the binning runs with all lanes
      // busy (in range: about 13% of the pairs examined)
      for (int j = warp; j < count; j += kWarps) {
        const float4 q = stage[j];
        const float dx = min_image(p.x, q.x, a.bx, a.hx);
        const float dy = min_image(p.y, q.y, a.by, a.hy);
        const float dz = min_image(p.z, q.z, a.bz, a.hz);
        const float r2 = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        // bin in [0, nbins) and r2 > 0 (the edges are >= 0)
        const bool hit = live && r2 > e_lo && r2 <= e_hi;
        const unsigned mask = __ballot_sync(kFull, hit);
        if (mask == 0u) continue;
        if (hit) {
          const int at = queued + __popc(mask & below);
          q_r2[at] = r2;
          q_w[at] = __fmul_rn(p.w, q.w);
          if (MODE != 0) q_dl[at] = a.los == 0 ? dx : (a.los == 1 ? dy : dz);
        }
        queued += __popc(mask);
        if (queued >= 32) {
          __syncwarp();
          bin_pair<MODE>(a, q_r2[lane], q_w[lane], q_dl[lane], e2, my_lo,
                         my_hi);
          queued -= 32;
          __syncwarp();
          if (lane < queued) {
            q_r2[lane] = q_r2[32 + lane];
            q_w[lane] = q_w[32 + lane];
            q_dl[lane] = q_dl[32 + lane];
          }
          __syncwarp();
        }
      }
      buf ^= 1;
    }
  }

  // every warp has left its last item at the barrier above; it bins what
  // is left in its queue
  __syncwarp();
  if (lane < queued) {
    bin_pair<MODE>(a, q_r2[lane], q_w[lane], q_dl[lane], e2, my_lo, my_hi);
  }
  __syncthreads();
  if (tid == 0 && examined) atomicAdd(a.visited, examined);
  for (int k = tid; k < a.slots; k += kThreads) {
    u64 sum = 0ull;
    for (int c = 0; c < a.copies; ++c) {
      const int s = c * a.slots + k;
      sum += (static_cast<u64>(hi[s]) << 32) | lo[s];
    }
    if (sum) atomicAdd(a.out + k, sum);
  }
}

const void* kernel_of(int which) {
  switch (which) {
    case 0: return reinterpret_cast<const void*>(&pair_cells_kernel<0>);
    case 1: return reinterpret_cast<const void*>(&pair_cells_kernel<1>);
    case 2: return reinterpret_cast<const void*>(&pair_cells_kernel<2>);
    case 3: return reinterpret_cast<const void*>(&cell_count_kernel);
    case 4: return reinterpret_cast<const void*>(&cell_scatter_kernel);
    default: return reinterpret_cast<const void*>(&item_cell_kernel);
  }
}

// dynamic shared memory of a pair launch: the two tiles, the edges (padded
// to 4 floats) and the histograms' two words a slot and copy
size_t smem_bytes(int nbins, int slots, int copies) {
  return sizeof(float4) * 2 * kTile + sizeof(float) * ((nbins + 4) & ~3) +
         2 * sizeof(unsigned) * static_cast<size_t>(copies) * slots;
}

unsigned stride_blocks(long long n) {
  const long long want = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(want < 132 * 32 ? (want > 0 ? want : 1)
                                               : 132 * 32);
}

Grid make_grid(int nx, int ny, int nz, double bx, double by, double bz,
               double ix, double iy, double iz) {
  Grid g;
  g.nx = nx;
  g.ny = ny;
  g.nz = nz;
  g.bx = bx;
  g.by = by;
  g.bz = bz;
  g.ix = ix;
  g.iy = iy;
  g.iz = iz;
  return g;
}

}  // namespace

// Pass 1.  rows: float32 (n, 4); the grid's cells per axis, its float64
// sides and nc / side per axis (ops/paircount.py:cell_grid); cell: int32
// (n,) out; counts: int64 (nx ny nz,) zeroed.
extern "C" int rf_pair_cells(const void* rows, long long n, int nx, int ny,
                             int nz, double bx, double by, double bz,
                             double ix, double iy, double iz, void* cell,
                             void* counts, void* stream) {
  if (n <= 0) return 0;
  const Grid g = make_grid(nx, ny, nz, bx, by, bz, ix, iy, iz);
  cell_count_kernel<<<stride_blocks(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(rows), n, g, static_cast<int*>(cell),
      static_cast<u64*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// Pass 3.  cell: pass 1's; cursor: the inclusive scan of pass 1's counts
// (int64), counted down to the cells' exclusive starts; sorted: float32
// (n, 4) out, the rows grouped by cell.
extern "C" int rf_pair_scatter(const void* rows, long long n, const void* cell,
                               void* cursor, void* sorted, void* stream) {
  if (n <= 0) return 0;
  cell_scatter_kernel<<<stride_blocks(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(rows), n, static_cast<const int*>(cell),
      static_cast<u64*>(cursor), static_cast<float4*>(sorted));
  return static_cast<int>(cudaGetLastError());
}

// Passes 4 and 5.  p1, p2: the sorted rows; start, count: each cell's
// first sorted row and rows (int64, nx ny nz); item_ends: the inclusive
// scan of ceil(count1 / 32) (int64); item_cell: int32 (max_items,) scratch,
// max_items >= the items; edges2: float32 (nbins + 1,) ascending squared
// edges; out: int64 (slots,) zeroed, rows of `total` bins (w w, w w r, then
// one a Legendre row); visited, work: int64 (1,) zeroed.  mode 0 isotropic,
// 1 wedges (nmu), 2 Legendre rows (n_ells of ell0, ell1, ell2 in 0/2/4);
// copies is 8 (one histogram a warp) or 1.  The pair kernel runs
// persistent blocks, as many as fit on the card (at most max_items).
// Returns the CUDA error of the first launch that failed (0 on success).
extern "C" int rf_pair_counts(const void* p1, const void* start1,
                              const void* count1, const void* item_ends,
                              const void* p2, const void* start2,
                              const void* count2, int nx, int ny, int nz,
                              long long max_items, void* item_cell,
                              const void* edges2, int nbins, float bx,
                              float by, float bz, int mode, int nmu,
                              int n_ells, int ell0, int ell1, int ell2,
                              int los, double scale, int copies, void* out,
                              void* visited, void* work, void* stream) {
  if (max_items <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cells = nx * ny * nz;
  item_cell_kernel<<<stride_blocks(max_items), kThreads, 0, st>>>(
      static_cast<const u64*>(item_ends), cells, max_items,
      static_cast<int*>(item_cell));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  Args a;
  a.p1 = static_cast<const float4*>(p1);
  a.p2 = static_cast<const float4*>(p2);
  a.start1 = static_cast<const u64*>(start1);
  a.count1 = static_cast<const u64*>(count1);
  a.start2 = static_cast<const u64*>(start2);
  a.count2 = static_cast<const u64*>(count2);
  a.item_ends = static_cast<const u64*>(item_ends);
  a.item_cell = static_cast<const int*>(item_cell);
  a.edges2 = static_cast<const float*>(edges2);
  a.out = static_cast<u64*>(out);
  a.visited = static_cast<u64*>(visited);
  a.work = static_cast<u64*>(work);
  a.bx = bx;
  a.by = by;
  a.bz = bz;
  a.hx = 0.5f * bx;
  a.hy = 0.5f * by;
  a.hz = 0.5f * bz;
  a.scale = scale;
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.cells = cells;
  a.nbins = nbins;
  a.nmu = nmu;
  a.n_ells = n_ells;
  a.ell0 = ell0;
  a.ell1 = ell1;
  a.ell2 = ell2;
  a.los = los;
  a.total = mode == 1 ? nbins * nmu : nbins;
  a.slots = (mode == 2 ? 2 + n_ells : 2) * a.total;
  a.copies = copies;
  const size_t bytes = smem_bytes(nbins, a.slots, copies);
  const void* kernel = kernel_of(mode);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  int per_sm = 0, device = 0, sms = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, bytes);
  }
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long fill = static_cast<long long>(per_sm) * sms;
  const unsigned blocks =
      static_cast<unsigned>(fill < max_items ? fill : max_items);
  void* args[] = {&a};
  err = cudaLaunchKernel(kernel, dim3(blocks), dim3(kThreads), args, bytes,
                         st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// registers a thread, blocks an SM, threads a block and dynamic shared
// memory bytes of an instance: `which` 0-2 the pair kernel of that mode at
// nbins bins, `slots` histogram slots and `copies` histograms a block; 3
// the count pass, 4 the scatter pass, 5 the item cells.
extern "C" int rf_pair_counts_attributes(int which, int nbins, int slots,
                                         int copies, void* registers,
                                         void* blocks_per_sm, void* threads,
                                         void* smem) {
  const void* kernel = kernel_of(which);
  const size_t bytes = which <= 2 ? smem_bytes(nbins, slots, copies) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kThreads, bytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *static_cast<int*>(registers) = attr.numRegs;
  *static_cast<int*>(blocks_per_sm) = blocks;
  *static_cast<int*>(threads) = kThreads;
  *static_cast<int*>(smem) = static_cast<int>(bytes + attr.sharedSizeBytes);
  return 0;
}
