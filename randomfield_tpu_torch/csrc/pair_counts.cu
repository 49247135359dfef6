// KQ: weighted periodic pair counts DD(r[, mu]) and DD_ell(r) of two
// catalogs, every ordered pair (i, j) with i from catalog 1 and j from
// catalog 2 (the auto case passes one catalog twice).
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
// version (ops/paircount.py:pair_counts_plain, index_add_ of the same int64
// terms) bit for bit, and two calls give the same bits.
//
// Design (a simple kernel that is right): a block of 256 threads holds 256
// catalog-1 rows, one a thread, in registers, and streams its range of
// catalog 2 through shared memory in tiles of 256 (x, y, z, w) objects; the
// threads read each staged object as a broadcast.  A valid pair's terms go
// into a per-warp histogram in shared memory (one per block when the
// histograms would not fit), each int64 sum kept as two 32-bit words (a
// 64-bit atomicAdd on shared memory is a compare-and-swap loop on sm_90a;
// csrc/paint.cu does the same).  The block adds its histograms and then its
// sums into the output with int64 atomics, and its count of pairs examined
// into a total, which the caller compares with n1 n2.  The launcher
// (ops/paircount.py:launch_plan) splits catalog 2 into column ranges so
// that the grid fills the card.  A block's column and pair counters are
// 64-bit, so a row block of 2^31 pairs or more cannot wrap them.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // rows a block: ops/paircount.py:ROWS
constexpr int kTile = 256;     // catalog-2 objects a stage: paircount.TILE
constexpr int kWarps = kThreads / 32;

struct Args {
  const float4* p1;     // (x, y, z, w) a row, n1 rows
  const float4* p2;     // n2
  const float* edges2;  // nbins + 1 squared edges, ascending
  unsigned long long* out;      // (rows, slots / rows) int64 sums
  unsigned long long* visited;  // pairs examined
  float bx, by, bz;
  double scale;  // 2^s
  long long n2;
  long long cols;  // catalog-2 objects a block column range (a tile multiple)
  int n1, nbins, nmu, n_ells, ell0, ell1, ell2, los;
  int total;   // bins a row: nbins nmu (wedges) or nbins
  int slots;   // rows x total
  int copies;  // histograms a block: kWarps or 1
};

// add a term to a shared int64 sum kept as two 32-bit words: the low word,
// then the high word plus the carry out of the low one (exact mod 2^64)
__device__ __forceinline__ void shared_add(unsigned* lo, unsigned* hi,
                                           int slot, unsigned long long q) {
  const unsigned qlo = static_cast<unsigned>(q);
  const unsigned old = atomicAdd(lo + slot, qlo);
  const unsigned up = static_cast<unsigned>(q >> 32) + (old + qlo < old);
  if (up) atomicAdd(hi + slot, up);
}

__device__ __forceinline__ void add_term(unsigned* lo, unsigned* hi, int slot,
                                         float term, double scale) {
  const long long q = __double2ll_rn(static_cast<double>(term) * scale);
  if (q) shared_add(lo, hi, slot, static_cast<unsigned long long>(q));
}

// the minimum-image component d - box rint(d / box)
__device__ __forceinline__ float min_image(float a, float b, float box) {
  const float d = __fsub_rn(a, b);
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

// MODE 0: isotropic, 1: nmu wedges, 2: Legendre rows
template <int MODE>
__global__ void __launch_bounds__(kThreads)
pair_counts_kernel(const Args a) {
  extern __shared__ unsigned char smem[];
  float4* tile = reinterpret_cast<float4*>(smem);
  float* e2 = reinterpret_cast<float*>(tile + kTile);
  unsigned* lo = reinterpret_cast<unsigned*>(e2 + ((a.nbins + 4) & ~3));
  unsigned* hi = lo + a.copies * a.slots;
  __shared__ unsigned long long block_pairs;

  const int tid = threadIdx.x;
  for (int k = tid; k < 2 * a.copies * a.slots; k += kThreads) lo[k] = 0u;
  for (int k = tid; k <= a.nbins; k += kThreads) e2[k] = a.edges2[k];
  if (tid == 0) block_pairs = 0;
  const int copy = a.copies == 1 ? 0 : tid >> 5;
  unsigned* my_lo = lo + copy * a.slots;
  unsigned* my_hi = hi + copy * a.slots;

  const int row = static_cast<int>(blockIdx.x) * kThreads + tid;
  const bool live = row < a.n1;
  const float4 p = live ? a.p1[row] : make_float4(0.f, 0.f, 0.f, 0.f);
  const long long col_lo = static_cast<long long>(blockIdx.y) * a.cols;
  const long long col_hi =
      col_lo + a.cols < a.n2 ? col_lo + a.cols : a.n2;
  __syncthreads();
  const float e_lo = e2[0], e_hi = e2[a.nbins];

  long long examined = 0;
  for (long long c0 = col_lo; c0 < col_hi; c0 += kTile) {
    const long long left = col_hi - c0;
    const int count = left < kTile ? static_cast<int>(left) : kTile;
    if (tid < count) tile[tid] = a.p2[c0 + tid];
    __syncthreads();
    if (live) {
      examined += count;
      for (int jj = 0; jj < count; ++jj) {
        const float4 q = tile[jj];
        const float dx = min_image(p.x, q.x, a.bx);
        const float dy = min_image(p.y, q.y, a.by);
        const float dz = min_image(p.z, q.z, a.bz);
        const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                             __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        // bin in [0, nbins) and r2 > 0 (the edges are >= 0)
        if (!(r2 > e_lo && r2 <= e_hi)) continue;
        int lo_i = 1, hi_i = a.nbins;  // first edge >= r2 lies in [1, nbins]
        while (lo_i < hi_i) {
          const int mid = (lo_i + hi_i) >> 1;
          if (e2[mid] < r2) lo_i = mid + 1; else hi_i = mid;
        }
        int slot = lo_i - 1;
        const float wij = __fmul_rn(p.w, q.w);
        const float r = __fsqrt_rn(r2);
        float mu2 = 0.f;
        if (MODE != 0) {
          const float dl = a.los == 0 ? dx : (a.los == 1 ? dy : dz);
          mu2 = __fdiv_rn(__fmul_rn(dl, dl), r2);
        }
        if (MODE == 1) {
          int m = static_cast<int>(
              __fmul_rn(__fsqrt_rn(mu2), static_cast<float>(a.nmu)));
          m = min(max(m, 0), a.nmu - 1);
          slot = slot * a.nmu + m;
        }
        add_term(my_lo, my_hi, slot, wij, a.scale);
        add_term(my_lo, my_hi, a.total + slot, __fmul_rn(wij, r), a.scale);
        if (MODE == 2) {
          const int ells[3] = {a.ell0, a.ell1, a.ell2};
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            if (e < a.n_ells) {
              add_term(my_lo, my_hi, (2 + e) * a.total + slot,
                       __fmul_rn(wij, legendre_row(ells[e], mu2)), a.scale);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // the block's pairs examined: a warp sum, then one shared add a warp
  for (int off = 16; off > 0; off >>= 1) {
    examined += __shfl_down_sync(0xffffffffu, examined, off);
  }
  if ((tid & 31) == 0 && examined) {
    atomicAdd(&block_pairs, static_cast<unsigned long long>(examined));
  }
  __syncthreads();
  if (tid == 0 && block_pairs) atomicAdd(a.visited, block_pairs);
  for (int k = tid; k < a.slots; k += kThreads) {
    unsigned long long sum = 0ull;
    for (int c = 0; c < a.copies; ++c) {
      const int s = c * a.slots + k;
      sum += (static_cast<unsigned long long>(hi[s]) << 32) | lo[s];
    }
    if (sum) atomicAdd(a.out + k, sum);
  }
}

const void* kernel_of(int mode) {
  return mode == 0 ? reinterpret_cast<const void*>(&pair_counts_kernel<0>)
                   : (mode == 1 ? reinterpret_cast<const void*>(
                                      &pair_counts_kernel<1>)
                                : reinterpret_cast<const void*>(
                                      &pair_counts_kernel<2>));
}

// dynamic shared memory of a launch: the tile, the edges (padded to 4
// floats) and the histograms' two words a slot and copy
size_t smem_bytes(int nbins, int slots, int copies) {
  return sizeof(float4) * kTile + sizeof(float) * ((nbins + 4) & ~3) +
         2 * sizeof(unsigned) * static_cast<size_t>(copies) * slots;
}

}  // namespace

// p1: float4 (n1,) rows (x, y, z, w); p2: float4 (n2,); edges2: float32
// (nbins + 1,) ascending squared edges; out: int64 (slots,) zeroed, rows of
// `total` bins (w w, w w r, then one a Legendre row); visited: int64 (1,)
// zeroed.  mode 0 isotropic, 1 wedges (nmu), 2 Legendre rows (n_ells of
// ell0, ell1, ell2 in 0/2/4).  The grid is (ceil(n1 / 256), col_blocks),
// block column ranges of `cols` objects (a multiple of 256); copies is 8
// (one histogram a warp) or 1.
// Returns the CUDA error of the launch (0 on success).
extern "C" int rf_pair_counts(const void* p1, int n1, const void* p2,
                              long long n2, const void* edges2, int nbins,
                              float bx, float by, float bz, int mode, int nmu,
                              int n_ells, int ell0, int ell1, int ell2,
                              int los, double scale, long long cols,
                              int col_blocks, int copies, void* out,
                              void* visited, void* stream) {
  if (n1 <= 0 || n2 <= 0) return 0;
  Args a;
  a.p1 = static_cast<const float4*>(p1);
  a.p2 = static_cast<const float4*>(p2);
  a.edges2 = static_cast<const float*>(edges2);
  a.out = static_cast<unsigned long long*>(out);
  a.visited = static_cast<unsigned long long*>(visited);
  a.bx = bx;
  a.by = by;
  a.bz = bz;
  a.scale = scale;
  a.n2 = n2;
  a.cols = cols;
  a.n1 = n1;
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
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n1 + kThreads - 1) / kThreads),
                  static_cast<unsigned>(col_blocks));
  void* args[] = {&a};
  err = cudaLaunchKernel(kernel, grid, dim3(kThreads), args, bytes,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// registers a thread, blocks an SM, threads a block and dynamic shared
// memory bytes of the instance of `mode` at nbins bins, `slots` histogram
// slots and `copies` histograms a block.
extern "C" int rf_pair_counts_attributes(int mode, int nbins, int slots,
                                         int copies,
                                         void* registers, void* blocks_per_sm,
                                         void* threads, void* smem) {
  const void* kernel = kernel_of(mode);
  const size_t bytes = smem_bytes(nbins, slots, copies);
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
  *static_cast<int*>(smem) = static_cast<int>(bytes);
  return 0;
}
