// KM: the Minkowski curvature invariants of each voxel and their threshold
// bins, in one pass over the field and its nine spectral derivatives.
//
// Per voxel, from u, g = grad u (g0, g1, g2) and the Hessian A (a00, a11,
// a22, a01, a02, a12), in float32 rounded as the JAX expression is written
// (randomfield_tpu/validate/minkowski.py:91-117; every product, sum,
// square root and quotient rounded in that order, no contraction):
//
//   w1 = |g|,  w2 = (g.A.g - |g|^2 tr A) / |g|^2,  w3 = g.cof(A).g / |g|^3
//
// (0 where |g|^2 = 0), then the threshold bin: the count of float32 edges
// <= u, less 1, as searchsorted(side='right') - 1 gives.  Out: per bin the
// int64 count and the float64 sums of w1, w2 and w3, and the int64 count of
// the voxels at or above the last edge (the tail).  w1, w2 and w3 are never
// written to device memory.
//
// Replaces XLA's _field_invariants (:66) and _threshold_bins (:120, a
// one-hot contraction on the MXU) after the derivative fields, which the
// port builds with its hand FFTs (K6, K3, K4); no Pallas kernel.
//
// What bounds it on the H100: device-memory bytes, ten float32 reads a
// voxel (42.95 GB, 12.82 ms at 1024^3 and 3.35 TB/s); per voxel some 70
// float32 operations, a square root, two divisions and a binary search of
// the edges.  Design: a grid-stride loop over float4 groups, the next
// group's ten 16-byte loads issued before this group's arithmetic (one
// block of 256 threads an SM holds the slots below, so the loads in flight
// come from the registers, not from more warps); each thread adds its voxels into slots of its
// own in shared memory (3 float64 sums and a 32-bit count a bin, laid out
// [quantity][bin][thread], so a warp's adds fall in distinct banks and no
// two threads ever add to one slot); at the end a block sums its threads'
// slots in thread order into a partial of its own, and a second launch
// sums the partials in block order.  Each voxel's thread, each thread's
// order and the grid are fixed by the shapes and nbins, so two calls give
// the same bits.
#include <cuda_runtime.h>

namespace {

constexpr int kGridCap = 1056;  // 8 waves of one block on 132 SMs
constexpr size_t kSmemCap = 232448;

struct Fields {
  const float* u;
  const float* d[9];  // g0 g1 g2 a00 a11 a22 a01 a02 a12
};

struct Invariants {
  float w1, w2, w3;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ Invariants invariants(float g0, float g1, float g2,
                                                 float a00, float a11,
                                                 float a22, float a01,
                                                 float a02, float a12) {
  const float g00 = mul(g0, g0), g11 = mul(g1, g1), g22 = mul(g2, g2);
  const float gg = add(add(g00, g11), g22);
  const float tr = add(add(a00, a11), a22);
  const float gag = add(
      add(add(mul(g00, a00), mul(g11, a11)), mul(g22, a22)),
      mul(2.f, add(add(mul(mul(g0, g1), a01), mul(mul(g0, g2), a02)),
                   mul(mul(g1, g2), a12))));
  const float two_g0 = mul(2.f, g0), two_g1 = mul(2.f, g1);
  float cof = mul(g00, sub(mul(a11, a22), mul(a12, a12)));
  cof = add(cof, mul(g11, sub(mul(a00, a22), mul(a02, a02))));
  cof = add(cof, mul(g22, sub(mul(a00, a11), mul(a01, a01))));
  cof = add(cof, mul(mul(two_g0, g1), sub(mul(a02, a12), mul(a01, a22))));
  cof = add(cof, mul(mul(two_g0, g2), sub(mul(a01, a12), mul(a02, a11))));
  cof = add(cof, mul(mul(two_g1, g2), sub(mul(a01, a02), mul(a12, a00))));
  Invariants w;
  w.w1 = __fsqrt_rn(gg);
  if (gg > 0.f) {
    w.w2 = __fdiv_rn(sub(gag, mul(gg, tr)), gg);
    w.w3 = __fdiv_rn(cof, mul(gg, w.w1));
  } else {
    w.w2 = 0.f;
    w.w3 = 0.f;
  }
  return w;
}

struct Slots {
  double* sums;          // [3][nbins][threads]
  unsigned int* counts;  // [nbins + 1][threads]
  const float* edges;    // nbins + 1
  int nbins, threads;
};

__device__ __forceinline__ void add_voxel(const Slots& s, int t, float u,
                                          const Invariants& w) {
  int lo = 0, hi = s.nbins + 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s.edges[mid] <= u) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int b = lo - 1;
  if (b < 0) return;
  if (b >= s.nbins) {
    s.counts[s.nbins * s.threads + t] += 1u;
    return;
  }
  const int at = b * s.threads + t;
  const int q = s.nbins * s.threads;
  s.counts[at] += 1u;
  s.sums[at] += static_cast<double>(w.w1);
  s.sums[q + at] += static_cast<double>(w.w2);
  s.sums[2 * q + at] += static_cast<double>(w.w3);
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void load_group(const Fields& f, long long i,
                                           float4& u, float4 (&d)[9]) {
  u = reinterpret_cast<const float4*>(f.u)[i];
#pragma unroll
  for (int c = 0; c < 9; ++c) d[c] = reinterpret_cast<const float4*>(f.d[c])[i];
}

// partial: [block][3 nbins + nbins + 1] float64 sums, then int64 counts
__global__ void minkowski_bins_kernel(const Fields f, const float* edges,
                                      int nbins, long long n, double* psums,
                                      long long* pcounts) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int threads = blockDim.x, t = threadIdx.x;
  Slots s;
  s.sums = reinterpret_cast<double*>(smem);
  s.counts = reinterpret_cast<unsigned int*>(s.sums + 3 * nbins * threads);
  float* e = reinterpret_cast<float*>(s.counts + (nbins + 1) * threads);
  s.edges = e;
  s.nbins = nbins;
  s.threads = threads;
  for (int i = t; i < 3 * nbins * threads; i += threads) s.sums[i] = 0.0;
  for (int i = t; i < (nbins + 1) * threads; i += threads) s.counts[i] = 0u;
  for (int i = t; i <= nbins; i += threads) e[i] = edges[i];
  __syncthreads();

  const long long n4 = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * threads;
  // the next group's ten loads are issued before this group's arithmetic
  long long i = static_cast<long long>(blockIdx.x) * threads + t;
  float4 u, d[9];
  if (i < n4) load_group(f, i, u, d);
  while (i < n4) {
    const long long next = i + stride;
    float4 un, dn[9];
    if (next < n4) load_group(f, next, un, dn);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const Invariants w = invariants(
          lane(d[0], j), lane(d[1], j), lane(d[2], j), lane(d[3], j),
          lane(d[4], j), lane(d[5], j), lane(d[6], j), lane(d[7], j),
          lane(d[8], j));
      add_voxel(s, t, lane(u, j), w);
    }
    u = un;
#pragma unroll
    for (int c = 0; c < 9; ++c) d[c] = dn[c];
    i = next;
  }
  // the last n % 4 voxels: one each to the first threads of block 0
  const long long rest = 4 * n4 + t;
  if (blockIdx.x == 0 && rest < n) {
    float v[9];
#pragma unroll
    for (int c = 0; c < 9; ++c) v[c] = f.d[c][rest];
    const Invariants w =
        invariants(v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8]);
    add_voxel(s, t, f.u[rest], w);
  }
  __syncthreads();

  const int n_sums = 3 * nbins;
  const int width = n_sums + nbins + 1;
  for (int slot = t; slot < width; slot += threads) {
    if (slot < n_sums) {
      const double* row = s.sums + static_cast<long long>(slot) * threads;
      double acc = 0.0;
      for (int k = 0; k < threads; ++k) acc += row[k];
      psums[static_cast<long long>(blockIdx.x) * n_sums + slot] = acc;
    } else {
      const unsigned int* row =
          s.counts + static_cast<long long>(slot - n_sums) * threads;
      long long acc = 0;
      for (int k = 0; k < threads; ++k) acc += row[k];
      pcounts[static_cast<long long>(blockIdx.x) * (nbins + 1) + slot - n_sums] =
          acc;
    }
  }
}

// sums the blocks' partials in block order: a thread a slot
__global__ void minkowski_total_kernel(const double* psums,
                                       const long long* pcounts, int blocks,
                                       int nbins, double* sums,
                                       long long* counts) {
  const int n_sums = 3 * nbins;
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot < n_sums) {
    double acc = 0.0;
    for (int b = 0; b < blocks; ++b) acc += psums[static_cast<long long>(b) * n_sums + slot];
    sums[slot] = acc;
  } else if (slot < n_sums + nbins + 1) {
    const int c = slot - n_sums;
    long long acc = 0;
    for (int b = 0; b < blocks; ++b) acc += pcounts[static_cast<long long>(b) * (nbins + 1) + c];
    counts[c] = acc;
  }
}

size_t slots_bytes(int nbins, int threads) {
  return static_cast<size_t>(threads) *
             (3 * sizeof(double) * nbins + sizeof(unsigned int) * (nbins + 1)) +
         sizeof(float) * (nbins + 1);
}

}  // namespace

// The launch KM makes for nbins: out[0] threads a block (0 if nbins is too
// many for the shared slots), out[1] blocks, out[2] shared bytes a block.
extern "C" int rf_minkowski_plan(int nbins, long long n, void* plan_out) {
  int* out = static_cast<int*>(plan_out);
  int threads = 256;
  while (threads >= 32 && slots_bytes(nbins, threads) > kSmemCap) threads /= 2;
  if (threads < 32 || nbins < 1) {
    out[0] = out[1] = out[2] = 0;
    return 0;
  }
  const long long groups = (n / 4 + threads - 1) / threads;
  out[0] = threads;
  out[1] = static_cast<int>(groups < 1 ? 1 : groups < kGridCap ? groups : kGridCap);
  out[2] = static_cast<int>(slots_bytes(nbins, threads));
  return 0;
}

// u and the nine derivative fields: float32, n voxels each, contiguous and
// 16-byte aligned.  edges: float32 (nbins + 1,) ascending.  scratch: float64
// (blocks, 3 nbins) then int64 (blocks, nbins + 1) partials, as
// rf_minkowski_plan sizes them.  sums: float64 (3, nbins); counts: int64
// (nbins + 1,): the bins, then the tail.  Returns the CUDA error of the
// launches.
extern "C" int rf_minkowski_bins(void* u, void* g0, void* g1, void* g2,
                                 void* a00, void* a11, void* a22, void* a01,
                                 void* a02, void* a12, void* edges, int nbins,
                                 long long n, void* psums, void* pcounts,
                                 void* sums, void* counts, void* stream) {
  int plan[3];
  rf_minkowski_plan(nbins, n, plan);
  if (plan[0] == 0 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Fields f{static_cast<const float*>(u),
                 {static_cast<const float*>(g0), static_cast<const float*>(g1),
                  static_cast<const float*>(g2), static_cast<const float*>(a00),
                  static_cast<const float*>(a11), static_cast<const float*>(a22),
                  static_cast<const float*>(a01), static_cast<const float*>(a02),
                  static_cast<const float*>(a12)}};
  cudaError_t err = cudaFuncSetAttribute(
      minkowski_bins_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      plan[2]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  minkowski_bins_kernel<<<plan[1], plan[0], plan[2], st>>>(
      f, static_cast<const float*>(edges), nbins, n,
      static_cast<double*>(psums), static_cast<long long*>(pcounts));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slots = 4 * nbins + 1;
  minkowski_total_kernel<<<(slots + 127) / 128, 128, 0, st>>>(
      static_cast<const double*>(psums), static_cast<const long long*>(pcounts),
      plan[1], nbins, static_cast<double*>(sums),
      static_cast<long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}
