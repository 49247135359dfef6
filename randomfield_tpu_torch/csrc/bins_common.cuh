// The binning code that K5 (sample_power_bins.cu) and KB (bin_spectrum.cu)
// share: the estimator's edge search carried along a line of rising |k|,
// and the warp flush of runs of one bin.
//
// The bin of a mode is that of validate/stats.py: the count of float32
// edges below its float32 |k| (searchsorted on the left), minus one.  Along
// kz |k| never falls ((kx^2 + ky^2) + kz^2 with kz ascending, every float32
// step monotone), so a thread carries the count from one mode of its line
// to the next: one compare with the next edge a mode.  A thread keeps its
// run (the modes since its bin last changed) in registers and adds it to
// the warp's accumulator when the bin changes, through a butterfly over the
// warp, so the order of every addition is fixed by the shapes alone and two
// calls agree bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace rf {

constexpr unsigned kFullWarp = 0xFFFFFFFFu;

// Advance cnt (the edges below the last |k|; next = edges[cnt]) to |k| =
// km.  edges ends with +inf, so the walk stops there.
__device__ __forceinline__ void advance_edges(const float* edges, int& cnt,
                                              float& next, float km) {
  while (next < km) next = edges[++cnt];
}

// Add each flushing lane's run (bin, count n, the NP sums p and the |k| sum
// k) to the warp's accumulator acc: counts at acc[b], sum i at acc[(1 + i)
// stride + b], |k| at acc[(1 + NP) stride + b].  Every lane of the warp
// calls it together.  Lanes that flush one bin are summed by a butterfly
// over the whole warp (zeros elsewhere).
template <int NP>
__device__ __forceinline__ void flush_runs_n(double* acc, int stride,
                                             bool flush, int bin, int n,
                                             const double (&p)[NP],
                                             double k) {
  unsigned want = __ballot_sync(kFullWarp, flush);
  while (want) {
    const int leader = __ffs(want) - 1;
    const int b = __shfl_sync(kFullWarp, bin, leader);
    const bool mine = flush && bin == b;
    int vn = mine ? n : 0;
    double vp[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) vp[i] = mine ? p[i] : 0.0;
    double vk = mine ? k : 0.0;
    for (int off = 16; off > 0; off >>= 1) {
      vn += __shfl_xor_sync(kFullWarp, vn, off);
#pragma unroll
      for (int i = 0; i < NP; ++i) vp[i] += __shfl_xor_sync(kFullWarp, vp[i], off);
      vk += __shfl_xor_sync(kFullWarp, vk, off);
    }
    if ((threadIdx.x & 31) == leader) {
      acc[b] += static_cast<double>(vn);
#pragma unroll
      for (int i = 0; i < NP; ++i) acc[(1 + i) * stride + b] += vp[i];
      acc[(1 + NP) * stride + b] += vk;
    }
    __syncwarp();  // the next leader may add to the same bin
    want &= ~__ballot_sync(kFullWarp, mine);
  }
}

// One sum: (counts, sum, |k| sum) rows of nbins.
__device__ __forceinline__ void flush_runs(double* acc, int nbins, bool flush,
                                           int bin, int n, double p,
                                           double k) {
  const double pv[1] = {p};
  flush_runs_n<1>(acc, nbins, flush, bin, n, pv, k);
}

}  // namespace rf
