// K5: the binned power of the sampler='pallas' spectrum, with no spectrum in
// device memory.  It regenerates K1's draws (the same counter-based stream,
// threefry.cuh, and the same amplitude, sigma_common.cuh) and, per interior
// mode, adds (w, w |c|^2 V, w |k|) with the Hermitian multiplicity w = 2 to
// the mode's log10-k bin.  The self-conjugate kz = 0 and Nyquist planes are
// not binned here: their raw draws go out as (nx, n_planes, ny) lattices, and
// the caller makes them Hermitian and bins them with multiplicity 1.
//
// Replaces randomfield_tpu/ops/pallas_sampler.py:_make_kernel with bins=,
// via sample_power_bins_reim (caller engine/staged.py:_sample_power_v3).
// Per mode, as the TPU kernel: r^2 = -2 ln u1 (no trig), amp = sigma /
// sqrt(2) exp(((-k^2 / 2) s) s), p = ((amp amp) r^2) V, the affine bin guess
// t = (log10|k| - le0) inv_dle on the log10|k| the sigma lookup used, and
// weight 2 for valid interior modes (DC, the planes and |k| outside the
// edges get none).  The planes' draws are K1's values bit for bit.
//
// Two defects of the TPU kernel are not copied.  (1) Its affine index puts
// a mode within float32 rounding of an edge in either bin, and on a lattice
// whole shells of one |k|^2 sit there: at 1024^3 with 32 bins, 1440 modes of
// one bin (1.7e-4 of it) move against the estimator's edge search.  Here the
// affine guess is only a start: the bin is then fixed by comparing |k| with
// the float32 edges, |k| computed as the estimator computes it (float32 k
// vectors, (kx^2 + ky^2) + kz^2, ops/grid.py:kmag), so every mode lands
// where validate/stats.py bins it.  (2) It adds every tile's sums into one
// float32 (8, 128) accumulator across the whole grid, so at 1024^3 a bin's
// count (over 2^24 modes) and sums drift.  Here sums run in float64 and
// stay exact for the counts: each thread walks one (x, y) row of kz, where
// the bin changes
// rarely (32 log bins over 513 kz), keeping its run's sums in registers; a
// run is flushed when its bin changes, through a warp-wide reduction in a
// fixed lane order into the warp's shared-memory accumulator; at the end the
// block adds its warps in order and writes one partial per block, and a
// second kernel adds the partials in block order.  Every sum is taken in an
// order fixed by the shapes alone, so two calls with one seed agree bit for
// bit.
//
// What bounds it on the H100: operations, not bytes (it writes 16 bytes per
// mode of the two planes only): about 70 integer operations of the hash and
// a logf, expf and sqrtf per mode.  |k| rises along a row, so the edge fix
// is almost always one compare each way.
#include <cstdint>

#include <cuda_runtime.h>

#include "sigma_common.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 128;  // y rows per block: one x plane, 128 rows
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kReduceThreads = 128;

// Add each flushing lane's run (bin cur, sums w, p, k) to the warp's
// accumulator acc[3][nbins].  Every lane of the warp calls it together.
// Lanes that flush one bin are summed by a butterfly over the whole warp
// (zeros elsewhere): the order of every addition is fixed.
__device__ __forceinline__ void flush_runs(double* acc, int nbins, bool flush,
                                           int cur, double w, double p,
                                           double k) {
  unsigned want = __ballot_sync(kFull, flush);
  while (want) {
    const int leader = __ffs(want) - 1;
    const int b = __shfl_sync(kFull, cur, leader);
    const bool mine = flush && cur == b;
    double vw = mine ? w : 0.0, vp = mine ? p : 0.0, vk = mine ? k : 0.0;
    for (int off = 16; off > 0; off >>= 1) {
      vw += __shfl_xor_sync(kFull, vw, off);
      vp += __shfl_xor_sync(kFull, vp, off);
      vk += __shfl_xor_sync(kFull, vk, off);
    }
    if ((threadIdx.x & 31) == leader) {
      acc[b] += vw;
      acc[nbins + b] += vp;
      acc[2 * nbins + b] += vk;
    }
    __syncwarp();  // the next leader may add to the same bin
    want &= ~__ballot_sync(kFull, mine);
  }
}

// The bin of |k| = km under the estimator's edge search (the b with
// edges[b] < km <= edges[b + 1]; -1 or nbins outside), from the guess b.
__device__ __forceinline__ int edge_bin(const float* edges, int nbins,
                                        float km, int b) {
  b = min(max(b, -1), nbins);
  while (b >= 0 && !(edges[b] < km)) --b;
  while (b < nbins && edges[b + 1] < km) ++b;
  return b;
}

__global__ void __launch_bounds__(kThreads)
power_bins_kernel(double* __restrict__ partials, float* __restrict__ plane_re,
                  float* __restrict__ plane_im,
                  const float* __restrict__ knots, int n_knots,
                  const float* __restrict__ kvec,
                  const float* __restrict__ edges_in, int nx, int ny,
                  int nzh, int nyquist, uint32_t k0, uint32_t k1,
                  float kx_scale, float ky_scale, float kz_scale,
                  float half_inv_ln10, float lk0, float inv_dlk,
                  float smoothing, float volume, int nbins, float le0,
                  float inv_dle) {
  extern __shared__ double smem[];
  double* wacc = smem;                                     // [kWarps][3][nbins]
  float* edges = reinterpret_cast<float*>(smem + kWarps * 3 * nbins);
  float* kz_vec = edges + nbins + 1;
  float* tab = kz_vec + nzh;
  for (int i = threadIdx.x; i < kWarps * 3 * nbins; i += blockDim.x) {
    wacc[i] = 0.0;
  }
  for (int i = threadIdx.x; i <= nbins; i += blockDim.x) edges[i] = edges_in[i];
  for (int i = threadIdx.x; i < nzh; i += blockDim.x) {
    kz_vec[i] = kvec[nx + ny + i];
  }
  rf::load_knots(tab, knots, n_knots);

  const int x = static_cast<int>(blockIdx.y);
  const int y = static_cast<int>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = y < ny;
  const int n_planes = nyquist ? 2 : 1;
  double* acc = wacc + (threadIdx.x >> 5) * 3 * nbins;
  const float kx = kx_scale * static_cast<float>(rf::signed_index(x, nx));
  const float ky =
      ky_scale * static_cast<float>(rf::signed_index(live ? y : 0, ny));
  const unsigned long long row =
      (static_cast<unsigned long long>(x) * ny + (live ? y : 0)) * nzh;
  // the estimator's float32 k vectors: |k|^2 = (kx^2 + ky^2) + kz^2
  const float bx = kvec[x];
  const float by = kvec[nx + (live ? y : 0)];
  const float kxy2 = __fadd_rn(__fmul_rn(bx, bx), __fmul_rn(by, by));

  int cur = -1;
  double run_w = 0.0, run_p = 0.0, run_k = 0.0;
  for (int z = 0; z < nzh; ++z) {
    int bin = -1;
    float wp = 0.f, wk = 0.f;
    if (live) {
      const float kz = kz_scale * static_cast<float>(z);
      const float ksq = rf::sampler_ksq(kx, ky, kz);
      const float lk = rf::log10_k(ksq > 0.f ? ksq : 1.f, half_inv_ln10);
      const float sig =
          ksq > 0.f ? rf::interp_sigma(tab, n_knots, lk, lk0, inv_dlk) : 0.f;
      const float amp = sig * 0.70710678118654752f *
                        expf(-0.5f * ksq * smoothing * smoothing);
      const uint2 b = rf::mode_bits(k0, k1, row + z);
      const float u1 = rf::uniform_u1(b.x);
      const bool on_plane = z == 0 || (nyquist && z == nzh - 1);
      if (on_plane) {
        const float r = sqrtf(-2.f * logf(u1));
        const float theta = 6.28318530717958648f * rf::uniform_u2(b.y);
        float s, c;
        sincosf(theta, &s, &c);
        const long long at =
            (static_cast<long long>(x) * n_planes + (z == 0 ? 0 : 1)) * ny + y;
        plane_re[at] = amp * (r * c);
        plane_im[at] = amp * (r * s);
      } else {
        const float r2 = -2.f * logf(u1);
        const float pv = amp * amp * r2 * volume;
        const float bz = kz_vec[z];
        const float km = sqrtf(__fadd_rn(kxy2, __fmul_rn(bz, bz)));
        const int idx = edge_bin(edges, nbins, km,
                                 static_cast<int>(floorf((lk - le0) * inv_dle)));
        if (idx >= 0 && idx < nbins && km > 0.f) {
          bin = idx;
          wp = 2.f * pv;
          wk = 2.f * km;
        }
      }
    }
    const bool flush = bin >= 0 && cur >= 0 && bin != cur;
    flush_runs(acc, nbins, flush, cur, run_w, run_p, run_k);
    if (flush) run_w = run_p = run_k = 0.0;
    if (bin >= 0) {
      cur = bin;
      run_w += 2.0;
      run_p += static_cast<double>(wp);
      run_k += static_cast<double>(wk);
    }
  }
  flush_runs(acc, nbins, cur >= 0, cur, run_w, run_p, run_k);
  __syncthreads();

  double* out = partials +
      (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * 3 * nbins;
  for (int i = threadIdx.x; i < 3 * nbins; i += blockDim.x) {
    double sum = 0.0;
    for (int w = 0; w < kWarps; ++w) sum += wacc[w * 3 * nbins + i];
    out[i] = sum;
  }
}

// acc[i] = sum over blocks of partials[block][i], in block order.
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials_kernel(const double* __restrict__ partials,
                       double* __restrict__ acc, int n_blocks, int n_vals) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_vals) return;
  double sum = 0.0;
  for (int b = 0; b < n_blocks; ++b) {
    sum += partials[static_cast<long long>(b) * n_vals + i];
  }
  acc[i] = sum;
}

}  // namespace

// acc: float64 (3, nbins) out, rows (sum w, sum w |c|^2 V, sum w |k|) of the
// interior modes.  partials: float64 scratch of n_blocks * 3 * nbins, where
// n_blocks = nx * ceil(ny / 128) (one block per 128 y rows of an x plane).
// plane_re, plane_im: float32 (nx, 1 + nyquist, ny) out, the raw draws of the
// kz = 0 (and, for even nz, Nyquist) planes.  knots: float32 (n_knots,).
// kvec: float32 (nx + ny + nzh), the estimator's kx, ky, kz; edges: float32
// (nbins + 1), ascending.  (k0, k1): the seed's stream key; the scalars are
// float32 as K1 takes them, volume = nx ny nz spacing^3, (le0, inv_dle) the
// log10-k origin and inverse width of the bin guess.  Returns the CUDA error
// of the launches.
extern "C" int rf_sample_power_bins(void* acc, void* partials, int n_blocks,
                                    void* plane_re, void* plane_im,
                                    const void* knots, int n_knots,
                                    const void* kvec, const void* edges,
                                    int nx, int ny, int nzh, int nyquist,
                                    uint32_t k0,
                                    uint32_t k1, float kx_scale,
                                    float ky_scale, float kz_scale,
                                    float half_inv_ln10, float lk0,
                                    float inv_dlk, float smoothing,
                                    float volume, int nbins, float le0,
                                    float inv_dle, void* stream) {
  const int per_x = (ny + kThreads - 1) / kThreads;
  if (n_blocks != nx * per_x || nbins < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      sizeof(double) * kWarps * 3 * static_cast<size_t>(nbins) +
      sizeof(float) * static_cast<size_t>(nbins + 1 + nzh + n_knots);
  cudaError_t err = cudaFuncSetAttribute(
      power_bins_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(per_x), static_cast<unsigned>(nx));
  power_bins_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<double*>(partials), static_cast<float*>(plane_re),
      static_cast<float*>(plane_im), static_cast<const float*>(knots),
      n_knots, static_cast<const float*>(kvec),
      static_cast<const float*>(edges), nx, ny, nzh, nyquist, k0, k1,
      kx_scale, ky_scale, kz_scale,
      half_inv_ln10, lk0, inv_dlk, smoothing, volume, nbins, le0, inv_dle);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_vals = 3 * nbins;
  reduce_partials_kernel<<<(n_vals + kReduceThreads - 1) / kReduceThreads,
                           kReduceThreads, 0, s>>>(
      static_cast<const double*>(partials), static_cast<double*>(acc),
      n_blocks, n_vals);
  return static_cast<int>(cudaGetLastError());
}
