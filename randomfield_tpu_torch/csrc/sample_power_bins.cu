// K5: the binned power of the sampler='pallas' spectrum, with no spectrum in
// device memory, for a batch of seeds.  It regenerates K1's draws (the same
// counter-based stream, threefry.cuh, and the same amplitude,
// sigma_common.cuh) and adds, per mode, (w, w |c|^2 V, w |k|) to the bin of
// the estimator's edge search on |k|: w = 2 (the Hermitian multiplicity) in
// the interior, w = 1 on the kz = 0 and, for even nz, Nyquist planes, where
// the Hermitian fix runs in the thread as in K1 (hermitian.cuh): a mode that
// is not canonical takes its partner's draw (the partner's |c|^2 at its own
// |k|), a self-conjugate mode has |c|^2 = (re sqrt(2))^2, rounded as
// validate/stats.py:plane_bins rounds it.  One block column per seed (grid
// z), each writing its seed's row of one (n_seeds, 3, nbins) block.
//
// Replaces randomfield_tpu/ops/pallas_sampler.py:_make_kernel with bins=,
// via sample_power_bins_reim (caller engine/staged.py:_sample_power_v3),
// together with the plane path after it (the planes made Hermitian and
// binned with multiplicity 1).  Per interior mode, as the TPU kernel: r^2 =
// -2 ln u1 (no trig), amp = sigma / sqrt(2) exp(((-k^2 / 2) s) s) (the
// filter only when s != 0: exp(-0) = 1, so skipping it moves nothing), p =
// ((amp amp) r^2) V.  The plane modes' draws are K1's values bit for bit.
//
// Two defects of the TPU kernel are not copied.  (1) Its affine bin index
// puts a mode within float32 rounding of an edge in either bin, and on a
// lattice whole shells of one |k|^2 sit there: at 1024^3 with 32 bins, 1440
// modes of one bin (1.7e-4 of it) move against the estimator's edge search.
// Here the bin is the edge search itself, on |k| computed as the estimator
// computes it (float32 k vectors, (kx^2 + ky^2) + kz^2, ops/grid.py:kmag),
// so every mode lands where validate/stats.py bins it.  (2) It adds every
// tile's sums into one float32 (8, 128) accumulator across the whole grid,
// so at 1024^3 a bin's count (over 2^24 modes) and sums drift.  Here counts
// are integers and sums float64, added in an order fixed by the shapes
// alone (per run, then warp, then block, then the block partials in block
// order by a second kernel), so the counts are exact and two calls with
// one seed agree bit for bit.
//
// What bounds it on the H100: the instruction issue rate; it writes only
// its partial sums.  Per mode it issues the hash (about 75 integer
// instructions), a logf and the power, and, shared as below, the amplitude
// (a logf, the lookup) and |k| (a sqrtf) and its bin.  Design, to issue
// fewer instructions a mode:
// - a thread walks kz along the x rows x and (-x) mod nx of one ky row: the
//   two share |k|^2, the amplitude, the estimator's |k| and so the bin, and
//   their hashes are independent;
// - |k| does not decrease along kz ((kx^2 + ky^2) + kz^2 with kz ascending,
//   every float32 step monotone), so the bin is carried from kz to kz + 1:
//   one search a row, then one compare with the next edge a mode;
// - a thread keeps its run (the modes since its bin last changed) in
//   registers, the count as an integer and |c|^2 and |k| in float64, and
//   flushes it when the bin changes, through a butterfly over the warp, so
//   the per-mode cost of the sums is a float64 add a mode and one for |k|;
// - the planes are binned where they are drawn, so nothing leaves the
//   kernel but the sums.
// The edge walk and the warp flush are bins_common.cuh's, shared with KB
// (bin_spectrum.cu), which bins spectra that lie in device memory.
#include <cstdint>

#include <cuda_runtime.h>

#include "bins_common.cuh"
#include "hermitian.cuh"
#include "sigma_common.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 128;  // ky rows per block: one x-row pair, 128 rows
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = rf::kFullWarp;
constexpr int kReduceThreads = 128;

__global__ void __launch_bounds__(kThreads)
power_bins_kernel(double* __restrict__ partials,
                  const uint32_t* __restrict__ keys,
                  const float* __restrict__ knots, int n_knots,
                  const float* __restrict__ kvec,
                  const float* __restrict__ edges_in, int nx, int ny, int nz,
                  float kx_scale, float ky_scale, float kz_scale,
                  float half_inv_ln10, float lk0, float inv_dlk,
                  float smoothing, float volume, int nbins) {
  extern __shared__ double smem[];
  const int nzh = nz / 2 + 1;
  double* wacc = smem;                                     // [kWarps][3][nbins]
  float* edges = reinterpret_cast<float*>(smem + kWarps * 3 * nbins);
  float* kz2 = edges + nbins + 2;  // the sampler's kz^2
  float* bz2 = kz2 + nzh;          // the estimator's kz^2
  float* tab = bz2 + nzh;
  for (int i = threadIdx.x; i < kWarps * 3 * nbins; i += blockDim.x) {
    wacc[i] = 0.0;
  }
  for (int i = threadIdx.x; i <= nbins + 1; i += blockDim.x) {
    edges[i] = i <= nbins ? edges_in[i] : __int_as_float(0x7F800000);  // +inf
  }
  for (int z = threadIdx.x; z < nzh; z += blockDim.x) {
    const float kz = kz_scale * static_cast<float>(z);
    kz2[z] = __fmul_rn(kz, kz);
    const float bz = kvec[nx + ny + z];
    bz2[z] = __fmul_rn(bz, bz);
  }
  rf::load_knots(tab, knots, n_knots);  // and the block's barrier

  const uint32_t k0 = keys[2 * blockIdx.z], k1 = keys[2 * blockIdx.z + 1];
  const int xp = static_cast<int>(blockIdx.y);
  const int x[2] = {xp, rf::partner_index(xp, nx)};
  const bool two = x[1] != x[0];  // block-uniform
  const int mult = two ? 2 : 1;
  const int y = static_cast<int>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = y < ny;
  const int yy = live ? y : 0;
  const int py = rf::partner_index(yy, ny);
  double* acc = wacc + (threadIdx.x >> 5) * 3 * nbins;
  const float kx = kx_scale * static_cast<float>(rf::signed_index(xp, nx));
  const float ky = ky_scale * static_cast<float>(rf::signed_index(yy, ny));
  const float kx2 = __fmul_rn(kx, kx), ky2 = __fmul_rn(ky, ky);
  // the estimator's float32 k vectors: |k|^2 = (kx^2 + ky^2) + kz^2, the
  // same for both rows (kvec[(-x) mod nx] = -kvec[x])
  const float bx = kvec[xp];
  const float by = kvec[nx + yy];
  const float kxy2 = __fadd_rn(__fmul_rn(bx, bx), __fmul_rn(by, by));
  unsigned long long base[2], pbase[2];
  bool nc[2], sc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int px = x[1 - r];
    base[r] = (static_cast<unsigned long long>(x[r]) * ny + yy) * nzh;
    pbase[r] = (static_cast<unsigned long long>(px) * ny + py) * nzh;
    nc[r] = rf::not_canonical(x[r], yy, px, py);
    sc[r] = rf::self_conjugate(x[r], yy, px, py);
  }

  auto amplitude = [&](int z) {
    const float ksq = __fadd_rn(__fadd_rn(kx2, kz2[z]), ky2);
    float sig = 0.f;
    if (ksq > 0.f) {
      sig = rf::interp_sigma(tab, n_knots, rf::log10_k(ksq, half_inv_ln10),
                             lk0, inv_dlk);
    }
    float amp = sig * 0.70710678118654752f;
    if (smoothing != 0.f) {
      amp = amp * expf(-0.5f * ksq * smoothing * smoothing);
    }
    return amp;
  };
  // cnt: the edges below |k| (the bin is cnt - 1); |k| never falls along kz
  int cnt = 0;
  float next = edges[0];
  auto advance = [&](float km) { rf::advance_edges(edges, cnt, next, km); };
  auto in_range = [&](int c) { return live && c >= 1 && c <= nbins; };

  // a self-conjugate plane: both rows' modes drawn and fixed as K1 draws
  // them, |c|^2 V as plane_bins rounds it, weight 1 each
  auto plane = [&](int z) {
    const float amp = amplitude(z);
    const float km = sqrtf(__fadd_rn(kxy2, bz2[z]));
    advance(km);
    double psum = 0.0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r == 1 && !two) break;
      const uint2 b = rf::mode_bits(k0, k1, (nc[r] ? pbase[r] : base[r]) + z);
      const float rr = sqrtf(-2.f * logf(rf::uniform_u1(b.x)));
      const float theta = 6.28318530717958648f * rf::uniform_u2(b.y);
      float s, c;
      sincosf(theta, &s, &c);
      float vre = amp * (rr * c);
      float vim = amp * (rr * s);
      if (sc[r]) {
        vre = __fmul_rn(vre, rf::kSqrt2);
        vim = 0.f;
      }
      psum += static_cast<double>(__fmul_rn(
          __fadd_rn(__fmul_rn(vre, vre), __fmul_rn(vim, vim)), volume));
    }
    rf::flush_runs(acc, nbins, in_range(cnt) && km > 0.f, cnt - 1, mult, psum,
               mult * static_cast<double>(km));
  };

  plane(0);
  const int interior_end = nz % 2 == 0 ? nzh - 1 : nzh;
  int cur = cnt, run_n = 0;
  double run_p = 0.0, run_k = 0.0;
  for (int z = 1; z < interior_end; ++z) {
    const float amp = amplitude(z);
    const float km = sqrtf(__fadd_rn(kxy2, bz2[z]));
    advance(km);
    const bool ends = cnt != cur;
    if (__any_sync(kFull, ends)) {
      rf::flush_runs(acc, nbins, ends && in_range(cur) && run_n > 0, cur - 1,
                 2 * mult * run_n, 2.0 * run_p, 2.0 * mult * run_k);
      if (ends) {
        cur = cnt;
        run_n = 0;
        run_p = run_k = 0.0;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r == 1 && !two) break;
      const uint2 b = rf::mode_bits(k0, k1, base[r] + z);
      const float r2 = -2.f * logf(rf::uniform_u1(b.x));
      run_p += static_cast<double>(amp * amp * r2 * volume);
    }
    ++run_n;
    run_k += static_cast<double>(km);
  }
  rf::flush_runs(acc, nbins, in_range(cur) && run_n > 0, cur - 1,
             2 * mult * run_n, 2.0 * run_p, 2.0 * mult * run_k);
  if (nz % 2 == 0) plane(nzh - 1);
  __syncthreads();

  double* out =
      partials +
      ((static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) *
           gridDim.x + blockIdx.x) * 3 * nbins;
  for (int i = threadIdx.x; i < 3 * nbins; i += blockDim.x) {
    double sum = 0.0;
    for (int w = 0; w < kWarps; ++w) sum += wacc[w * 3 * nbins + i];
    out[i] = sum;
  }
}

// acc[s][i] = sum over blocks of partials[s][block][i], in block order;
// grid y = seed.
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials_kernel(const double* __restrict__ partials,
                       double* __restrict__ acc, int n_blocks, int n_vals) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_vals) return;
  const double* in =
      partials + static_cast<long long>(blockIdx.y) * n_blocks * n_vals;
  double sum = 0.0;
  for (int b = 0; b < n_blocks; ++b) {
    sum += in[static_cast<long long>(b) * n_vals + i];
  }
  acc[static_cast<long long>(blockIdx.y) * n_vals + i] = sum;
}

}  // namespace

// acc: float64 (n_seeds, 3, nbins) out, per seed the rows (sum w, sum w
// |c|^2 V, sum w |k|) over every mode of the half-spectrum.  partials:
// float64 scratch of n_seeds * n_blocks * 3 * nbins, where n_blocks =
// (nx / 2 + 1) * ceil(ny / 128) (one block per 128 ky rows of an x-row
// pair).  keys: uint32 (n_seeds, 2) stream keys on the device.  knots:
// float32 (n_knots,).  kvec: float32 (nx + ny + nz / 2 + 1), the
// estimator's kx, ky, kz; edges: float32 (nbins + 1), ascending.  The
// scalars are float32 as K1 takes them, volume = nx ny nz spacing^3.
// Returns the CUDA error of the launches.
extern "C" int rf_sample_power_bins(void* acc, void* partials, int n_blocks,
                                    const void* keys, int n_seeds,
                                    const void* knots, int n_knots,
                                    const void* kvec, const void* edges,
                                    int nx, int ny, int nz, float kx_scale,
                                    float ky_scale, float kz_scale,
                                    float half_inv_ln10, float lk0,
                                    float inv_dlk, float smoothing,
                                    float volume, int nbins, void* stream) {
  const int per_x = (ny + kThreads - 1) / kThreads;
  if (n_blocks != (nx / 2 + 1) * per_x || nbins < 1 || n_seeds < 1 ||
      n_seeds > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nzh = nz / 2 + 1;
  const size_t smem =
      sizeof(double) * kWarps * 3 * static_cast<size_t>(nbins) +
      sizeof(float) * static_cast<size_t>(nbins + 2 + 2 * nzh + n_knots);
  cudaError_t err = cudaFuncSetAttribute(
      power_bins_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(per_x),
                  static_cast<unsigned>(nx / 2 + 1),
                  static_cast<unsigned>(n_seeds));
  power_bins_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<double*>(partials), static_cast<const uint32_t*>(keys),
      static_cast<const float*>(knots), n_knots,
      static_cast<const float*>(kvec), static_cast<const float*>(edges), nx,
      ny, nz, kx_scale, ky_scale, kz_scale, half_inv_ln10, lk0, inv_dlk,
      smoothing, volume, nbins);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_vals = 3 * nbins;
  const dim3 rgrid((n_vals + kReduceThreads - 1) / kReduceThreads,
                   static_cast<unsigned>(n_seeds));
  reduce_partials_kernel<<<rgrid, kReduceThreads, 0, s>>>(
      static_cast<const double*>(partials), static_cast<double*>(acc),
      n_blocks, n_vals);
  return static_cast<int>(cudaGetLastError());
}
