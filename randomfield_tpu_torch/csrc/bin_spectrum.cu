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
// 1024^3).  Design: a warp takes one (x, y) line at a time and its 32 lanes
// consecutive kz, so each load is one 128-byte segment a warp, and it
// issues the loads of four such chunks (two for the multipoles) before it
// bins them, to keep enough bytes in flight; |k| never falls along a lane's
// kz, so a lane carries its bin (bins_common.cuh: one compare with the next
// edge a mode) and keeps its run in registers, flushed through the warp
// when the bin changes; lines go to warps round robin over a grid whose
// size depends on the shape alone.
#include <cstdint>

#include <cuda_runtime.h>

#include "bins_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kReduceThreads = 128;

enum Kind { kAuto = 0, kCross = 1, kInterlaced = 2, kGrid = 3 };
enum Out { kIso = 0, kPoles = 1, kWedges = 2 };

struct Params {
  const float* a0;     // re (re1), or the grid
  const float* a1;     // im (im1)
  const float* a2;     // re2
  const float* a3;     // im2
  const float* kvec;   // nx + ny + nzh: the estimator's float32 kx, ky, kz
  const float* wtab;   // nx + ny + nzh: per-axis sinc(k a / 2), if order
  const float* ptab;   // cos then sin of k a / 2 per axis, if interlaced
  const float* edges;  // nbins + 1, ascending
  double* partials;    // gridDim.x blocks of (2 + NP) nb
  int nx, ny, nz, nzh, y_off, ny_loc, nbins, nmu, los_axis, order;
  int ells[3];  // the multipoles' l (0, 2, 4), -1 for none
  float factor;
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

template <int KIND, int OUT>
__global__ void __launch_bounds__(kThreads)
bin_spectrum_kernel(const Params p) {
  constexpr int NP = OUT == kPoles ? 3 : 1;
  constexpr int NA = KIND == kAuto ? 2 : KIND == kGrid ? 1 : 4;
  // chunks of 32 kz whose loads a warp issues before it bins them: more
  // bytes in flight (auto 4.6 -> 3.7 ms at 1024^3 with 4); the multipoles'
  // three sums leave registers for 2
  constexpr int kUnroll = OUT == kPoles ? 2 : 4;
  extern __shared__ double smem[];
  const int nb = OUT == kWedges ? p.nbins * p.nmu : p.nbins;
  const int per_warp = (2 + NP) * nb;
  double* wacc = smem;
  float* edges = reinterpret_cast<float*>(smem + kWarps * per_warp);
  for (int i = threadIdx.x; i < kWarps * per_warp; i += blockDim.x) {
    wacc[i] = 0.0;
  }
  for (int i = threadIdx.x; i <= p.nbins + 1; i += blockDim.x) {
    edges[i] = i <= p.nbins ? p.edges[i] : __int_as_float(0x7F800000);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  double* acc = wacc + (threadIdx.x >> 5) * per_warp;
  const float* kz = p.kvec + p.nx + p.ny;
  const int taxis = p.nx + p.ny + p.nzh;  // the sin half of ptab
  const int z_nyq = p.nz % 2 == 0 ? p.nzh - 1 : -1;
  const long long rows = static_cast<long long>(p.nx) * p.ny_loc;
  const long long step = static_cast<long long>(gridDim.x) * kWarps;

  int cur = -1, run_n = 0;
  double run_p[NP], run_k = 0.0;
#pragma unroll
  for (int i = 0; i < NP; ++i) run_p[i] = 0.0;

  for (long long r = static_cast<long long>(blockIdx.x) * kWarps +
                     (threadIdx.x >> 5);
       r < rows; r += step) {
    const int x = static_cast<int>(r / p.ny_loc);
    const int y = p.y_off + static_cast<int>(r - static_cast<long long>(x) *
                                                     p.ny_loc);
    const float bx = p.kvec[x], by = p.kvec[p.nx + y];
    const float kxy2 = __fadd_rn(__fmul_rn(bx, bx), __fmul_rn(by, by));
    const long long base = r * p.nzh;
    float wxy = 1.f, exy_re = 1.f, exy_im = 0.f;
    if (p.order) wxy = __fmul_rn(p.wtab[x], p.wtab[p.nx + y]);
    if (KIND == kInterlaced) {
      const float cx = p.ptab[x], cy = p.ptab[p.nx + y];
      const float sx = p.ptab[taxis + x], sy = p.ptab[taxis + p.nx + y];
      exy_re = __fsub_rn(__fmul_rn(cx, cy), __fmul_rn(sx, sy));
      exy_im = __fadd_rn(__fmul_rn(cx, sy), __fmul_rn(sx, cy));
    }
    int cnt = 0;
    float next = edges[0];
    for (int z00 = 0; z00 < p.nzh; z00 += 32 * kUnroll) {
      // the loads of kUnroll chunks first, all in flight together
      float ld[kUnroll][NA];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int z = z00 + 32 * u + lane;
        if (z < p.nzh) {
          const long long i = base + z;
          ld[u][0] = p.a0[i];
          if (NA > 1) ld[u][1 % NA] = p.a1[i];
          if (NA > 2) {
            ld[u][2 % NA] = p.a2[i];
            ld[u][3 % NA] = p.a3[i];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int z = z00 + 32 * u + lane;
        const bool active = z < p.nzh;
        float km = 0.f;
        bool valid = false;
        int key = cur;
        double vals[NP] = {};
        if (active) {
          const float bz = kz[z];
          km = sqrtf(__fadd_rn(kxy2, __fmul_rn(bz, bz)));
          rf::advance_edges(edges, cnt, next, km);
          valid = km > 0.f && cnt >= 1 && cnt <= p.nbins;
          if (valid) {
            float v;
            if (KIND == kAuto) {
              const float re = ld[u][0], im = ld[u][1 % NA];
              v = __fmul_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)),
                            p.factor);
            } else if (KIND == kCross) {
              const float r1 = ld[u][0], i1 = ld[u][1 % NA];
              const float r2 = ld[u][2 % NA], i2 = ld[u][3 % NA];
              v = __fmul_rn(__fadd_rn(__fmul_rn(r1, r2), __fmul_rn(i1, i2)),
                            p.factor);
            } else if (KIND == kInterlaced) {
              const float cz = p.ptab[p.nx + p.ny + z];
              const float sz = p.ptab[taxis + p.nx + p.ny + z];
              const float e_re = __fsub_rn(__fmul_rn(exy_re, cz),
                                           __fmul_rn(exy_im, sz));
              const float e_im = __fadd_rn(__fmul_rn(exy_re, sz),
                                           __fmul_rn(exy_im, cz));
              const float r2 = ld[u][2 % NA], i2 = ld[u][3 % NA];
              const float t_re = __fsub_rn(__fmul_rn(r2, e_re),
                                           __fmul_rn(i2, e_im));
              const float t_im = __fadd_rn(__fmul_rn(r2, e_im),
                                           __fmul_rn(i2, e_re));
              const float c_re = __fmul_rn(0.5f, __fadd_rn(ld[u][0], t_re));
              const float c_im = __fmul_rn(0.5f, __fadd_rn(ld[u][1 % NA],
                                                           t_im));
              v = __fmul_rn(
                  __fadd_rn(__fmul_rn(c_re, c_re), __fmul_rn(c_im, c_im)),
                  p.factor);
            } else {
              v = ld[u][0];
            }
            if (p.order) {
              const float w = __fmul_rn(wxy, p.wtab[p.nx + p.ny + z]);
              const float w2 = __fmul_rn(w, w);
              float wp = w2;
              for (int o = 1; o < p.order; ++o) wp = __fmul_rn(wp, w2);
              v = __fdiv_rn(v, wp);
            }
            key = cnt - 1;
            if (OUT == kIso) {
              vals[0] = static_cast<double>(v);
            } else {
              const float klos = p.los_axis == 0 ? bx
                                 : p.los_axis == 1 ? by
                                                   : bz;
              if (OUT == kPoles) {
                const float t = __fdiv_rn(klos, km);
                const float mu2 = __fmul_rn(t, t);
#pragma unroll
                for (int e = 0; e < NP; ++e) {
                  vals[e] = static_cast<double>(
                      legendre_weighted(p.ells[e], mu2, v));
                }
              } else {
                const float mu = __fdiv_rn(fabsf(klos), km);
                int mi = static_cast<int>(
                    __fmul_rn(mu, static_cast<float>(p.nmu)));
                mi = min(max(mi, 0), p.nmu - 1);
                key = key * p.nmu + mi;
                vals[0] = static_cast<double>(v);
              }
            }
          }
        }
        const bool ends = valid && key != cur;
        if (__any_sync(rf::kFullWarp, ends)) {
          rf::flush_runs_n<NP>(acc, nb, ends && run_n > 0, cur, run_n, run_p,
                               run_k);
          if (ends) {
            cur = key;
            run_n = 0;
            run_k = 0.0;
#pragma unroll
            for (int e = 0; e < NP; ++e) run_p[e] = 0.0;
          }
        }
        if (valid) {
          const int w = (z == 0 || z == z_nyq) ? 1 : 2;
          const double wd = static_cast<double>(w);
          run_n += w;
#pragma unroll
          for (int e = 0; e < NP; ++e) run_p[e] += wd * vals[e];
          run_k += wd * static_cast<double>(km);
        }
      }
    }
  }
  rf::flush_runs_n<NP>(acc, nb, run_n > 0, cur, run_n, run_p, run_k);
  __syncthreads();

  double* out = p.partials + static_cast<long long>(blockIdx.x) * per_warp;
  for (int i = threadIdx.x; i < per_warp; i += blockDim.x) {
    double sum = 0.0;
    for (int w = 0; w < kWarps; ++w) sum += wacc[w * per_warp + i];
    out[i] = sum;
  }
}

// acc[i] = sum over blocks of partials[block][i], in block order.
__global__ void __launch_bounds__(kReduceThreads)
reduce_blocks_kernel(const double* __restrict__ partials,
                     double* __restrict__ acc, int n_blocks, int n_vals) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_vals) return;
  double sum = 0.0;
  for (int b = 0; b < n_blocks; ++b) {
    sum += partials[static_cast<long long>(b) * n_vals + i];
  }
  acc[i] = sum;
}

template <int KIND, int OUT>
cudaError_t launch(const Params& p, double* acc, int n_blocks,
                   cudaStream_t s) {
  constexpr int NP = OUT == kPoles ? 3 : 1;
  const int nb = OUT == kWedges ? p.nbins * p.nmu : p.nbins;
  const int n_vals = (2 + NP) * nb;
  const size_t smem = sizeof(double) * kWarps * static_cast<size_t>(n_vals) +
                      sizeof(float) * static_cast<size_t>(p.nbins + 2);
  cudaError_t err = cudaFuncSetAttribute(
      bin_spectrum_kernel<KIND, OUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bin_spectrum_kernel<KIND, OUT><<<n_blocks, kThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_blocks_kernel<<<(n_vals + kReduceThreads - 1) / kReduceThreads,
                         kReduceThreads, 0, s>>>(p.partials, acc, n_blocks,
                                                 n_vals);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_out(int out, const Params& p, double* acc, int n_blocks,
                       cudaStream_t s) {
  switch (out) {
    case kIso:
      return launch<KIND, kIso>(p, acc, n_blocks, s);
    case kPoles:
      return launch<KIND, kPoles>(p, acc, n_blocks, s);
    case kWedges:
      return launch<KIND, kWedges>(p, acc, n_blocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// acc: float64 (2 + NP) nb out, the rows (sum w, sum w p_0 .. p_{NP-1}, sum
// w |k|) over the bins, NP = 3 for multipoles and 1 otherwise, nb = nbins
// (nbins nmu for wedges).  partials: float64 scratch of n_blocks (2 + NP)
// nb.  kind: 0 auto, 1 cross, 2 interlaced, 3 grid; out: 0 iso, 1 poles, 2
// wedges.  a0..a3: float32 (nx, ny_loc, nz/2+1) lattices (re, im[, re2,
// im2]; a0 alone for grid), the ky rows [y_off, y_off + ny_loc) of the
// spectrum.  kvec: float32 (nx + ny + nz/2+1), the estimator's kx, ky, kz;
// wtab: the per-axis sinc tables of the same layout (read when order > 0);
// ptab: the per-axis cos then sin tables (read for interlaced); edges:
// float32 (nbins + 1), ascending.  ells: the multipoles' l, -1 for an unused
// slot.  Returns the CUDA error of the launches.
extern "C" int rf_bin_spectrum(int kind, int out, const void* a0,
                               const void* a1, const void* a2, const void* a3,
                               const void* kvec, const void* wtab,
                               const void* ptab, const void* edges, void* acc,
                               void* partials, int n_blocks, int nx, int ny,
                               int nz, int y_off, int ny_loc, int nbins,
                               int nmu, int los_axis, int order, int ell0,
                               int ell1, int ell2, float factor,
                               void* stream) {
  if (n_blocks < 1 || nbins < 1 || nmu < 1 || ny_loc < 1 || nx < 1 ||
      y_off < 0 || y_off + ny_loc > ny || los_axis < 0 || los_axis > 2 ||
      order < 0 || order > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.a0 = static_cast<const float*>(a0);
  p.a1 = static_cast<const float*>(a1);
  p.a2 = static_cast<const float*>(a2);
  p.a3 = static_cast<const float*>(a3);
  p.kvec = static_cast<const float*>(kvec);
  p.wtab = static_cast<const float*>(wtab);
  p.ptab = static_cast<const float*>(ptab);
  p.edges = static_cast<const float*>(edges);
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
  p.ells[0] = ell0;
  p.ells[1] = ell1;
  p.ells[2] = ell2;
  p.factor = factor;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* out_acc = static_cast<double*>(acc);
  cudaError_t err;
  switch (kind) {
    case kAuto:
      err = launch_out<kAuto>(out, p, out_acc, n_blocks, s);
      break;
    case kCross:
      err = launch_out<kCross>(out, p, out_acc, n_blocks, s);
      break;
    case kInterlaced:
      err = launch_out<kInterlaced>(out, p, out_acc, n_blocks, s);
      break;
    case kGrid:
      err = launch_out<kGrid>(out, p, out_acc, n_blocks, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
