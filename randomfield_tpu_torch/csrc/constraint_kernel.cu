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
// the Hermitian multiplicity, each mode's term in float64, summed per block
// in a fixed order (a warp's shuffles, then the block's warps) into
// float64 per-block partials that the caller adds in a fixed order.  With
// ``scale`` it first multiplies the unit draws in place by the per-mode
// sigma grid and the filter exp(-k^2 s^2 / 2), (c sigma) f, the reference's
// sample_spectrum then filter_modes.  Any M: the launch takes constraints
// [c0, c0 + mc), mc <= kMaxBlock, and the caller loops.
//
// CORRECT (rf_constraint_correct): c += se2 sum_i alpha_i conj(K_i) in
// place, se2 = (sigma f)^2, the sum over i in order in float32, every
// product and sum rounded as written (__fmul_rn, __fadd_rn), the order of
// ops/constraint.py:correct_plain, which the kernel equals bit for bit.
//
// What bounds it on the H100: device-memory bytes, the lattices and the
// sigma grid read and the lattices written (20 bytes a mode); the
// operations are about 16 M a mode.  Layout (spectral_kernel.cu's): a block
// is an x row (blockIdx.y) and eight ky rows (a warp each), the lanes walk
// kz 32 at a time, so e_x is one value a block, e_y one a warp.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlock = 8;  // constraints a measure launch sums

struct Args {
  float* re;
  float* im;
  const float* sig;      // (nx, ny, nzh) sigma grid, or null
  const float* kvec;     // nx + ny + nzh float32 k vectors (the filter)
  const float2* tab;     // (M, nx + ny + nzh) e tables
  const float* alpha;    // (M,) float32 (CORRECT)
  double* partials;      // (blocks, mc) float64 (MEASURE)
  int nx, ny, nz, nzh, m, c0, mc;
  float smoothing;
};

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

template <bool SCALE>
__global__ void __launch_bounds__(kThreads)
measure_kernel(const Args p) {
  __shared__ double red[kWarps][kMaxBlock];
  const int x = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int y = blockIdx.x * kWarps + warp;
  const int len = p.nx + p.ny + p.nzh;
  double acc[kMaxBlock];
#pragma unroll
  for (int j = 0; j < kMaxBlock; ++j) acc[j] = 0.0;
  if (y < p.ny) {
    const bool sxy = own_partner(x, p.nx) && own_partner(y, p.ny);
    const long long row = (static_cast<long long>(x) * p.ny + y) * p.nzh;
    float2 exy[kMaxBlock];
#pragma unroll
    for (int j = 0; j < kMaxBlock; ++j) {
      if (j < p.mc) {
        const float2* t = p.tab + static_cast<long long>(p.c0 + j) * len;
        exy[j] = cmul(__ldg(t + x), __ldg(t + p.nx + y));
      }
    }
    const float kx = p.kvec[x], ky = p.kvec[p.nx + y];
    for (int z = lane; z < p.nzh; z += 32) {
      float cr = p.re[row + z];
      float ci = p.im[row + z];
      if (SCALE) {
        const float s = p.sig[row + z];
        const float f = filter(p, kx, ky, p.kvec[p.nx + p.ny + z]);
        cr = __fmul_rn(__fmul_rn(cr, s), f);
        ci = __fmul_rn(__fmul_rn(ci, s), f);
        p.re[row + z] = cr;
        p.im[row + z] = ci;
      }
      const bool sz = z == 0 || (p.nz % 2 == 0 && z == p.nzh - 1);
      const bool self_conj = sxy && sz;
      const double mult = sz ? 1.0 : 2.0;
#pragma unroll
      for (int j = 0; j < kMaxBlock; ++j) {
        if (j < p.mc) {
          const float2 ez = __ldg(p.tab + static_cast<long long>(p.c0 + j) *
                                              len + p.nx + p.ny + z);
          const float2 k = cmul(exy[j], ez);
          const double ki = self_conj ? 0.0 : static_cast<double>(k.y);
          acc[j] += mult * (static_cast<double>(cr) * k.x -
                            static_cast<double>(ci) * ki);
        }
      }
    }
  }
  // the block's sums: each warp by shuffles, then the warps in order
#pragma unroll
  for (int j = 0; j < kMaxBlock; ++j) {
    double v = acc[j];
    for (int off = 16; off > 0; off /= 2) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) red[warp][j] = v;
  }
  __syncthreads();
  if (threadIdx.x < p.mc) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    const long long b = static_cast<long long>(blockIdx.y) * gridDim.x +
                        blockIdx.x;
    p.partials[b * p.mc + threadIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads) correct_kernel(const Args p) {
  const int x = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int y = blockIdx.x * kWarps + warp;
  if (y >= p.ny) return;
  const int len = p.nx + p.ny + p.nzh;
  const bool sxy = own_partner(x, p.nx) && own_partner(y, p.ny);
  const long long row = (static_cast<long long>(x) * p.ny + y) * p.nzh;
  const float kx = p.kvec[x], ky = p.kvec[p.nx + y];
  for (int z = lane; z < p.nzh; z += 32) {
    const bool self_conj = sxy && (z == 0 || (p.nz % 2 == 0 &&
                                              z == p.nzh - 1));
    float ar = 0.f, ai = 0.f;
    for (int i = 0; i < p.m; ++i) {
      const float2* t = p.tab + static_cast<long long>(i) * len;
      const float2 k = cmul(cmul(__ldg(t + x), __ldg(t + p.nx + y)),
                            __ldg(t + p.nx + p.ny + z));
      const float a = __ldg(p.alpha + i);
      ar = __fadd_rn(ar, __fmul_rn(a, k.x));
      ai = __fadd_rn(ai, __fmul_rn(a, self_conj ? 0.f : k.y));
    }
    const float se = p.sig ? __fmul_rn(p.sig[row + z],
                                       filter(p, kx, ky,
                                              p.kvec[p.nx + p.ny + z]))
                           : 0.f;
    const float se2 = __fmul_rn(se, se);
    p.re[row + z] = __fadd_rn(p.re[row + z], __fmul_rn(se2, ar));
    p.im[row + z] = __fsub_rn(p.im[row + z], __fmul_rn(se2, ai));
  }
}

Args make_args(void* re, void* im, const void* sig, const void* kvec,
               const void* tab, const void* alpha, void* partials, int nx,
               int ny, int nz, int m, int c0, int mc, float smoothing) {
  return Args{static_cast<float*>(re),
              static_cast<float*>(im),
              static_cast<const float*>(sig),
              static_cast<const float*>(kvec),
              static_cast<const float2*>(tab),
              static_cast<const float*>(alpha),
              static_cast<double*>(partials),
              nx, ny, nz, nz / 2 + 1, m, c0, mc, smoothing};
}

}  // namespace

// re, im: float32 (nx, ny, nz/2 + 1) contiguous; sig: the same shape, read
// when scale != 0 (then re and im are scaled in place first); kvec: float32
// nx + ny + nz/2 + 1 k vectors; tab: float32 pairs (m, nx + ny + nz/2 + 1);
// partials: float64 (ceil(ny / 8) nx, mc) for constraints [c0, c0 + mc),
// mc <= 8.  nx up to 65535.  Returns the CUDA error of the launch.
extern "C" int rf_constraint_measure(void* re, void* im, const void* sig,
                                     const void* kvec, const void* tab,
                                     void* partials, int nx, int ny, int nz,
                                     int m, int c0, int mc, float smoothing,
                                     int scale, void* stream) {
  if (nx < 1 || nx > 65535 || ny < 1 || nz < 1 || mc < 1 ||
      mc > kMaxBlock || c0 < 0 || c0 + mc > m || (scale && !sig)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args args = make_args(re, im, sig, kvec, tab, nullptr, partials, nx,
                              ny, nz, m, c0, mc, smoothing);
  const dim3 grid((ny + kWarps - 1) / kWarps, nx);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scale) {
    measure_kernel<true><<<grid, kThreads, 0, st>>>(args);
  } else {
    measure_kernel<false><<<grid, kThreads, 0, st>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

// c += (sigma f)^2 sum_i alpha_i conj(K_i) in place over the whole grid;
// alpha: float32 (m,) on the device; sig as above (required).
extern "C" int rf_constraint_correct(void* re, void* im, const void* sig,
                                     const void* kvec, const void* tab,
                                     const void* alpha, int nx, int ny,
                                     int nz, int m, float smoothing,
                                     void* stream) {
  if (nx < 1 || nx > 65535 || ny < 1 || nz < 1 || m < 1 || !sig) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args args = make_args(re, im, sig, kvec, tab, alpha, nullptr, nx, ny,
                              nz, m, 0, m, smoothing);
  const dim3 grid((ny + kWarps - 1) / kWarps, nx);
  correct_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      args);
  return static_cast<int>(cudaGetLastError());
}
