// K10: the staged v6 render's entry stage, sampling fused into the x
// transform.  Output: two float32 lattices (nzh * ny, nx), nzh = nz / 2 + 1;
// row kz * ny + y holds the unnormalized inverse x-FFT, in natural order, of
// that x-line of the sampled half-spectrum.  No sampled line ever reaches
// device memory: the threads of a line draw it into their registers,
// transform it and write the result once.
//
// Replaces randomfield_tpu/ops/pallas_genfft.py:_make_genfft_kernel, reached
// through _genfft_jit (sample_fftx_pallas).  Per line:
//   * bulk rows (0 < kz < nz / 2; they hold no DC and no self-conjugate
//     mode): per mode two 32-bit words -> 24-bit uniforms -> Box-Muller ->
//     sigma(|k|) (sigma_common.cuh) / sqrt(2), and the Gaussian filter when
//     s != 0, in the TPU kernel's order of float32 operations: |k|^2 =
//     (kx^2 + ky^2) + kz^2, re = (sigma / sqrt(2)) (r cos theta), then re *=
//     exp(((-k^2 / 2) s) s);
//   * plane rows (kz = 0 and kz = nz / 2), whose Hermitian pairing spans the
//     whole plane: the line is LOADED from the (2 ny, nx) input that
//     ops/genfft.py:plane_spectra prepares (rows [0, ny) are kz = 0, rows
//     [ny, 2 ny) the Nyquist plane) and goes through the same transform.
// The TPU kernel seeds its hardware PRNG per row block, which nothing else
// can replay; this one draws a counter-based stream (ops/genfft.py):
// Threefry-2x32 (threefry.cuh) under the seed's key, counting the 64-bit flat
// index (kz ny + y) nx + x.  The TPU leaves the x lanes in raw digit order;
// the register-radix core of fft_radix.cuh ends in natural order.
//
// What bounds it on the H100: the instruction issue rate.  It writes 8 bytes
// per mode (4.303 GB at 1024^3) and reads only the two planes; per bulk mode
// it spends the hash (about 70 integer operations), a logf, sqrtf, sincosf
// and (smoothing) expf, plus 5 log2(nx) floating-point operations of the
// transform.  Design: the register-radix core (fft_radix.cuh), as the r2c
// head (r2c_head.cu, K6) runs it.  nx / E threads share a line (the plan is
// ops/fft.py:radix_plan(nx), E its first radix) and thread t DRAWS the
// elements x = t + k nx/E straight into the registers the first pass works
// on: a drawn mode costs the same at any x, so no bit reversal and no
// shared-memory fill exist, and a plane row's load is coalesced.  The passes
// leave X[t + k nx/E] in the registers, stored coalesced along x.  A block
// of 256 threads owns 256 E / nx consecutive lines (4 at nx = 1024, 35 KB of
// shared memory for the exchanges and the knots), and a line's threads meet
// in their warp or at the named barrier of their 128 threads, never the
// whole block.
#include <cstdint>

#include "fft_radix.cuh"
#include "sigma_common.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

template <class P>
struct Fftx {
  static constexpr int kLines = kThreads / P::T;  // lines a block owns
  // rows a half-warp touches at once (16 / T of them when T < 16) spread
  // over the banks
  static constexpr int kStride = rf::row_stride(P::N, P::T < 16 ? P::T : 0);
  static constexpr size_t kLineBytes = sizeof(float2) * kLines * kStride;
};

struct Params {
  float* re;
  float* im;
  const float* pre;
  const float* pim;
  const float* knots;
  const float2* tw;  // pass_twiddles(nx, +1)
  int n_knots, ny, nz, rows;
  uint32_t k0, k1;
  float kx_scale, ky_scale, kz_scale, half_inv_ln10, lk0, inv_dlk, smoothing;
};

template <class P>
__global__ void __launch_bounds__(kThreads, 4)
sample_fftx_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int nx = P::N, E = P::E, T = P::T;
  float* tab = reinterpret_cast<float*>(smem_raw + Fftx<P>::kLineBytes);
  rf::load_knots(tab, p.knots, p.n_knots);  // ends with a barrier

  const int t = threadIdx.x % T;
  const int b = threadIdx.x / T;
  float2* row = reinterpret_cast<float2*>(smem_raw) + b * Fftx<P>::kStride;
  const int line = static_cast<int>(blockIdx.x) * Fftx<P>::kLines + b;
  const bool live = line < p.rows;
  const int kz = live ? line / p.ny : 0;
  const int y = line - kz * p.ny;

  float2 v[E];
  if (!live) {
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = make_float2(0.f, 0.f);
  } else if (kz == 0 || kz == p.nz / 2) {
    const long long src = static_cast<long long>(kz == 0 ? y : p.ny + y) * nx;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      v[k] = make_float2(p.pre[src + t + k * T], p.pim[src + t + k * T]);
    }
  } else {
    const float ky = p.ky_scale * static_cast<float>(rf::signed_index(y, p.ny));
    const float kzf = p.kz_scale * static_cast<float>(kz);
    const float ky2 = __fmul_rn(ky, ky);
    const float kz2 = __fmul_rn(kzf, kzf);
    const unsigned long long first = static_cast<unsigned long long>(line) * nx;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int x = t + k * T;
      const float kx = p.kx_scale * static_cast<float>(rf::signed_index(x, nx));
      const float ksq = __fadd_rn(__fadd_rn(__fmul_rn(kx, kx), ky2), kz2);
      const float sig = rf::interp_sigma(
          tab, p.n_knots, rf::log10_k(ksq, p.half_inv_ln10), p.lk0, p.inv_dlk);
      const uint2 bits = rf::mode_bits(p.k0, p.k1, first + x);
      const float r = sqrtf(-2.f * logf(rf::uniform_u1(bits.x)));
      const float theta = 6.28318530717958648f * rf::uniform_u2(bits.y);
      float s, c;
      sincosf(theta, &s, &c);
      const float amp = sig * 0.70710678118654752f;
      v[k] = make_float2(amp * (r * c), amp * (r * s));
      if (p.smoothing != 0.f) {
        const float filt = expf(-0.5f * ksq * p.smoothing * p.smoothing);
        v[k].x *= filt;
        v[k].y *= filt;
      }
    }
  }

  rf::fft_registers<P, +1>(v, row, t, p.tw);  // v[k] = X[t + k T]
  if (!live) return;
  const long long out0 = static_cast<long long>(line) * nx;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    p.re[out0 + t + k * T] = v[k].x;
    p.im[out0 + t + k * T] = v[k].y;
  }
}

template <class P>
size_t smem_bytes(int n_knots) {
  return Fftx<P>::kLineBytes + sizeof(float) * static_cast<size_t>(n_knots);
}

template <class P>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<P>(p.n_knots);
  cudaError_t err = cudaFuncSetAttribute(
      sample_fftx_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(
      (p.rows + Fftx<P>::kLines - 1) / Fftx<P>::kLines);
  sample_fftx_kernel<P><<<blocks, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// re, im: float32 (nzh * ny, nx) outputs, contiguous.  pre, pim: float32
// (2 ny, nx) symmetrized plane spectra.  knots: float32 (n_knots,), n_knots
// >= 2.  (r0, r1, r2) is ops/fft.py:radix_plan(nx), r2 = 1 for two passes,
// tw its inverse tables (pass_twiddles(nx, +1)).  (k0, k1): the seed's
// stream key.  k_scale = 2 pi / (spacing * n) per axis and the table
// constants, rounded to float32 as the TPU kernel rounds them.  nz even,
// (nz / 2 + 1) ny < 2^31; the caller checks.  Returns the CUDA error of
// the launch, cudaErrorNotSupported for a plan with no instance.
extern "C" int rf_sample_fftx(void* re, void* im, const void* pre,
                              const void* pim, const void* knots, int n_knots,
                              const void* tw, int nx, int ny, int nz, int r0,
                              int r1, int r2, uint32_t k0, uint32_t k1,
                              float kx_scale, float ky_scale, float kz_scale,
                              float half_inv_ln10, float lk0, float inv_dlk,
                              float smoothing, void* stream) {
  const Params p{static_cast<float*>(re), static_cast<float*>(im),
                 static_cast<const float*>(pre), static_cast<const float*>(pim),
                 static_cast<const float*>(knots),
                 static_cast<const float2*>(tw), n_knots, ny, nz,
                 (nz / 2 + 1) * ny, k0, k1, kx_scale, ky_scale, kz_scale,
                 half_inv_ln10, lk0, inv_dlk, smoothing};
#define RF_CASE(N, R0, R1, R2)                                            \
  if (nx == N && r0 == R0 && r1 == R1 && r2 == R2) {                      \
    return launch<rf::Plan<N, R0, R1, R2>>(                               \
        p, static_cast<cudaStream_t>(stream));                            \
  }
  RF_RADIX_PLANS(RF_CASE)
#undef RF_CASE
  return rf::kNoSuchPlan;
}

// Registers a thread, blocks an SM holds, threads a block and dynamic
// shared-memory bytes of the instance for an nx-point plan with n_knots
// knots; returns 0, or cudaErrorNotSupported.
extern "C" int rf_sample_fftx_attributes(int nx, int r0, int r1, int r2,
                                         int n_knots, void* registers,
                                         void* blocks_per_sm, void* threads,
                                         void* smem) {
#define RF_CASE(N, R0, R1, R2)                                            \
  if (nx == N && r0 == R0 && r1 == R1 && r2 == R2) {                      \
    using P = rf::Plan<N, R0, R1, R2>;                                    \
    return rf::kernel_attributes(sample_fftx_kernel<P>, kThreads,         \
                                 smem_bytes<P>(n_knots), registers,       \
                                 blocks_per_sm, threads, smem);           \
  }
  RF_RADIX_PLANS(RF_CASE)
#undef RF_CASE
  return rf::kNoSuchPlan;
}
