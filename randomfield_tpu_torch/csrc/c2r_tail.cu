// K4: c2r along the minor (kz) axis by the half-length complex pack, times
// the per-plane weights w[z]: (lines, nz/2 + 1) re/im -> (lines, nz) float32.
//
// Replaces randomfield_tpu/ops/pallas_fft.py:_make_c2r_kernel, reached through
// _irfft_tail2d (irfft_tail_pallas), the fused tail of the TPU's fastest
// render (engine/staged.py:_render_v5_single).  Same algebra: with m = nz / 2,
//
//   G[j] = E[j] + i W^j O[j],  E = c[j] + conj(c[m-j]),  O = c[j] - conj(c[m-j]),
//   W = exp(+2 pi i / nz),     z = IFFT_m(G),
//   out[2j] = Re z[j] * w[2j],  out[2j+1] = Im z[j] * w[2j+1].
//
// The TPU kernel reverses lanes with in-vreg gathers and undoes the CT digit
// order with a second gather per output block; here the reversal is an index
// into shared memory and the transform is self-sorting, so the even/odd
// interleave is one float2 store from the registers.
//
// What bounds it on the H100: device-memory bytes, one read of the spectrum
// (8 bytes per packed mode) and one write of the field (4 bytes per cell);
// the transform must stay out of their way, which barrier-closed radix-2
// stages in shared memory do not (fft_radix.cuh has the reckoning).  Design:
// the r2c head (r2c_head.cu, K6) mirrored on the register-radix core of
// fft_radix.cuh.  m / E threads share a line (32 at nz = 1024: one warp, so
// the line's syncs are warp syncs and the block never meets); a block of 256
// threads owns 256 E / m consecutive lines, 35 KB of shared memory, so
// several blocks fit an SM.  The fold needs c[m - j] beside c[j], which
// another thread loads: the line's m + 1 packed modes go coalesced into its
// shared-memory row, each thread folds its own j = t + k m/E (no division:
// the line and j come from the thread index) straight into the registers the
// first pass starts from, and the last pass leaves z[t + k m/E] in the
// registers, stored as one float2 (the pair out[2j], out[2j+1]) a thread and
// element: consecutive threads, consecutive 8 bytes, no exchange after the
// transform.  The spectrum's rows of m + 1 floats start unaligned, as K6's
// output rows do; K6's measured tries at that (streaming loads, twiddles in
// shared memory) were slower and are not repeated.
//
// K4L, the lognormal tail (EXP = true): the same kernel with a second
// per-plane array c, writing expm1(a[z] x - c[z]) where K4 writes x w[z]
// (a = b w, c = b^2 w^2 sigma_G^2 / 2: the exp map of
// randomfield_tpu/models/lognormal.py:130 _exp_map fused into the tail, so
// the field is written once).  The product and the difference are rounded
// as written; K4's instance (EXP = false) never reads c.
#include "fft_radix.cuh"

namespace {

constexpr int kThreads = 256;

template <class P>
struct Tail {
  static constexpr int kLines = kThreads / P::T;  // lines a block owns
  // m + 1 modes a row; the rows a half-warp touches at once (16 / T of
  // them when T < 16) spread over the banks
  static constexpr int kStride = rf::row_stride(P::N + 1, P::T < 16 ? P::T : 0);
  static constexpr size_t kSmem = sizeof(float2) * kLines * kStride;
};

template <class P, bool EXP>
__global__ void __launch_bounds__(kThreads, 4)
c2r_tail_kernel(const float* __restrict__ re, const float* __restrict__ im,
                const float2* __restrict__ weights,
                const float2* __restrict__ tw_fft,
                const float2* __restrict__ tw_fold, float2* __restrict__ out,
                long long lines, const float2* __restrict__ offsets) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int m = P::N, E = P::E, T = P::T;
  const int t = threadIdx.x % T;
  const int b = threadIdx.x / T;
  const long long line =
      static_cast<long long>(blockIdx.x) * Tail<P>::kLines + b;
  const bool live = line < lines;
  float2* row = reinterpret_cast<float2*>(smem_raw) + b * Tail<P>::kStride;

  const long long in0 = line * (m + 1);
  if (live) {
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int i = t + k * T;
      row[rf::pad16(i)] = make_float2(re[in0 + i], im[in0 + i]);
    }
    if (t == 0) row[rf::pad16(m)] = make_float2(re[in0 + m], im[in0 + m]);
  }
  P::sync();

  float2 v[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = t + k * T;
    const float2 c = row[rf::pad16(j)];
    const float2 r = row[rf::pad16(m - j)];
    const float er = c.x + r.x;
    const float ei = c.y - r.y;
    const float orr = c.x - r.x;
    const float oi = c.y + r.y;
    const float2 w = __ldg(tw_fold + j);  // W^j
    v[k] = make_float2(er - (w.x * oi + w.y * orr), ei + (w.x * orr - w.y * oi));
  }
  // the line's threads have all read the row before the first pass writes it
  P::sync();

  rf::fft_registers<P, +1>(v, row, t, tw_fft);  // v[k] = z[t + k T]
  if (!live) return;

  float2* dst = out + line * m;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int j = t + k * T;
    const float2 w = __ldg(weights + j);  // (w[2j], w[2j+1])
    if (EXP) {
      const float2 c = __ldg(offsets + j);
      dst[j] = make_float2(expm1f(__fsub_rn(__fmul_rn(v[k].x, w.x), c.x)),
                           expm1f(__fsub_rn(__fmul_rn(v[k].y, w.y), c.y)));
    } else {
      dst[j] = make_float2(v[k].x * w.x, v[k].y * w.y);
    }
  }
}

template <class P, bool EXP>
int launch(const void* re, const void* im, const void* weights,
           const void* tw_fft, const void* tw_fold, void* out,
           long long lines, const void* offsets, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      c2r_tail_kernel<P, EXP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tail<P>::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(
      (lines + Tail<P>::kLines - 1) / Tail<P>::kLines);
  c2r_tail_kernel<P, EXP><<<blocks, kThreads, Tail<P>::kSmem, stream>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<const float2*>(weights), static_cast<const float2*>(tw_fft),
      static_cast<const float2*>(tw_fold), static_cast<float2*>(out), lines,
      static_cast<const float2*>(offsets));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// re, im: float32 (lines, m + 1) packed spectra; weights: float32 (2m,) and
// out: float32 (lines, 2m), both 8-byte aligned.  (r0, r1, r2) is
// ops/fft.py:radix_plan(m), r2 = 1 for two passes; tw_fft its inverse
// tables (pass_twiddles(m, +1)); tw_fold: m float2 twiddles
// exp(+2 pi i j / (2m)).  offsets: null for K4 (out = x w), or K4L's
// float32 (2m,) c, 8-byte aligned (out = expm1(w x - c)).  Returns the CUDA
// error of the launch (0 on success), cudaErrorNotSupported for a plan with
// no instance.
extern "C" int rf_c2r_tail(const void* re, const void* im, const void* weights,
                           const void* offsets, const void* tw_fft,
                           const void* tw_fold, void* out, long long lines,
                           int m, int r0, int r1, int r2, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RF_CASE(N, R0, R1, R2)                                            \
  if (m == N && r0 == R0 && r1 == R1 && r2 == R2) {                       \
    using P = rf::Plan<N, R0, R1, R2>;                                    \
    return offsets == nullptr                                             \
               ? launch<P, false>(re, im, weights, tw_fft, tw_fold, out,  \
                                  lines, nullptr, st)                     \
               : launch<P, true>(re, im, weights, tw_fft, tw_fold, out,   \
                                 lines, offsets, st);                     \
  }
  RF_RADIX_PLANS(RF_CASE)
#undef RF_CASE
  return rf::kNoSuchPlan;
}

// Registers a thread, blocks an SM holds, threads a block and dynamic
// shared-memory bytes of K4's (exp = 0) or K4L's (exp != 0) instance for an
// m-point plan; returns 0, or cudaErrorNotSupported.
extern "C" int rf_c2r_tail_attributes(int exp, int m, int r0, int r1, int r2,
                                      void* registers, void* blocks_per_sm,
                                      void* threads, void* smem) {
#define RF_CASE(N, R0, R1, R2)                                            \
  if (m == N && r0 == R0 && r1 == R1 && r2 == R2) {                       \
    using P = rf::Plan<N, R0, R1, R2>;                                    \
    return exp ? rf::kernel_attributes(c2r_tail_kernel<P, true>,          \
                                       kThreads, Tail<P>::kSmem,          \
                                       registers, blocks_per_sm, threads, \
                                       smem)                              \
               : rf::kernel_attributes(c2r_tail_kernel<P, false>,         \
                                       kThreads, Tail<P>::kSmem,          \
                                       registers, blocks_per_sm, threads, \
                                       smem);                             \
  }
  RF_RADIX_PLANS(RF_CASE)
#undef RF_CASE
  return rf::kNoSuchPlan;
}
