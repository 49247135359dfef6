// K6: r2c along the minor (z) axis by the half-length complex pack:
// (lines, nz) float32 -> (lines, nz/2 + 1) re/im, unnormalized forward.
//
// Replaces randomfield_tpu/ops/pallas_fft.py:rfft_minor_half_reim, the head
// of the distributed forward transform (parallel/dfft.py:_slab_pallas_
// forward_local), the mirror of the c2r tail (c2r_tail.cu, K4).  Same
// algebra: with m = nz / 2,
//
//   z[j] = x[2j] + i x[2j+1],  Z = FFT_m(z),  R[k] = conj(Z[(m - k) mod m]),
//   A[k] = (Z[k] + R[k]) / 2,  B[k] = -i (Z[k] - R[k]) / 2,
//   X[k] = A[k] + W^-k B[k],   W = exp(+2 pi i / nz),  k < m,
//   X[m] = Re Z[0] - Im Z[0].
//
// The TPU kernel pairs the lanes with a reshape and reverses Z with a
// concatenate in XLA around a forward CT pass (the inverse kernel between
// two conjugations); here the pair is one float2 load, the reversal an
// index into shared memory, and the m-point transform runs forward on
// forward tables, so the field is read once and the spectrum written once.
//
// What bounds it on the H100: device-memory bytes, one read of the field
// (4 bytes per cell) and one write of the spectrum (8 bytes per packed
// mode); the transform must stay out of their way, which barrier-closed
// radix-2 stages in shared memory do not (fft_radix.cuh has the reckoning).
// Design: the register-radix core of fft_radix.cuh.  m / E threads
// share a line (32 at nz = 1024: one warp, so the line's syncs are warp
// syncs and the block never meets), thread t loads the pairs t + k m/E as
// coalesced float2 straight into the registers the first pass works on, and
// a block of 256 threads owns 256 E / m consecutive lines, 35 KB of shared
// memory, so several blocks fit an SM.  The unfold needs Z[k] beside
// Z[m - k], which another thread holds: the last pass's result goes through
// the line's shared-memory row once more, each thread unfolds its own k = t +
// k' m/E (no division: the line and k come from the thread index) and
// stores 32 consecutive floats a warp; thread 0 of the line adds X[m].
#include "fft_radix.cuh"

namespace {

constexpr int kThreads = 256;

template <class P>
struct Head {
  static constexpr int kLines = kThreads / P::T;  // lines a block owns
  // rows a half-warp touches at once (16 / T of them when T < 16) spread
  // over the banks
  static constexpr int kStride = rf::row_stride(P::N, P::T < 16 ? P::T : 0);
  static constexpr size_t kSmem = sizeof(float2) * kLines * kStride;
};

template <class P>
__global__ void __launch_bounds__(kThreads, 4)
r2c_head_kernel(const float* __restrict__ x, const float2* __restrict__ tw_fft,
                const float2* __restrict__ tw_unfold, float* __restrict__ re,
                float* __restrict__ im, long long lines) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int m = P::N, E = P::E, T = P::T;
  const int t = threadIdx.x % T;
  const int b = threadIdx.x / T;
  const long long line =
      static_cast<long long>(blockIdx.x) * Head<P>::kLines + b;
  const bool live = line < lines;
  float2* row = reinterpret_cast<float2*>(smem_raw) + b * Head<P>::kStride;

  // the pair (x[2j], x[2j+1]) is one aligned float2: nz is even
  float2 v[E];
  const float2* src = reinterpret_cast<const float2*>(x) + line * m;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    v[k] = live ? src[t + k * T] : make_float2(0.f, 0.f);
  }

  rf::fft_registers<P, -1>(v, row, t, tw_fft);  // v[k] = Z[t + k T]

  P::sync();
#pragma unroll
  for (int k = 0; k < E; ++k) row[rf::pad16(t + k * T)] = v[k];
  P::sync();
  if (!live) return;

  const long long out0 = line * (m + 1);
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int kk = t + k * T;
    const float2 zk = v[k];
    const float2 zr = row[rf::pad16((m - kk) & (m - 1))];
    const float a_re = 0.5f * (zk.x + zr.x);
    const float a_im = 0.5f * (zk.y - zr.y);
    const float b_re = 0.5f * (zk.y + zr.y);
    const float b_im = -0.5f * (zk.x - zr.x);
    const float2 w = rf::conj_if(__ldg(tw_unfold + kk), true);  // W^-k
    re[out0 + kk] = a_re + (w.x * b_re - w.y * b_im);
    im[out0 + kk] = a_im + (w.x * b_im + w.y * b_re);
  }
  if (t == 0) {
    re[out0 + m] = v[0].x - v[0].y;
    im[out0 + m] = 0.f;
  }
}

template <class P>
int launch(const void* x, const void* tw_fft, const void* tw_unfold, void* re,
           void* im, long long lines, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      r2c_head_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Head<P>::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(
      (lines + Head<P>::kLines - 1) / Head<P>::kLines);
  r2c_head_kernel<P><<<blocks, kThreads, Head<P>::kSmem, stream>>>(
      static_cast<const float*>(x), static_cast<const float2*>(tw_fft),
      static_cast<const float2*>(tw_unfold), static_cast<float*>(re),
      static_cast<float*>(im), lines);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: float32 (lines, 2m), contiguous; re, im: float32 (lines, m + 1).
// (r0, r1, r2) is ops/fft.py:radix_plan(m), r2 = 1 for two passes; tw_fft
// its forward tables (pass_twiddles(m, -1)); tw_unfold: m float2 twiddles
// exp(+2 pi i j / (2m)) (conjugated here).  Returns the CUDA error of the
// launch (0 on success), cudaErrorNotSupported for a plan with no instance.
extern "C" int rf_r2c_head(const void* x, const void* tw_fft,
                           const void* tw_unfold, void* re, void* im,
                           long long lines, int m, int r0, int r1, int r2,
                           void* stream) {
#define RF_CASE(N, R0, R1, R2)                                            \
  if (m == N && r0 == R0 && r1 == R1 && r2 == R2) {                       \
    return launch<rf::Plan<N, R0, R1, R2>>(                               \
        x, tw_fft, tw_unfold, re, im, lines,                              \
        static_cast<cudaStream_t>(stream));                               \
  }
  RF_RADIX_PLANS(RF_CASE)
#undef RF_CASE
  return rf::kNoSuchPlan;
}

// Registers a thread, blocks an SM holds, threads a block and dynamic
// shared-memory bytes of the instance for an m-point plan; returns 0, or
// cudaErrorNotSupported.
extern "C" int rf_r2c_head_attributes(int m, int r0, int r1, int r2,
                                      void* registers, void* blocks_per_sm,
                                      void* threads, void* smem) {
#define RF_CASE(N, R0, R1, R2)                                            \
  if (m == N && r0 == R0 && r1 == R1 && r2 == R2) {                       \
    using P = rf::Plan<N, R0, R1, R2>;                                    \
    return rf::kernel_attributes(r2c_head_kernel<P>, kThreads,            \
                                 Head<P>::kSmem, registers,               \
                                 blocks_per_sm, threads, smem);           \
  }
  RF_RADIX_PLANS(RF_CASE)
#undef RF_CASE
  return rf::kNoSuchPlan;
}
