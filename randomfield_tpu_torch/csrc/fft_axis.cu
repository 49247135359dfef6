// K3: unnormalized complex FFT, inverse (SIGN = +1) or forward (SIGN = -1),
// along the middle axis of a float32 re/im pair viewed as (outer, n, inner),
// in place, natural order out.
//
// Replaces randomfield_tpu/ops/pallas_fft.py:_make_kernel + _ct_core, reached
// through _ifft2d (ifft_minor_pallas_reim).  The TPU's forward transform
// (fft_minor_pallas_reim) conjugates around the inverse kernel; here the
// sign is a template parameter (its own tables, pass_twiddles(n, -1), and
// compile-time roots), so the forward pass of the distributed forward
// transform costs what the inverse costs.  The TPU kernel transforms the
// MINOR axis only, so the TPU pipeline pays a physical transpose before
// each of its x and y passes.  Here the transform axis is the middle one of
// any (outer, n, inner) view: the x pass of an (nx, ny, nzh) spectrum is the
// view (1, nx, ny * nzh) and the y pass is (nx, ny, nzh), with no transpose.
//
// What bounds it on the H100: device-memory bytes, one read and one write of
// each lattice (16 bytes per complex mode), in segments of PANEL floats a
// row; the transform must stay out of their way, which barrier-closed
// radix-2 stages in shared memory do not (fft_radix.cuh has the reckoning).
// Design: the register-radix core of fft_radix.cuh, with K9's load and
// first pass (fft_rotate.cu).  A block owns PANEL consecutive inner columns
// by all n rows of one outer group, with PANEL * n / E threads standing
// along the columns (consecutive threads, consecutive columns: PANEL
// contiguous floats a row, E rows a thread, all loads in flight together).
// The thread that reads rows t + k n/E of column c holds what the core's
// first pass wants at place t of line c; it runs that pass and writes the
// first exchange into the line's shared-memory row.  The threads keep that
// place for every later pass, so the last pass leaves X[t + k n/E] of
// column c in the registers: the store is the load's own segments, with no
// shared-memory trip after the transform.  The price is that a line's
// threads are strided by PANEL across the block, so they meet at block
// barriers (three at 1024 points) where K9's meet in a warp or a named
// barrier.  Measured on an H100 at a 1024^3 pass, this design took 3.48
// (x) and 3.71 ms (y) against 3.85 and 4.05 for K9's later passes plus an
// exchange back to the column-standing threads (PERF.md, section 6); 8 columns a
// block (two blocks an SM) took 5.45 and 4.68 ms.  The row stride is 2
// (PANEL = 8) or 1 (PANEL >= 16) modulo 16, so the PANEL lines a half-warp
// touches at once fall into distinct banks.  The columns ride grid.x and
// the outer groups grid.y; indices are 64-bit.  A render's y pass (inner =
// 513) ends each group with a panel of one live column; taking a block's
// columns across the group boundary measured no faster.
#include "fft_radix.cuh"

namespace {

template <class P, int PANEL>
struct Axis {
  static constexpr int kThreads = PANEL * P::T;
  static_assert(kThreads <= 1024, "a block has at most 1024 threads");
  static constexpr int kStride = rf::row_stride(P::N, PANEL >= 16 ? 1 : 16 / PANEL);
  static constexpr size_t kSmem = sizeof(float2) * PANEL * kStride;
  // 64 registers a thread: 1024 threads an SM whatever the block size
  static constexpr int kMinBlocks = 1024 / kThreads;
};

template <class P, int PANEL, int SIGN>
__global__ void __launch_bounds__(Axis<P, PANEL>::kThreads,
                                  Axis<P, PANEL>::kMinBlocks)
fft_axis_kernel(float* __restrict__ re, float* __restrict__ im,
                const float2* __restrict__ tw, long long inner) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int n = P::N, E = P::E, T = P::T;
  constexpr int stride = Axis<P, PANEL>::kStride;
  float2* buf = reinterpret_cast<float2*>(smem_raw);
  // along the columns: thread (place t, column c) reads rows t + k T of
  // column c, which are the elements the first pass wants at place t of
  // line c
  const int c = threadIdx.x % PANEL;
  const int t = threadIdx.x / PANEL;
  const long long col = static_cast<long long>(blockIdx.x) * PANEL + c;
  const bool live = col < inner;
  const long long first =
      (static_cast<long long>(blockIdx.y) * n + t) * inner + col;
  float2 v[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const long long idx = first + static_cast<long long>(k * T) * inner;
    v[k] = live ? make_float2(re[idx], im[idx]) : make_float2(0.f, 0.f);
  }
  rf::first_pass<P, SIGN>(v, buf + c * stride, t);
  __syncthreads();

  // column-standing throughout: a line's threads are strided by PANEL
  // across the block, so they meet at block barriers
  rf::later_passes<P, SIGN, rf::BlockSync>(v, buf + c * stride, t, tw);

  // v[k] = X[t + k T] of column c: the store is the load's own segments.
  // In place is safe: every element is written by the thread that read it,
  // after it read it, and no other block touches the panel.
  if (live) {
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const long long idx = first + static_cast<long long>(k * T) * inner;
      re[idx] = v[k].x;
      im[idx] = v[k].y;
    }
  }
}

template <class P, int PANEL, int SIGN>
int launch(void* re, void* im, const void* tw, int outer, long long inner,
           cudaStream_t stream) {
  using K = Axis<P, PANEL>;
  cudaError_t err = cudaFuncSetAttribute(
      fft_axis_kernel<P, PANEL, SIGN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(K::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((inner + PANEL - 1) / PANEL),
                  static_cast<unsigned>(outer));
  fft_axis_kernel<P, PANEL, SIGN><<<grid, K::kThreads, K::kSmem, stream>>>(
      static_cast<float*>(re), static_cast<float*>(im),
      static_cast<const float2*>(tw), inner);
  return static_cast<int>(cudaGetLastError());
}

// The instances, one for each length (and sign): X(n, r0, r1, r2, panel),
// the plan ops/fft.py:radix_plan(n) and the panel ops/fft.py:rotate_panel(n).
#define RF_AXIS_INSTANCES(X)                                               \
  X(16, 4, 4, 1, 64) X(32, 8, 4, 1, 64) X(64, 8, 8, 1, 32)                 \
  X(128, 16, 8, 1, 32) X(256, 16, 16, 1, 16) X(512, 16, 8, 4, 8)           \
  X(1024, 16, 8, 8, 16) X(2048, 16, 16, 8, 8)

}  // namespace

// re, im: float32 (outer, n, inner), contiguous, transformed in place:
// X[j] = sum_k x[k] exp(sign 2 pi i j k / n).  (r0, r1, r2) is
// ops/fft.py:radix_plan(n), r2 = 1 for two passes; tw its tables for the
// sign (pass_twiddles(n, sign)); panel the columns a block owns
// (ops/fft.py:rotate_panel(n)).  outer <= 65535; the caller checks.
// Returns the CUDA error of the launch (0 on success),
// cudaErrorNotSupported for a sign, plan and panel with no instance.
extern "C" int rf_fft_axis(void* re, void* im, const void* tw, int sign,
                           int outer, int n, long long inner, int r0, int r1,
                           int r2, int panel, void* stream) {
#define RF_CASE(N, R0, R1, R2, PANEL)                                      \
  if (n == N && r0 == R0 && r1 == R1 && r2 == R2 && panel == PANEL) {      \
    using P = rf::Plan<N, R0, R1, R2>;                                     \
    const cudaStream_t s = static_cast<cudaStream_t>(stream);              \
    if (sign == 1) return launch<P, PANEL, 1>(re, im, tw, outer, inner, s);   \
    if (sign == -1) return launch<P, PANEL, -1>(re, im, tw, outer, inner, s); \
  }
  RF_AXIS_INSTANCES(RF_CASE)
#undef RF_CASE
  return rf::kNoSuchPlan;
}

// Registers a thread, blocks an SM holds, threads a block and dynamic
// shared-memory bytes of the instance for a sign, plan and panel; returns
// 0, or cudaErrorNotSupported.
extern "C" int rf_fft_axis_attributes(int sign, int n, int r0, int r1, int r2,
                                      int panel, void* registers,
                                      void* blocks_per_sm, void* threads,
                                      void* smem) {
#define RF_ATTR(PANEL, SIGN)                                               \
  rf::kernel_attributes(fft_axis_kernel<P, PANEL, SIGN>, K::kThreads,      \
                        K::kSmem, registers, blocks_per_sm, threads, smem)
#define RF_CASE(N, R0, R1, R2, PANEL)                                      \
  if (n == N && r0 == R0 && r1 == R1 && r2 == R2 && panel == PANEL) {      \
    using P = rf::Plan<N, R0, R1, R2>;                                     \
    using K = Axis<P, PANEL>;                                              \
    if (sign == 1) return RF_ATTR(PANEL, 1);                               \
    if (sign == -1) return RF_ATTR(PANEL, -1);                             \
  }
  RF_AXIS_INSTANCES(RF_CASE)
#undef RF_CASE
#undef RF_ATTR
  return rf::kNoSuchPlan;
}
