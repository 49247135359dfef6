// K9: unnormalized inverse complex FFT down the rows of each group of a
// float32 re/im pair viewed as (groups, n, cols), written ROTATED: output row
// g * cols + col holds the n transformed values of input column col of group
// g, so the output is (groups * cols, n) with the transformed axis minor.
// Natural order out; new tensors (the rotation cannot run in place).
//
// Replaces randomfield_tpu/ops/pallas_fft.py:_make_sublane_kernel, reached
// through _ifft_sublane2d (ifft_sublane_pallas_reim), the transform of the
// staged v4 render (engine/staged.py:_stages_v4): "physical transpose + minor
// axis FFT" as one pass over device memory.  The TPU kernel gets the rotation
// from its stage-2 matmul's free choice of output orientation and leaves the
// lanes in raw digit order, which a later gather undoes; here the transform
// is self-sorting, so no digit fix exists.
//
// What bounds it on the H100: device-memory bytes, one read and one write of
// each lattice (16 bytes per complex element), the read in segments of
// PANEL floats; the transform must stay out of their way, which
// barrier-closed radix-2 stages in shared memory do not (fft_radix.cuh has
// the reckoning).  Design: the register-radix core of fft_radix.cuh.
// A block owns PANEL consecutive columns by all n rows of one group, with
// PANEL * n / E threads.  The rotation costs no pass of its own.  The threads
// first stand along the columns (consecutive threads, consecutive columns:
// PANEL contiguous floats per row, E rows a thread, all loads in flight
// together): the thread that reads rows t + k n/E of a column holds exactly
// what the core's first pass wants at place t of that column's line, so it
// runs that pass from the registers it loaded into and writes the first
// exchange into the line's shared-memory row.  The row stride is 2 (PANEL =
// 8) or 1 (PANEL >= 16) modulo 16, so the PANEL lines a half-warp writes at
// once fall into distinct banks.  After the one block barrier the threads
// stand along the lines (n / E consecutive threads a line), read the exchange
// as any later pass would, run the remaining passes and store X[t + k n/E]
// from their registers: each line is one whole output row and the panel's
// rows lie back to back, so the block writes PANEL * n contiguous floats,
// coalesced.  A 1024-point line so makes two trips through shared memory,
// and the later syncs are the line's own (fft_radix.cuh).  The panel: 16
// columns (64-byte segments) at n = 1024, where that is one 1024-thread
// block of 136 KB an SM, measured faster on an H100 than two 512-thread
// blocks of 8 columns (3.4 against 3.9 ms a 1024^3 pass);
// ops/fft.py:rotate_panel has the rule.  The columns ride grid.x
// (a 1024^3 pass has 525312 of them) and the groups grid.y; indices are
// 64-bit.
#include "fft_radix.cuh"

namespace {

template <class P, int PANEL>
struct Rotate {
  static constexpr int kThreads = PANEL * P::T;
  static_assert(kThreads <= 1024, "a block has at most 1024 threads");
  static constexpr int kStride = rf::row_stride(P::N, PANEL >= 16 ? 1 : 16 / PANEL);
  static constexpr size_t kSmem = sizeof(float2) * PANEL * kStride;
  // 64 registers a thread: 1024 threads an SM whatever the block size
  static constexpr int kMinBlocks = 1024 / kThreads;
};

template <class P, int PANEL>
__global__ void __launch_bounds__(Rotate<P, PANEL>::kThreads,
                                  Rotate<P, PANEL>::kMinBlocks)
fft_rotate_kernel(const float* __restrict__ re, const float* __restrict__ im,
                  float* __restrict__ out_re, float* __restrict__ out_im,
                  const float2* __restrict__ tw, long long cols) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int n = P::N, E = P::E, T = P::T;
  constexpr int stride = Rotate<P, PANEL>::kStride;
  float2* buf = reinterpret_cast<float2*>(smem_raw);
  const long long col0 = static_cast<long long>(blockIdx.x) * PANEL;
  const long long group = static_cast<long long>(blockIdx.y);
  float2 v[E];

  {  // along the columns: thread (place t, column c) reads rows t + k T of
     // column c, which are the elements the first pass wants at place t of
     // line c, runs it and writes the line's row
    const int c = threadIdx.x % PANEL;
    const int t = threadIdx.x / PANEL;
    const long long col = col0 + c;
    const bool live = col < cols;
    const long long first = (group * n + t) * cols + col;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const long long idx = first + static_cast<long long>(k * T) * cols;
      v[k] = live ? make_float2(re[idx], im[idx]) : make_float2(0.f, 0.f);
    }
    rf::first_pass<P, +1>(v, buf + c * stride, t);
  }
  __syncthreads();

  // along the lines: thread (line b, place t); v[k] = X[t + k T] after
  const int t = threadIdx.x % T;
  const int b = threadIdx.x / T;
  rf::later_passes<P, +1>(v, buf + b * stride, t, tw);

  // line b is output row group * cols + col0 + b: the block's rows are
  // contiguous, n floats each
  if (col0 + b < cols) {
    const long long out0 = (group * cols + col0 + b) * n + t;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      out_re[out0 + k * T] = v[k].x;
      out_im[out0 + k * T] = v[k].y;
    }
  }
}

template <class P, int PANEL>
int launch(const void* re, const void* im, void* out_re, void* out_im,
           const void* tw, int groups, long long cols, cudaStream_t stream) {
  using K = Rotate<P, PANEL>;
  cudaError_t err = cudaFuncSetAttribute(
      fft_rotate_kernel<P, PANEL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(K::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((cols + PANEL - 1) / PANEL),
                  static_cast<unsigned>(groups));
  fft_rotate_kernel<P, PANEL><<<grid, K::kThreads, K::kSmem, stream>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<float*>(out_re), static_cast<float*>(out_im),
      static_cast<const float2*>(tw), cols);
  return static_cast<int>(cudaGetLastError());
}

// The instances, one for each length: X(n, r0, r1, r2, panel), the plan
// ops/fft.py:radix_plan(n) and the panel ops/fft.py:rotate_panel(n).
#define RF_ROTATE_INSTANCES(X)                                             \
  X(16, 4, 4, 1, 64) X(32, 8, 4, 1, 64) X(64, 8, 8, 1, 32)                 \
  X(128, 16, 8, 1, 32) X(256, 16, 16, 1, 16) X(512, 16, 8, 4, 8)           \
  X(1024, 16, 8, 8, 16) X(2048, 16, 16, 8, 8)

}  // namespace

// re, im: float32 (groups, n, cols), contiguous, read only; out_re, out_im:
// float32 (groups * cols, n), contiguous: out[g * cols + col][j] = sum_k
// x[g][k][col] exp(+2 pi i j k / n).  (r0, r1, r2) is
// ops/fft.py:radix_plan(n), r2 = 1 for two passes; tw its inverse tables
// (pass_twiddles(n, +1)); panel the columns a block owns
// (ops/fft.py:rotate_panel(n)).  groups <= 65535; the caller checks.  Returns
// the CUDA error of the launch (0 on success), cudaErrorNotSupported for a
// plan and panel with no instance.
extern "C" int rf_fft_rotate(const void* re, const void* im, void* out_re,
                             void* out_im, const void* tw, int groups, int n,
                             long long cols, int r0, int r1, int r2, int panel,
                             void* stream) {
#define RF_CASE(N, R0, R1, R2, PANEL)                                      \
  if (n == N && r0 == R0 && r1 == R1 && r2 == R2 && panel == PANEL) {      \
    return launch<rf::Plan<N, R0, R1, R2>, PANEL>(                         \
        re, im, out_re, out_im, tw, groups, cols,                          \
        static_cast<cudaStream_t>(stream));                                \
  }
  RF_ROTATE_INSTANCES(RF_CASE)
#undef RF_CASE
  return rf::kNoSuchPlan;
}

// Registers a thread, blocks an SM holds, threads a block and dynamic
// shared-memory bytes of the instance for a plan and panel; returns 0, or
// cudaErrorNotSupported.
extern "C" int rf_fft_rotate_attributes(int n, int r0, int r1, int r2,
                                        int panel, void* registers,
                                        void* blocks_per_sm, void* threads,
                                        void* smem) {
#define RF_CASE(N, R0, R1, R2, PANEL)                                      \
  if (n == N && r0 == R0 && r1 == R1 && r2 == R2 && panel == PANEL) {      \
    using K = Rotate<rf::Plan<N, R0, R1, R2>, PANEL>;                      \
    return rf::kernel_attributes(                                          \
        fft_rotate_kernel<rf::Plan<N, R0, R1, R2>, PANEL>, K::kThreads,    \
        K::kSmem, registers, blocks_per_sm, threads, smem);                \
  }
  RF_ROTATE_INSTANCES(RF_CASE)
#undef RF_CASE
  return rf::kNoSuchPlan;
}
