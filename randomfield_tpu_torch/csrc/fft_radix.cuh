// Register-radix Stockham complex FFT: the device routine of every FFT
// kernel of the port: the axis FFT (fft_axis.cu, K3), the c2r tail
// (c2r_tail.cu, K4), the r2c head (r2c_head.cu, K6), the rotating axis FFT
// (fft_rotate.cu, K9) and the fused sample + x-FFT (sample_fftx.cu, K10).
//
// Counterpart of randomfield_tpu/ops/pallas_fft.py:_ct_core: the same
// transform thought through for what is scarce on Hopper.
//
// What bounded the radix-2 routine it replaced (an iterative radix-2
// decimation-in-time FFT over lines in shared memory, which the port ran
// until K10 moved off it): log2(n) stages, each of which read and
// wrote every element in shared memory (20 bytes per element and stage with
// the twiddle, 200 bytes for a 1024-point line against 16 through device
// memory), closed each stage with a block barrier, read twiddles that fell
// into one bank for half of the stages, and needed a bit-reversed scatter to
// fill the lines.
//
// What this design does about it.  A line of n = R0 R1 [R2] points is
// transformed in two or three passes of radix 4, 8 or 16 (the plan comes
// from the launcher: ops/fft.py:radix_plan).  n / E threads share a line, E
// = R0, and thread t holds the E elements t + k n/E in registers in EVERY
// pass: a pass of radix R runs E / R butterflies per thread on them, so
//   * the fill is the coalesced load itself (consecutive threads, consecutive
//     elements), and the last pass leaves X[t + k n/E] in the registers, in
//     natural order, ready for a coalesced store: no bit reversal anywhere;
//   * lines go through shared memory only between passes (the Stockham
//     self-sorting exchange: output r of butterfly j goes to (j - j mod Ns) R
//     + j mod Ns + r Ns, Ns the product of the earlier radices): 16 bytes per
//     element and exchange, one or two exchanges;
//   * only the threads of a line meet, once before an exchange is read and
//     once before its row is written again: in a warp-level sync where a
//     line belongs to one warp (n / E <= 32), else at a named barrier of the
//     four warps the line lies in, so no pass stalls the whole block (a
//     kernel whose lines' threads are strided across the block, as K3's
//     column-standing ones are, passes BlockSync instead).
// Bank conflicts: element i of a line lives at i + i / 16.  The first
// exchange writes with stride R0 between consecutive threads, which the
// padding turns into an odd stride for R0 = 16 and into distinct banks for
// R0 = 4 and 8; every later exchange writes runs of Ns >= 16 consecutive
// elements (radix_plan puts radix 16 first whenever there is a third pass),
// and every read is of consecutive elements.  Twiddles: float32 values built
// in float64 on the host (ops/fft.py:pass_twiddles), one table per pass after
// the first, laid out [(r - 1) Ns + j mod Ns], so a warp reads consecutive
// entries for each r; they are read through the read-only cache (a 1024-point
// plan's tables are 8 KB), which keeps shared memory for the lines (staging
// them in shared memory measured no faster).  The R-point butterflies use
// compile-time roots of unity.
//
// Registers are the scarce resource: 2 E floats of data plus a butterfly's
// temporaries; the kernels cap themselves at 64 registers a thread with
// __launch_bounds__ so that 1024 threads fit an SM.
//
// Accuracy: float32 butterflies with twiddles built in float64 on the host and
// rounded once: about 1e-7 of the largest output for random input.
#pragma once

#include <cuda_runtime.h>

namespace rf {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 conj_if(float2 a, bool conjugate) {
  return conjugate ? make_float2(a.x, -a.y) : a;
}

// where element i of a line lives in its shared-memory row
__device__ __forceinline__ int pad16(int i) { return i + (i >> 4); }

// The floats a row of n elements takes, stretched until it is `residue`
// modulo 16: the caller picks the residue that spreads the rows a half-warp
// touches at once over the banks.
constexpr int row_stride(int n, int residue) {
  int s = n + (n >> 4);
  while ((s & 15) != (residue & 15)) ++s;
  return s;
}

// a times SIGN i
template <int SIGN>
__device__ __forceinline__ float2 mul_i(float2 a) {
  return SIGN > 0 ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// exp(SIGN 2 pi i k / 16); k is a compile-time value once the loops that
// call this are unrolled, so the switch folds to two constants.
template <int SIGN>
__device__ __forceinline__ float2 root16(int k) {
  constexpr float c1 = 0.92387953251128674f;  // cos(pi / 8)
  constexpr float s1 = 0.38268343236508977f;  // sin(pi / 8)
  constexpr float h = 0.70710678118654752f;   // cos(pi / 4)
  float c = 1.f, s = 0.f;
  switch (k & 15) {
    case 1: c = c1; s = s1; break;
    case 2: c = h; s = h; break;
    case 3: c = s1; s = c1; break;
    case 4: c = 0.f; s = 1.f; break;
    case 5: c = -s1; s = c1; break;
    case 6: c = -h; s = h; break;
    case 7: c = -c1; s = s1; break;
    case 8: c = -1.f; s = 0.f; break;
    case 9: c = -c1; s = -s1; break;
    case 10: c = -h; s = -h; break;
    case 11: c = -s1; s = -c1; break;
    case 12: c = 0.f; s = -1.f; break;
    case 13: c = s1; s = -c1; break;
    case 14: c = h; s = -h; break;
    case 15: c = c1; s = -s1; break;
    default: break;
  }
  return make_float2(c, SIGN > 0 ? s : -s);
}

// four points, natural order in and out
template <int SIGN>
__device__ __forceinline__ void dft4(float2& v0, float2& v1, float2& v2,
                                     float2& v3) {
  const float2 a0 = cadd(v0, v2), a1 = csub(v0, v2);
  const float2 b0 = cadd(v1, v3), b1 = mul_i<SIGN>(csub(v1, v3));
  v0 = cadd(a0, b0);
  v1 = cadd(a1, b1);
  v2 = csub(a0, b0);
  v3 = csub(a1, b1);
}

// R = 4, 8 or 16 points in registers, natural order in and out:
// X[k] = sum_n a[n] exp(SIGN 2 pi i n k / R).  With A = R / 4, n = n1 + A n2
// and k = 4 k1 + k2: A four-point transforms over n2, the roots
// W_R^(n1 k2), then four A-point transforms over n1.
template <int R, int SIGN>
__device__ __forceinline__ void dft(float2 (&a)[R]) {
  static_assert(R == 4 || R == 8 || R == 16, "radix 4, 8 or 16");
  constexpr int A = R / 4;
#pragma unroll
  for (int n1 = 0; n1 < A; ++n1) {
    dft4<SIGN>(a[n1], a[n1 + A], a[n1 + 2 * A], a[n1 + 3 * A]);
  }
  if constexpr (A > 1) {
#pragma unroll
    for (int n1 = 1; n1 < A; ++n1) {
#pragma unroll
      for (int k2 = 1; k2 < 4; ++k2) {
        a[n1 + A * k2] = cmul(a[n1 + A * k2], root16<SIGN>(n1 * k2 * (16 / R)));
      }
    }
    float2 x[R];
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) {
      if constexpr (A == 2) {
        x[k2] = cadd(a[2 * k2], a[2 * k2 + 1]);
        x[4 + k2] = csub(a[2 * k2], a[2 * k2 + 1]);
      } else {
        dft4<SIGN>(a[4 * k2], a[4 * k2 + 1], a[4 * k2 + 2], a[4 * k2 + 3]);
#pragma unroll
        for (int k1 = 0; k1 < 4; ++k1) x[4 * k1 + k2] = a[4 * k2 + k1];
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) a[k] = x[k];
  }
}

// A plan: n = R0 R1 R2 (R2 = 1 for two passes), E = R0 elements a thread,
// T = N / E threads a line.
template <int N_, int R0_, int R1_, int R2_>
struct Plan {
  static constexpr int N = N_, R0 = R0_, R1 = R1_, R2 = R2_;
  static constexpr int E = R0, T = N / E;
  static_assert(R0 * R1 * R2 == N, "the radices multiply to n");
  static_assert(E % R1 == 0 && E % R2 == 0 && R1 > 1,
                "every radix divides the elements a thread holds");
  // the threads of a line meet: in their warp when the line has one, else
  // with the other warps of their 128 threads, never with the whole block
  __device__ static __forceinline__ void sync() {
    if constexpr (T <= 32) {
      __syncwarp();
    } else {
      // a named barrier of the aligned 128 threads the line lies in
      // (barrier 0 is __syncthreads'; a block has at most eight such groups)
      static_assert(T == 64 || T == 128, "a line has 64 or 128 threads");
      asm volatile("bar.sync %0, 128;" ::"r"(1 + (threadIdx.x >> 7)) : "memory");
    }
  }
};

// One pass of radix R after NS points on the E elements v[k] = element
// t + k T of the line.  LAST: the results stay in v, v[k] = X[t + k T];
// else they are written to the line's shared-memory row, where the next
// pass's threads find element i at pad16(i).
template <class P, int R, int NS, int SIGN, bool LAST>
__device__ __forceinline__ void radix_pass(float2 (&v)[P::E], float2* row,
                                           int t, const float2* __restrict__ tw) {
  constexpr int E = P::E, T = P::T, Q = E / R;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = t + q * T;       // this butterfly, 0 <= j < N / R
    const int k = j & (NS - 1);
    float2 a[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = v[q + r * Q];
    if constexpr (NS > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) a[r] = cmul(a[r], __ldg(tw + (r - 1) * NS + k));
    }
    dft<R, SIGN>(a);
    if constexpr (LAST) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[q + r * Q] = a[r];
    } else {
      const int j0 = (j - k) * R + k;
#pragma unroll
      for (int r = 0; r < R; ++r) row[pad16(j0 + r * NS)] = a[r];
    }
  }
}

// The first pass of a line by the thread at place t of it: on entry v[k] =
// x[t + k T]; the results go to the line's shared-memory row (free to
// overwrite: nobody may still read it).  Needs no twiddles.
template <class P, int SIGN>
__device__ __forceinline__ void first_pass(float2 (&v)[P::E], float2* row, int t) {
  radix_pass<P, P::R0, 1, SIGN, false>(v, row, t, nullptr);
}

// The threads of a line meet at a barrier of the whole block: the sync
// policy of kernels whose lines' threads do not lie together in a warp or
// an aligned group of 128 threads.
struct BlockSync {
  __device__ static __forceinline__ void sync() { __syncthreads(); }
};

// The passes after the first, once every thread that ran first_pass on the
// line has been waited for: on return v[k] = X[t + k T].  The thread at
// place t here need not be the one that was at place t in first_pass (a
// kernel may regroup its threads in between, behind a block barrier).  S
// is how the line's threads meet between passes: P (a warp or a named
// barrier of 128 threads, P::sync) or BlockSync.
template <class P, int SIGN, class S = P>
__device__ __forceinline__ void later_passes(float2 (&v)[P::E], float2* row,
                                             int t, const float2* __restrict__ tw) {
  constexpr int E = P::E, T = P::T;
#pragma unroll
  for (int k = 0; k < E; ++k) v[k] = row[pad16(t + k * T)];
  // before the second exchange overwrites the row, the line's threads have
  // all read the first
  if constexpr (P::R2 > 1) S::sync();
  radix_pass<P, P::R1, P::R0, SIGN, P::R2 == 1>(v, row, t, tw);
  if constexpr (P::R2 > 1) {
    S::sync();
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = row[pad16(t + k * T)];
    radix_pass<P, P::R2, P::R0 * P::R1, SIGN, true>(
        v, row, t, tw + (P::R1 - 1) * P::R0);
  }
}

// Unnormalized FFT of one line by the T threads that share it:
// X[j] = sum_k x[k] exp(SIGN 2 pi i j k / N).  On entry v[k] = x[t + k T],
// on return v[k] = X[t + k T], t the thread's place in the line.  `row` is
// the line's row in shared memory (row_stride float2s, free to overwrite);
// tw the plan's tables for SIGN (ops/fft.py:pass_twiddles).  The T threads
// of a line call this together, lines of 64 or 128 threads in aligned
// groups of 128 threads (P::sync).
template <class P, int SIGN>
__device__ __forceinline__ void fft_registers(float2 (&v)[P::E], float2* row,
                                              int t, const float2* __restrict__ tw) {
  first_pass<P, SIGN>(v, row, t);
  P::sync();
  later_passes<P, SIGN>(v, row, t, tw);
}

// The plans the kernels are built for: ops/fft.py:radix_plan(n) for every
// n = 2^k, 16..2048.  X(n, r0, r1, r2).
#define RF_RADIX_PLANS(X)                                              \
  X(16, 4, 4, 1) X(32, 8, 4, 1) X(64, 8, 8, 1) X(128, 16, 8, 1)        \
  X(256, 16, 16, 1) X(512, 16, 8, 4) X(1024, 16, 8, 8) X(2048, 16, 16, 8)

// what a C entry returns for a plan it has no instance of
constexpr int kNoSuchPlan = static_cast<int>(cudaErrorNotSupported);

// Writes four ints for the attribute entries of the kernels: the registers
// a thread of `kernel` takes, the blocks of `threads` threads and `smem`
// bytes of dynamic shared memory an SM can hold, and those two numbers.
// Returns the CUDA error (0 on success).
template <class Kernel>
inline int kernel_attributes(Kernel kernel, int threads, size_t smem,
                             void* registers, void* blocks_per_sm,
                             void* threads_out, void* smem_out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *static_cast<int*>(registers) = attr.numRegs;
  *static_cast<int*>(blocks_per_sm) = blocks;
  *static_cast<int*>(threads_out) = threads;
  *static_cast<int*>(smem_out) = static_cast<int>(smem);
  return 0;
}

}  // namespace rf
