// Shared-memory radix-2 complex FFT: the device routine of the fused sample +
// x-FFT (sample_fftx.cu, K10), its only caller.  The axis FFT (K3), the c2r
// tail (K4), the r2c head (K6) and the rotating axis FFT (K9) run the
// register-radix routine of fft_radix.cuh, from which this one takes cmul
// and conj_if.  Its direction is its twiddles' sign: a caller passes
// exp(+2 pi i k / n) for the inverse and their conjugates for the forward
// transform.
//
// Counterpart of randomfield_tpu/ops/pallas_fft.py:_ct_core, which the TPU's
// minor-axis FFT and c2r tail kernels share in the same way.  The TPU version
// is a two-stage Cooley-Tukey built for a 128-lane vector unit and a 128x128
// matrix unit (A-point stage on the VPU, 128-point DFT as an MXU matmul, raw
// digit order out).  On Hopper the transform runs instead as an iterative
// radix-2 decimation-in-time FFT over lines held in shared memory: the caller
// loads each line in bit-reversed order, log2(n) butterfly stages follow, each
// closed by a block barrier, and the result comes out in natural order, so no
// digit-fix pass exists anywhere.
//
// Accuracy: float32 butterflies with twiddles built in double on the host and
// rounded once to float32 (the class of the TPU kernel's float64-built
// constants): about 1e-7 of the largest output for random input.
#pragma once

#include <cuda_runtime.h>

#include "fft_radix.cuh"

namespace rf {

// The low `log2n` bits of `v` in reverse order.
__device__ __forceinline__ int bit_reverse(int v, int log2n) {
  return static_cast<int>(__brev(static_cast<unsigned>(v)) >> (32 - log2n));
}

// log2 of a power of two (host side: the launchers pass it to the kernels).
inline int log2_of(long long v) {
  int k = 0;
  while ((1LL << k) < v) ++k;
  return k;
}

// Unnormalized FFT, X[j] = sum_k x[k] exp(sign 2 pi i j k / n), of `lines`
// lines in shared memory.  Line l occupies buf[l * stride, l * stride + n) and
// holds x[k] at position bit_reverse(k, log2n); on return it holds X[j] at j.
// tw[k * tw_step] must be exp(sign 2 pi i k / n) for 0 <= k < n / 2.  Every
// thread of the block calls this after a barrier that follows the load; it
// ends with a barrier, so the caller may read any line right after it.
__device__ inline void fft_lines(float2* buf, int lines, int n, int log2n,
                                 int stride, const float2* tw, int tw_step) {
  const int half_n = n >> 1;
  const int total = lines * half_n;
  for (int s = 0; s < log2n; ++s) {
    const int half = 1 << s;  // butterfly span of this stage
    // W_{2 half}^j = W_n^{j n / (2 half)}
    const int tw_scale = (half_n >> s) * tw_step;
    for (int b = threadIdx.x; b < total; b += blockDim.x) {
      const int line = b >> (log2n - 1);
      const int k = b & (half_n - 1);
      const int j = k & (half - 1);
      const int i0 = ((k >> s) << (s + 1)) + j;
      float2* row = buf + line * stride;
      const float2 v = cmul(row[i0 + half], tw[j * tw_scale]);
      const float2 u = row[i0];
      row[i0] = make_float2(u.x + v.x, u.y + v.y);
      row[i0 + half] = make_float2(u.x - v.x, u.y - v.y);
    }
    __syncthreads();
  }
}

}  // namespace rf
