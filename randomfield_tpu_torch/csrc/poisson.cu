// KH: Poisson counts that replay jax.random.poisson cell by cell, for one
// float32 field and several intensities ("bins") at once.
//
// Replaces XLA's jax.random.poisson (jax/_src/random.py: _poisson,
// _poisson_knuth, _poisson_rejection), which the JAX package calls in
// randomfield_tpu/models/halos.py:155 (one call a mass bin, inside a scan)
// and randomfield_tpu/models/zeldovich.py:114; no Pallas kernel.  XLA runs
// two whole-array while loops whose iterations draw uniforms from a key
// chain that does not depend on the data, so every cell can be replayed by
// one thread (ops/poisson.py derives it):
//
//   pass 0 (Knuth, every cell and bin): lambda from g in the JAX order;
//     where lambda < 10 or NaN, walk the iterations on the bin's subkey
//     chain while the running sum of logs stays above -lambda (the sum never
//     rises, so the first sum <= -lambda ends it): count - 1; lambda = 0
//     gives 0.  A cell with lambda >= 10 sets its bin's flag.
//   pass 1 (flagged bins only): each cell's first accepting iteration of
//     the transformed rejection loop, at lambda = 1e5 for the Knuth cells,
//     reduced to the bin's maximum: the loop's iteration count N.
//   pass 2 (flagged bins only): each lambda >= 10 cell walks N iterations
//     and keeps the k of its last acceptance (JAX's k_out select).
//
// Passes 1 and 2 read the flags and N from device memory and return at
// once for unflagged bins, so the wrapper launches all three with no host
// read.  The host hands over a table of each bin's first TABLE subkeys of
// both chains and the chain keys after them; a thread derives later ones.
//
// Every float operation repeats ops/poisson.py's plain version in its order
// (XLA's CPU log, exp and lgamma: Cephes' polynomials and a Lanczos sum,
// multiply-adds fused): products and sums through the _rn intrinsics, so
// nvcc contracts nothing, and each fused multiply-add as a float64 product
// and sum, rounded to float64 and then to float32 (fma32), as the plain
// version forms it.  XLA's multiply-add rounds once; the two differ only
// where the float64 sum lands exactly on a float32 rounding midpoint.  The
// kernel equals poisson_counts_plain bit for bit, and with it
// jax.random.poisson on XLA's CPU backend on every tested cell.
//
// What bounds it on the H100: at 1024^3 with 4 halo bins it reads g once
// (4.3 GB) and writes 4 int32 count grids (17.2 GB): 6.4 ms at 3.35 TB/s.
// Its work is one Threefry-2x32 hash, one log and one add a Knuth
// iteration (about 1 + lambda iterations a cell and bin), which at halo
// intensities (lambda << 1) stays below the byte bound.  Design: one thread
// a cell (a grid-stride loop), the bins in a loop inside the thread, so g
// is read once; the table read through the read-only cache (every lane of a
// warp reads the same word).
#include <cuda_runtime.h>

#include <math_constants.h>

#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKnuthPass = 0, kFirstPass = 1, kReplayPass = 2;
constexpr int kLognormal = 0, kLinear = 1;
constexpr int kMaxBins = 4096;  // the first pass keeps a maximum a bin in shared memory
constexpr float kMinNorm = 0x1p-126f;

__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(
      __dmul_rn(static_cast<double>(a), static_cast<double>(b)),
      static_cast<double>(c)));
}

__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < kMinNorm ? 0.f : x;
}

// XLA's CPU log (Cephes): -inf at 0, NaN below 0, +inf at +inf.
__device__ float xla_log(float x) {
  const float t = x > kMinNorm ? x : kMinNorm;
  const int bits = __float_as_int(t);
  float e = __fadd_rn(static_cast<float>((bits >> 23) - 127), 1.f);
  const float m0 = __int_as_float((bits & static_cast<int>(0x807FFFFFu)) |
                                  0x3F000000);
  const bool low = m0 < 0x1.6a09e6p-1f;
  e = __fsub_rn(e, low ? 1.f : 0.f);
  const float m = __fadd_rn(__fsub_rn(m0, 1.f), low ? m0 : 0.f);
  const float x2 = __fmul_rn(m, m);
  const float x3 = __fmul_rn(x2, m);
  float y = fma32(m, 0x1.204376p-4f, -0x1.d7a37p-4f);
  float y1 = fma32(m, -0x1.fcba9ep-4f, 0x1.23d37ep-3f);
  float y2 = fma32(m, 0x1.999d58p-3f, -0x1.fffff8p-3f);
  y = fma32(y, m, 0x1.de4a34p-4f);
  y1 = fma32(y1, m, -0x1.555ca0p-3f);
  y2 = fma32(y2, m, 0x1.555554p-2f);
  y = fma32(y, x3, y1);
  y = fma32(y, x3, y2);
  y = fma32(y, x3, __fmul_rn(e, -0x1.bd0106p-13f));
  float r = __fadd_rn(fma32(x2, -0.5f, m), y);
  r = fma32(e, 0x1.63p-1f, r);
  if (x > 0.f) return x == CUDART_INF_F ? CUDART_INF_F : r;
  return x == 0.f ? -CUDART_INF_F : CUDART_NAN_F;
}

// XLA's CPU exp (Cephes; the input clamped to [-87.8, 88.8]; a subnormal
// result flushed to zero).
__device__ float xla_exp(float x) {
  constexpr float kLo = -0x1.5f3334p+6f, kHi = 0x1.633334p+6f;
  x = x < kLo ? kLo : (x > kHi ? kHi : x);
  float fx = floorf(fma32(x, 0x1.715476p+0f, 0.5f));
  fx = fx < -127.f ? -127.f : (fx > 127.f ? 127.f : fx);
  float t = fma32(fx, -0x1.63p-1f, x);
  t = fma32(fx, 0x1.bd0106p-13f, t);
  float y = 0x1.a0d2cep-13f;
  y = fma32(y, t, 0x1.6e879cp-10f);
  y = fma32(y, t, 0x1.111210p-7f);
  y = fma32(y, t, 0x1.555382p-5f);
  y = fma32(y, t, 0x1.555554p-3f);
  y = fma32(y, t, 0.5f);
  y = __fadd_rn(fma32(y, __fmul_rn(t, t), t), 1.f);
  const float scale = __int_as_float((static_cast<int>(fx) + 127) << 23);
  return flush(__fmul_rn(y, scale));
}

// XLA's CPU log1p: a rational form for |w| < 0.41421357, else log(1 + w).
__device__ float xla_log1p(float w) {
  if (!(fabsf(w) < 0x1.a8279ap-2f)) return xla_log(__fadd_rn(w, 1.f));
  float p = 1.f;
  p = fma32(p, w, 0x1.e2035ap+3f);
  p = fma32(p, w, 0x1.4c30b6p+6f);
  p = fma32(p, w, 0x1.bb865ap+7f);
  p = fma32(p, w, 0x1.351946p+8f);
  p = fma32(p, w, 0x1.b0db14p+7f);
  p = fma32(p, w, 0x1.e0f304p+5f);
  float q = 0x1.7bc096p-15f;
  q = fma32(q, w, 0x1.fe818ap-2f);
  q = fma32(q, w, 0x1.a509f4p+2f);
  q = fma32(q, w, 0x1.de9738p+4f);
  q = fma32(q, w, 0x1.e798ecp+5f);
  q = fma32(q, w, 0x1.c8e75ap+5f);
  q = fma32(q, w, 0x1.40a202p+4f);
  const float w2 = __fmul_rn(w, w);
  return __fadd_rn(w, fma32(w2, -0.5f,
                            __fmul_rn(__fmul_rn(w, w2), __fdiv_rn(q, p))));
}

// XLA's CPU lgamma for x >= 0.5 (Lanczos, g = 7); the rejection loop reads
// it only at k + 1 >= 1.
__device__ float xla_lgamma(float x) {
  constexpr float kC[8] = {0x1.52429cp+9f,  -0x1.3ac8e8p+10f,
                           0x1.81a966p+9f,  -0x1.613ae6p+7f,
                           0x1.903c28p+3f,  -0x1.1bcb2ap-3f,
                           0x1.4f0514p-17f, 0x1.435508p-23f};
  const float z = __fsub_rn(x, 1.f);
  float acc = __fadd_rn(__fdiv_rn(kC[0], __fadd_rn(z, 1.f)), 1.f);
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    acc = __fadd_rn(acc, __fdiv_rn(kC[i], __fadd_rn(z, static_cast<float>(i + 1))));
  }
  const float t = __fadd_rn(z, 7.5f);
  const float log_t =
      __fadd_rn(xla_log1p(__fmul_rn(z, 0x1.111112p-3f)), 0x1.01e858p+1f);
  const float out = __fadd_rn(
      fma32(log_t, __fsub_rn(__fadd_rn(z, 0.5f), __fdiv_rn(t, log_t)),
            0x1.d67f1cp-1f),
      xla_log(acc));
  return x == CUDART_INF_F ? CUDART_INF_F : out;
}

// jax.random.uniform(key, shape, float32) at flat index i.
__device__ __forceinline__ float uniform_at(uint2 key,
                                            unsigned long long i) {
  const uint32_t bits = rf::jax_bits(key.x, key.y, i);
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.f);
}

struct Args {
  const float* g;
  int* out;
  long long n;
  int nbins, form, table;
  const float* params;     // (3, nbins): lam0, b, c; or scale (linear)
  const uint32_t* keys;    // (nbins, 6 table + 4), ops/poisson.py:key_tables
  int* state;              // (2, nbins): flags, rejection iterations
};

__device__ __forceinline__ float intensity(const Args& p, float g, int b) {
  if (p.form == kLognormal) {
    const float lam0 = __ldg(p.params + b);
    const float bias = __ldg(p.params + p.nbins + b);
    const float c = __ldg(p.params + 2 * p.nbins + b);
    return flush(__fmul_rn(lam0, xla_exp(fma32(g, bias, -c))));
  }
  const float v = __fmul_rn(__fadd_rn(1.f, g), __ldg(p.params));
  return flush(v < 0.f ? 0.f : v);  // NaN stays NaN, as torch.clamp_min
}

__device__ __forceinline__ uint2 load_key(const uint32_t* w) {
  return make_uint2(__ldg(w), __ldg(w + 1));
}

// The key chain of one loop: subkeys from the table, then derived.
struct Chain {
  const uint32_t* row;
  int table, width;  // width: words a tabulated iteration
  uint2 rng;

  __device__ void start(const uint32_t* r, int t, int w) {
    row = r;
    table = t;
    width = w;
  }
  // The subkeys of iteration i (one for Knuth, two for rejection), in
  // order of i from 0.
  __device__ __forceinline__ void at(int i, uint2* sub, int nsub) {
    if (i < table) {
      for (int s = 0; s < nsub; ++s) sub[s] = load_key(row + i * width + 2 * s);
      return;
    }
    if (i == table) rng = load_key(row + table * width);
    for (int s = 0; s < nsub; ++s) {
      sub[s] = rf::threefry2x32(rng.x, rng.y, 0u, static_cast<uint32_t>(s + 1));
    }
    rng = rf::threefry2x32(rng.x, rng.y, 0u, 0u);
  }
};

struct Rejection {
  float lam, log_lam, b, a, inv_alpha, v_r;

  __device__ explicit Rejection(float l) : lam(l) {
    log_lam = xla_log(l);
    b = fma32(__fsqrt_rn(l), 0x1.43d70ap+1f, 0x1.dcac08p-1f);
    a = fma32(b, 0x1.96d092p-6f, -0x1.e353f8p-5f);
    inv_alpha = __fadd_rn(0x1.1fb7eap+0f,
                          __fdiv_rn(0x1.21ff2ep+0f, __fsub_rn(b, 0x1.b33334p+1f)));
    v_r = __fsub_rn(0x1.dafb7ep-1f, __fdiv_rn(0x1.cfaacep+1f, __fsub_rn(b, 2.f)));
  }

  // One iteration on the subkeys (s0, s1): whether it accepts, and its k.
  // JAX's accept = accept1 | (~reject & s <= t) evaluates s and t for
  // every cell; they decide only where accept1 fails and k is not
  // rejected, so only there are the log and lgamma taken.
  __device__ bool step(const uint2* s, unsigned long long idx, float& k) const {
    const float u = __fsub_rn(uniform_at(s[0], idx), 0.5f);
    const float v = uniform_at(s[1], idx);
    const float us = __fsub_rn(0.5f, fabsf(u));
    k = floorf(__fadd_rn(
        fma32(__fadd_rn(__fdiv_rn(__fmul_rn(2.f, a), us), b), u, lam),
        0x1.b851ecp-2f));
    if (us >= 0x1.1eb852p-4f && v <= v_r) return true;  // accept1
    if (k < 0.f || (us < 0x1.a9fbe8p-7f && v > us)) return false;  // reject
    const float s_ = xla_log(__fdiv_rn(
        __fmul_rn(v, inv_alpha),
        __fadd_rn(__fdiv_rn(a, __fmul_rn(us, us)), b)));
    const float t =
        __fsub_rn(fma32(k, log_lam, -lam), xla_lgamma(__fadd_rn(k, 1.f)));
    return s_ <= t;
  }
};

template <int PASS>
__global__ void __launch_bounds__(kThreads) poisson_kernel(const Args p) {
  extern __shared__ int need_max[];  // first pass: a bin's block maximum
  if (PASS != kKnuthPass) {
    bool any = false;  // the same in every thread of the grid
    for (int b = 0; b < p.nbins; ++b) any |= p.state[b] != 0;
    if (!any) return;
  }
  if (PASS == kFirstPass) {
    for (int b = threadIdx.x; b < p.nbins; b += blockDim.x) need_max[b] = 0;
    __syncthreads();
  }
  const int words = 6 * p.table + 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < p.n; i += stride) {
    const unsigned long long idx = static_cast<unsigned long long>(i);
    const float g = __ldg(p.g + i);
    for (int b = 0; b < p.nbins; ++b) {
      if (PASS != kKnuthPass && p.state[b] == 0) continue;
      const float lam = intensity(p, g, b);
      const bool knuth = isnan(lam) || lam < 10.f;
      const uint32_t* row = p.keys + static_cast<long long>(b) * words;
      if (PASS == kKnuthPass) {
        int count = 0;
        if (knuth) {
          Chain chain;
          chain.start(row, p.table, 2);
          const float nl = -lam;
          float lp = 0.f;
          int k = 0;
          for (int it = 0; lp > nl; ++it) {
            uint2 sub;
            chain.at(it, &sub, 1);
            k += 1;
            lp = __fadd_rn(lp, xla_log(uniform_at(sub, idx)));
          }
          count = lam == 0.f ? 0 : k - 1;
        } else {
          p.state[b] = 1;
        }
        p.out[static_cast<long long>(b) * p.n + i] = count;
        continue;
      }
      if (PASS == kReplayPass && knuth) continue;
      const Rejection rej(knuth ? 1e5f : lam);
      Chain chain;
      chain.start(row + 2 * p.table + 2, p.table, 4);
      float k;
      if (PASS == kFirstPass) {
        int it = 0;
        for (;; ++it) {
          uint2 sub[2];
          chain.at(it, sub, 2);
          if (rej.step(sub, idx, k)) break;
        }
        atomicMax(need_max + b, it + 1);
      } else {
        const int iters = p.state[p.nbins + b];
        float k_out = -1.f;
        for (int it = 0; it < iters; ++it) {
          uint2 sub[2];
          chain.at(it, sub, 2);
          if (rej.step(sub, idx, k)) k_out = k;
        }
        p.out[static_cast<long long>(b) * p.n + i] = static_cast<int>(k_out);
      }
    }
  }
  if (PASS == kFirstPass) {
    __syncthreads();
    for (int b = threadIdx.x; b < p.nbins; b += blockDim.x) {
      if (need_max[b]) atomicMax(p.state + p.nbins + b, need_max[b]);
    }
  }
}

template <int PASS>
int launch(const Args& args, cudaStream_t stream) {
  int per_sm = 0, sms = 0, device = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const size_t smem = PASS == kFirstPass ? sizeof(int) * args.nbins : 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                poisson_kernel<PASS>,
                                                kThreads, smem);
  const long long want = (args.n + kThreads - 1) / kThreads;
  const long long fill = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const int blocks = static_cast<int>(want < fill ? want : fill);
  poisson_kernel<PASS><<<blocks, kThreads, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g: float32 (n,); out: int32 (nbins, n); params: float32 (3, nbins) (form
// 0: lam0, b, c) or (1,) (form 1: scale); keys: (nbins, 6 table + 4) words
// (ops/poisson.py:key_tables); state: int32 (2, nbins) zeros, written.
// Launches the Knuth, first-acceptance and replay passes on ``stream``.
// Returns the first CUDA error.
extern "C" int rf_poisson_counts(const void* g, void* out, long long n,
                                 int nbins, int form, const void* params,
                                 const void* keys, int table, void* state,
                                 void* stream) {
  if (n < 1 || nbins < 1 || nbins > kMaxBins || table < 0 ||
      (form != kLognormal && form != kLinear) ||
      (form == kLinear && nbins != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args args{static_cast<const float*>(g), static_cast<int*>(out), n,
                  nbins, form, table, static_cast<const float*>(params),
                  static_cast<const uint32_t*>(keys),
                  static_cast<int*>(state)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int status = launch<kKnuthPass>(args, st);
  if (!status) status = launch<kFirstPass>(args, st);
  if (!status) status = launch<kReplayPass>(args, st);
  return status;
}

// Registers a thread, blocks an SM and threads a block of pass ``pass``
// (0 Knuth, 1 first acceptance, 2 replay), written as ints.
extern "C" int rf_poisson_attributes(int pass, void* registers,
                                     void* blocks_per_sm, void* threads) {
  const void* kernel =
      pass == kKnuthPass ? reinterpret_cast<const void*>(
                               poisson_kernel<kKnuthPass>)
      : pass == kFirstPass ? reinterpret_cast<const void*>(
                                 poisson_kernel<kFirstPass>)
      : pass == kReplayPass ? reinterpret_cast<const void*>(
                                  poisson_kernel<kReplayPass>)
                            : nullptr;
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr{};
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kThreads, 0);
  }
  *static_cast<int*>(registers) = attr.numRegs;
  *static_cast<int*>(blocks_per_sm) = blocks;
  *static_cast<int*>(threads) = kThreads;
  return static_cast<int>(err);
}
