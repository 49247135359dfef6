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
//     gives 0.  A cell with lambda >= 10 sets its bit in the bin's marks (a
//     warp's ballot: one word a 32 cells) and its bin's flag.
//   pass 1 (flagged bins only): each cell's first accepting iteration of
//     the transformed rejection loop, reduced to the bin's maximum: the
//     loop's iteration count N.  An unmarked (Knuth) cell runs at lambda =
//     1e5 on constants a block forms once, and reads neither g nor forms
//     lambda; a marked cell forms its lambda.  Only the maximum matters, so
//     a Knuth cell takes the cheap first test (accept1) alone while its
//     iterations stay below the block's maximum so far, and each lane
//     takes its next (cell, bin) as soon as one is settled.
//   pass 2 (flagged bins only): each marked cell walks N iterations and
//     keeps the k of its last acceptance (JAX's k_out select).  A warp
//     reads 32 words of marks at once and replays only the set bits.
//
// Passes 1 and 2 read the flags and N from device memory and return at
// once for unflagged bins, so the wrapper launches all three with no host
// read.  The host hands over a table of each bin's first TABLE subkeys of
// both chains and the chain keys after them; a thread derives later ones.
//
// On a slab mesh a rank holds the x slab of cells [offset, offset + n) of
// the whole grid: every uniform is drawn at the cell's global index offset
// + i (jax.random.poisson is partitionable), and the loop's count is the
// whole grid's, so the wrapper launches the passes one at a time
// (first_pass, last_pass) with an all-reduce of the state's maximum over
// the ranks after the Knuth pass (a bin whose lambda reached 10 on any rank
// runs its rejection loop on every rank) and after the first-acceptance pass
// (N is the maximum over every rank's cells), both on the device.
//
// Every float operation repeats ops/poisson.py's plain version in its order
// (XLA's CPU log, exp and lgamma: Cephes' polynomials and a Lanczos sum,
// multiply-adds fused): products and sums through the _rn intrinsics, so
// nvcc contracts nothing, and each of XLA's fused multiply-adds one
// __fmaf_rn (fma32), rounded once as XLA's is and as the plain version's
// exactly rounded _fma is.  Subnormal results are flushed explicitly
// (flush, kMinNorm), as XLA's CPU backend flushes them.  The kernel equals
// poisson_counts_plain bit for bit, and with it jax.random.poisson on XLA's
// CPU backend on every tested cell.
//
// What bounds it on the H100: at 1024^3 with 4 halo bins it reads g once
// (4.3 GB) and writes 4 int32 count grids (17.2 GB): 6.4 ms at 3.35 TB/s.
// Its work is the hashes: one Threefry-2x32 a Knuth iteration (about 1 +
// lambda a cell and bin) and, in every bin with a cell at lambda >= 10,
// two a rejection iteration of every cell (a cell at lambda = 1e5 passes
// accept1 at iteration 0 four times in five): about 75 integer
// instructions each, 40 of them rotations and xors that only the ALU
// pipe (64 a clock an SM) runs, the adds on it or on the FMA pipe, all
// through an issue of 128 a clock an SM.  Design:
// one thread a cell (a grid-stride loop), the bins in a loop inside the
// thread, so g is read once; the table read through the read-only cache;
// the first acceptance test before k; the marks, so that neither
// rejection pass forms a Knuth cell's lambda and the replay touches only
// the marked cells; a first pass whose lanes run apart (a warp of cells
// in step would wait on its slowest lane, and on its log and lgamma).
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
constexpr float kKnuthCellLambda = 1e5f;  // JAX's rejection lambda of a Knuth cell
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
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
  uint32_t* marks;         // (nbins, words): bit c % 32 of word c / 32 set
                           // where cell c's lambda >= 10
  long long words;         // words a bin of marks: ceil(n / 32)
  unsigned long long offset;  // the global index of cell 0 (a mesh's slab)
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

  Rejection() = default;
  __device__ explicit Rejection(float l) : lam(l) {
    log_lam = xla_log(l);
    b = fma32(__fsqrt_rn(l), 0x1.43d70ap+1f, 0x1.dcac08p-1f);
    a = fma32(b, 0x1.96d092p-6f, -0x1.e353f8p-5f);
    inv_alpha = __fadd_rn(0x1.1fb7eap+0f,
                          __fdiv_rn(0x1.21ff2ep+0f, __fsub_rn(b, 0x1.b33334p+1f)));
    v_r = __fsub_rn(0x1.dafb7ep-1f, __fdiv_rn(0x1.cfaacep+1f, __fsub_rn(b, 2.f)));
  }

  // One iteration on the subkeys (s0, s1): whether it accepts, and its k
  // in *k_out where k_out is given.  JAX's accept = accept1 | (~reject &
  // s <= t) evaluates k, s and t for every cell: k matters only where it is
  // kept or accept1 fails, s and t only where accept1 fails and k is not
  // rejected, so only there are they formed.
  __device__ __forceinline__ bool step(const uint2* s, unsigned long long idx,
                                       float* k_out) const {
    const float u = __fsub_rn(uniform_at(s[0], idx), 0.5f);
    const float v = uniform_at(s[1], idx);
    const float us = __fsub_rn(0.5f, fabsf(u));
    const bool accept1 = us >= 0x1.1eb852p-4f && v <= v_r;
    if (accept1 && k_out == nullptr) return true;
    const float k = floorf(__fadd_rn(
        fma32(__fadd_rn(__fdiv_rn(__fmul_rn(2.f, a), us), b), u, lam),
        0x1.b851ecp-2f));
    if (k_out != nullptr) *k_out = k;
    if (accept1) return true;
    if (k < 0.f || (us < 0x1.a9fbe8p-7f && v > us)) return false;  // reject
    const float s_ = xla_log(__fdiv_rn(
        __fmul_rn(v, inv_alpha),
        __fadd_rn(__fdiv_rn(a, __fmul_rn(us, us)), b)));
    const float t =
        __fsub_rn(fma32(k, log_lam, -lam), xla_lgamma(__fadd_rn(k, 1.f)));
    return s_ <= t;
  }
};

// The iterations a cell's rejection loop runs to its first acceptance.
__device__ __forceinline__ int first_acceptance(const Rejection& rej,
                                                const uint32_t* row,
                                                int table,
                                                unsigned long long idx) {
  Chain chain;
  chain.start(row + 2 * table + 2, table, 4);
  for (int it = 0;; ++it) {
    uint2 sub[2];
    chain.at(it, sub, 2);
    if (rej.step(sub, idx, nullptr)) return it + 1;
  }
}

__device__ __forceinline__ bool any_flag(const Args& p) {
  bool any = false;  // the same in every thread of the grid
  for (int b = 0; b < p.nbins; ++b) any |= p.state[b] != 0;
  return any;
}

// Pass 0: the Knuth walks, the marks and the flags.  A warp takes 32
// consecutive cells, so one ballot a bin gives one word of marks, written
// only where a lambda reached 10 (the launch clears the marks first).
__global__ void __launch_bounds__(kThreads) knuth_kernel(const Args p) {
  const int lane = threadIdx.x & 31;
  const int key_words = 6 * p.table + 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x +
                        (threadIdx.x & ~31);
       base < p.n; base += stride) {
    const long long i = base + lane;
    const bool in = i < p.n;
    const unsigned long long idx = p.offset + static_cast<unsigned long long>(i);
    const float g = in ? __ldg(p.g + i) : 0.f;
    for (int b = 0; b < p.nbins; ++b) {
      const float lam = intensity(p, g, b);
      const bool knuth = isnan(lam) || lam < 10.f;
      const unsigned high = __ballot_sync(kFullWarp, in && !knuth);
      if (high != 0u && lane == 0) {  // the marks were cleared before
        p.marks[static_cast<long long>(b) * p.words + base / 32] = high;
        p.state[b] = 1;
      }
      if (!in) continue;
      int count = 0;  // a marked cell's, which the replay overwrites
      if (knuth) {
        Chain chain;
        chain.start(p.keys + static_cast<long long>(b) * key_words, p.table, 2);
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
      }
      p.out[static_cast<long long>(b) * p.n + i] = count;
    }
  }
}

// The first flagged bin after bin b, or nbins.
__device__ __forceinline__ int next_flagged(const Args& p, int b) {
  do {
    ++b;
  } while (b < p.nbins && p.state[b] == 0);
  return b;
}

// Pass 1: each flagged bin's rejection loop count N, the most iterations
// any of its cells needs for a first acceptance.  Only the maximum
// matters: a cell whose first acceptance is at most the block's maximum so
// far, M (the first acceptance of some cell, so at most N), changes
// nothing.  So an unmarked cell walks the cheap test accept1 alone (two
// hashes an iteration) while its iteration count stays below M, and only a
// cell that fails accept1 that often walks the exact loop from 0.  A lane
// is a machine that takes one iteration a step and its next (cell, bin)
// when one is settled, so a warp's lanes stay busy however many iterations
// each cell takes.
__global__ void __launch_bounds__(kThreads) first_kernel(const Args p) {
  extern __shared__ int need_max[];  // a bin's block maximum, M
  __shared__ Rejection knuth_cell;   // lambda = 1e5's constants
  if (!any_flag(p)) return;
  for (int b = threadIdx.x; b < p.nbins; b += blockDim.x) {
    need_max[b] = p.state[b] != 0;  // every first acceptance is at least 1
  }
  if (threadIdx.x == 0) knuth_cell = Rejection(kKnuthCellLambda);
  __syncthreads();
  const float v_r = knuth_cell.v_r;
  const int key_words = 6 * p.table + 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int b = next_flagged(p, -1);
  int it = 0;  // the iteration of (i, b) that the next step takes
  Chain chain;
  while (i < p.n) {
    const unsigned long long idx = p.offset + static_cast<unsigned long long>(i);
    const uint32_t* row = p.keys + static_cast<long long>(b) * key_words;
    int need = 0;  // a first acceptance to raise M with, once settled
    bool settled;
    if (it == 0 && ((p.marks[static_cast<long long>(b) * p.words + i / 32] >>
                     (i % 32)) & 1u)) {
      need = first_acceptance(Rejection(intensity(p, __ldg(p.g + i), b)),
                              row, p.table, idx);
      settled = true;
    } else {
      if (it == 0) chain.start(row + 2 * p.table + 2, p.table, 4);
      uint2 sub[2];
      chain.at(it, sub, 2);
      const float u = __fsub_rn(uniform_at(sub[0], idx), 0.5f);
      const float v = uniform_at(sub[1], idx);
      const float us = __fsub_rn(0.5f, fabsf(u));
      // accept1 at it: the first acceptance is at most it + 1 <= M
      settled = us >= 0x1.1eb852p-4f && v <= v_r;
      if (!settled && it + 1 >= need_max[b]) {
        need = first_acceptance(knuth_cell, row, p.table, idx);
        settled = true;
      }
    }
    if (!settled) {
      ++it;
      continue;
    }
    if (need > need_max[b]) atomicMax(need_max + b, need);
    it = 0;
    b = next_flagged(p, b);
    if (b == p.nbins) {
      i += stride;
      b = next_flagged(p, -1);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < p.nbins; b += blockDim.x) {
    if (need_max[b]) atomicMax(p.state + p.nbins + b, need_max[b]);
  }
}

// Pass 2: each marked cell's k after its bin's N iterations.  A warp reads
// 32 words of marks (1024 cells of one bin or two) and walks the set bits
// of each nonzero word, a lane a cell.
__global__ void __launch_bounds__(kThreads) replay_kernel(const Args p) {
  if (!any_flag(p)) return;
  const int lane = threadIdx.x & 31;
  const int key_words = 6 * p.table + 4;
  const long long total = p.words * p.nbins;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x +
                        (threadIdx.x & ~31);
       base < total; base += stride) {
    const uint32_t word = base + lane < total ? p.marks[base + lane] : 0u;
    for (unsigned live = __ballot_sync(kFullWarp, word != 0u); live;
         live &= live - 1) {
      const int src = __ffs(live) - 1;
      const uint32_t bits = __shfl_sync(kFullWarp, word, src);
      if (!((bits >> lane) & 1u)) continue;
      const int b = static_cast<int>((base + src) / p.words);
      const long long i = (base + src - b * p.words) * 32 + lane;
      const unsigned long long idx = p.offset + static_cast<unsigned long long>(i);
      const Rejection rej(intensity(p, __ldg(p.g + i), b));
      Chain chain;
      chain.start(p.keys + static_cast<long long>(b) * key_words + 2 * p.table + 2,
                  p.table, 4);
      const int iters = p.state[p.nbins + b];
      float k_out = -1.f;
      for (int it = 0; it < iters; ++it) {
        uint2 sub[2];
        chain.at(it, sub, 2);
        float k;
        if (rej.step(sub, idx, &k)) k_out = k;
      }
      p.out[static_cast<long long>(b) * p.n + i] = static_cast<int>(k_out);
    }
  }
}

const void* pass_kernel(int pass) {
  return pass == kKnuthPass ? reinterpret_cast<const void*>(knuth_kernel)
         : pass == kFirstPass ? reinterpret_cast<const void*>(first_kernel)
         : pass == kReplayPass ? reinterpret_cast<const void*>(replay_kernel)
                               : nullptr;
}

size_t pass_smem(int pass, int nbins) {
  return pass == kFirstPass ? sizeof(int) * nbins : 0;
}

// A persistent grid: the blocks an SM holds on every SM, or fewer where
// the pass has less work (a thread a cell, or the replay's a word of marks).
int launch(int pass, const Args& args, cudaStream_t stream) {
  int per_sm = 0, sms = 0, device = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const void* kernel = pass_kernel(pass);
  const size_t smem = pass_smem(pass, args.nbins);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  const long long threads =
      pass == kReplayPass ? args.words * args.nbins : args.n;
  const long long want = (threads + kThreads - 1) / kThreads;
  const long long fill = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const int blocks = static_cast<int>(want < fill ? want : fill);
  void* params[] = {const_cast<Args*>(&args)};
  return static_cast<int>(cudaLaunchKernel(kernel, dim3(blocks),
                                           dim3(kThreads), params, smem,
                                           stream));
}

}  // namespace

// g: float32 (n,); out: int32 (nbins, n); params: float32 (3, nbins) (form
// 0: lam0, b, c) or (1,) (form 1: scale); keys: (nbins, 6 table + 4) words
// (ops/poisson.py:key_tables); state: int32 (2, nbins) zeros, written;
// marks: uint32 (nbins, ceil(n / 32)) scratch, cleared, then written by
// the Knuth pass.  Launches passes first_pass..last_pass (0 Knuth, 1 first
// acceptance, 2 replay; the whole call 0..2) on ``stream``; a call that
// starts after pass 0 reads the state and marks an earlier call left.
// offset: the global index of g's first cell (0 on one device).
// pass_ms: null, or three floats that receive each launched pass's device
// time (CUDA events around each launch, the clearing counted with the Knuth
// pass; the call then waits for the stream).
// Returns the first CUDA error.
extern "C" int rf_poisson_counts(const void* g, void* out, long long n,
                                 int nbins, int form, const void* params,
                                 const void* keys, int table, void* state,
                                 void* marks, long long offset,
                                 int first_pass, int last_pass, void* stream,
                                 void* pass_ms) {
  if (n < 1 || nbins < 1 || nbins > kMaxBins || table < 0 || offset < 0 ||
      (form != kLognormal && form != kLinear) ||
      (form == kLinear && nbins != 1) || first_pass < kKnuthPass ||
      last_pass > kReplayPass || first_pass > last_pass) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args args{static_cast<const float*>(g), static_cast<int*>(out), n,
                  nbins, form, table, static_cast<const float*>(params),
                  static_cast<const uint32_t*>(keys),
                  static_cast<int*>(state), static_cast<uint32_t*>(marks),
                  (n + 31) / 32, static_cast<unsigned long long>(offset)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ms = static_cast<float*>(pass_ms);
  cudaEvent_t ev[4] = {};
  int status = 0;
  for (int e = 0; ms && e < 4 && !status; ++e) {
    status = static_cast<int>(cudaEventCreate(&ev[e]));
  }
  if (ms && !status) {
    status = static_cast<int>(cudaEventRecord(ev[first_pass], st));
  }
  if (!status && first_pass == kKnuthPass) {
    status = static_cast<int>(cudaMemsetAsync(
        marks, 0, sizeof(uint32_t) * args.words * nbins, st));
  }
  for (int pass = first_pass; pass <= last_pass && !status; ++pass) {
    status = launch(pass, args, st);
    if (ms && !status) {
      status = static_cast<int>(cudaEventRecord(ev[pass + 1], st));
    }
  }
  if (ms && !status) {
    status = static_cast<int>(cudaEventSynchronize(ev[last_pass + 1]));
  }
  for (int e = first_pass; ms && e <= last_pass && !status; ++e) {
    status = static_cast<int>(cudaEventElapsedTime(ms + e, ev[e], ev[e + 1]));
  }
  for (int e = 0; ms && e < 4; ++e) {
    if (ev[e]) cudaEventDestroy(ev[e]);
  }
  return status;
}

// Registers a thread, blocks an SM and threads a block of pass ``pass``
// (0 Knuth, 1 first acceptance, 2 replay; the first pass with its shared
// maxima of one bin), written as ints.
extern "C" int rf_poisson_attributes(int pass, void* registers,
                                     void* blocks_per_sm, void* threads) {
  const void* kernel = pass_kernel(pass);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr{};
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, kThreads, pass_smem(pass, 1));
  }
  *static_cast<int*>(registers) = attr.numRegs;
  *static_cast<int*>(blocks_per_sm) = blocks;
  *static_cast<int*>(threads) = kThreads;
  return static_cast<int>(err);
}
