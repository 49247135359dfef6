// KD: a derived field's spectral kernel applied IN PLACE to a packed 'xyz'
// (nx, ny, nz/2 + 1) spectrum held as float32 re and im lattices, between
// the draw (K2F, K1 or KN) and the inverse transforms (K3, K3, K4).  Per
// mode, with |k|^2 = (kx^2 + ky^2) + kz^2 and inv = 1 / |k|^2 (0 at DC):
//
//   scalar:          c -> (pref inv) c                      (the potential)
//   grad, axis a:    c -> i g c, g = (pref k_a) inv         (displacement,
//                    velocity); i g c = (-im g, re g)
//   tidal, (a, b):   c -> (((pref k_a) k_b) inv) c          (T_ab)
//   kaiser, axis a:  c -> (b + f ((k_a k_a) inv)) c         (redshift space)
//
// The odd kernels (grad, and the tidal pairs a != b) take the k vectors with
// the Nyquist entry of each even axis zeroed (a Nyquist mode's derivative
// has no real-field representation); the tidal diagonals and Kaiser take the
// full vectors (even kernels keep the spectrum Hermitian, and the diagonals
// sum to 1 on every non-DC mode: trace T = delta).  ``grad_diag`` gives the
// diagonals the zeroed vectors too, as the 2LPT source does.
//
// Replaces randomfield_tpu/ops/derived.py:265 apply_kernel_inline, which
// the JAX package leaves to XLA (no Pallas kernel): the elementwise pass of
// engine/generator.py:_derived_from_kernel and of the field-first helpers.
// Like it, the kernel builds the k vectors from the axis indices in the
// thread (numpy's fftfreq in float64, i (1 / (n d)) times 2 pi, rounded to
// float32), so no full-size kernel array exists; every product, sum and
// quotient is rounded as written, in ops/derived.py:apply_kernel_plain's
// order, so the two agree bit for bit.
//
// What bounds it on the H100: device-memory bytes, one read and one write
// of each lattice (16 bytes a mode: 8.607 GB, 2.569 ms at 1024^3 and 3.35
// TB/s); per mode it does a handful of multiplies and one division.
// Design: blockIdx.y is the x row (kx once a block), the block's eight
// warps take eight ky rows (ky once a warp), the lanes walk a row's kz 32
// at a time (coalesced, no division a mode), and kz comes from a table the
// block builds in shared memory.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Kind : int { kScalar = 0, kGrad = 1, kTidal = 2, kKaiser = 3 };

constexpr double kTwoPi = 6.283185307179586;

// 2 pi fftfreq(n, d)[i] rounded to float32, val = 1 / (n d): the signed
// index i (i - n from (n + 1) / 2 on; the rfft axis passes i unsigned) times
// val, times 2 pi, both products in float64 as numpy rounds them.
__device__ __forceinline__ float axis_k(int s, double val) {
  return __double2float_rn(__dmul_rn(kTwoPi, __dmul_rn(static_cast<double>(s),
                                                       val)));
}

__device__ __forceinline__ int fft_signed(int i, int n) {
  return i < (n + 1) / 2 ? i : i - n;
}

struct Args {
  float* re;
  float* im;
  int nx, ny, nz, nzh;
  double val_x, val_y, val_z;
  int kind, a, b, grad_diag;
  float p0, p1;
};

// The k of one mode on each axis, full, and whether each is its axis'
// Nyquist entry (index n/2 of an even axis).
struct ModeK {
  float k[3];
  bool nyq[3];

  // The vector of ``axis`` at this mode: full, or Nyquist-zeroed.
  __device__ __forceinline__ float get(int axis, bool zeroed) const {
    const float v = axis == 0 ? k[0] : axis == 1 ? k[1] : k[2];
    const bool n = axis == 0 ? nyq[0] : axis == 1 ? nyq[1] : nyq[2];
    return zeroed && n ? 0.f : v;
  }
};

__global__ void __launch_bounds__(kThreads)
spectral_kernel(const Args args) {
  extern __shared__ float kz_tab[];  // full kz of each kz index
  const Args& p = args;
  for (int z = threadIdx.x; z < p.nzh; z += blockDim.x) {
    kz_tab[z] = axis_k(z, p.val_z);
  }
  __syncthreads();

  const int x = blockIdx.y;
  const int y = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (y >= p.ny) return;
  const int lane = threadIdx.x & 31;
  ModeK m;
  m.k[0] = axis_k(fft_signed(x, p.nx), p.val_x);
  m.k[1] = axis_k(fft_signed(y, p.ny), p.val_y);
  m.nyq[0] = p.nx % 2 == 0 && x == p.nx / 2;
  m.nyq[1] = p.ny % 2 == 0 && y == p.ny / 2;
  const float kxy =
      __fadd_rn(__fmul_rn(m.k[0], m.k[0]), __fmul_rn(m.k[1], m.k[1]));
  const bool zeroed = p.kind == kGrad || (p.kind == kTidal &&
                                          (p.a != p.b || p.grad_diag));
  const long long row = (static_cast<long long>(x) * p.ny + y) * p.nzh;
  float* rp = p.re + row;
  float* ip = p.im + row;
  for (int z = lane; z < p.nzh; z += 32) {
    m.k[2] = kz_tab[z];
    m.nyq[2] = p.nz % 2 == 0 && z == p.nzh - 1;
    const float k2 = __fadd_rn(kxy, __fmul_rn(m.k[2], m.k[2]));
    const float inv = k2 > 0.f ? __fdiv_rn(1.f, k2) : 0.f;
    const float re = rp[z];
    const float im = ip[z];
    if (p.kind == kGrad) {
      const float g = __fmul_rn(__fmul_rn(p.p0, m.get(p.a, true)), inv);
      rp[z] = -__fmul_rn(im, g);
      ip[z] = __fmul_rn(re, g);
      continue;
    }
    float g;
    if (p.kind == kScalar) {
      g = __fmul_rn(p.p0, inv);
    } else if (p.kind == kTidal) {
      g = __fmul_rn(__fmul_rn(__fmul_rn(p.p0, m.get(p.a, zeroed)),
                              m.get(p.b, zeroed)),
                    inv);
    } else {  // kKaiser: p0 = b, p1 = f
      const float kl = m.get(p.a, false);
      g = __fadd_rn(p.p0, __fmul_rn(p.p1, __fmul_rn(__fmul_rn(kl, kl), inv)));
    }
    rp[z] = __fmul_rn(re, g);
    ip[z] = __fmul_rn(im, g);
  }
}

}  // namespace

// re, im: float32 (nx, ny, nz/2 + 1), contiguous, transformed in place.
// val_x, val_y, val_z: numpy's 1 / (n d) of each axis (float64).  kind: 0
// scalar (p0 = prefactor), 1 grad (a = axis, p0 = prefactor), 2 tidal (a,
// b = the pair, p0 = prefactor, grad_diag: Nyquist-zeroed vectors on the
// diagonal too), 3 kaiser (a = line-of-sight axis, p0 = b, p1 = f).  nx up
// to 65535.  Returns the CUDA error of the launch.
extern "C" int rf_spectral_kernel(void* re, void* im, int nx, int ny, int nz,
                                  double val_x, double val_y, double val_z,
                                  int kind, int a, int b, int grad_diag,
                                  float p0, float p1, void* stream) {
  if (kind < kScalar || kind > kKaiser || a < 0 || a > 2 || b < 0 || b > 2 ||
      nx < 1 || nx > 65535 || ny < 1 || nz < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nzh = nz / 2 + 1;
  const Args args{static_cast<float*>(re), static_cast<float*>(im), nx, ny,
                  nz, nzh, val_x, val_y, val_z, kind, a, b, grad_diag, p0, p1};
  const size_t smem = sizeof(float) * static_cast<size_t>(nzh);
  const dim3 grid((ny + kWarps - 1) / kWarps, nx);
  spectral_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      args);
  return static_cast<int>(cudaGetLastError());
}
