// KP: mass assignment of particles onto a periodic (nx, ny, nz) grid, in
// int64 fixed point, and the pass that turns the mass into a contrast.
//
// Replaces the XLA scatter-add of randomfield_tpu/models/zeldovich.py:118
// _paint (one float32 .at[].add per particle and window cell), which the
// JAX package keeps at validation scale.  Per particle, with u = (x +
// shift) / a in float32 (a divided, never multiplied by its reciprocal:
// a particle on a cell face then lands in the reference's cell):
//
//   NGP: the cell floor(u) (mod n, Python's non-negative modulo);
//   CIC: uc = u - 1/2, i0 = floor(uc), f = uc - i0; the 8 cells i0 + o
//        with weights w prod_a (o_a ? f_a : 1 - f_a);
//   TSC: uc = u - 1/2, i0 = rint(uc) (round half to even, jnp.round),
//        s = uc - i0; the 27 cells i0 + o - 1 with weights w prod_a
//        W_o(s_a), W = (0.5 (0.5 - s)^2, 0.75 - s^2, 0.5 (0.5 + s)^2);
//
// each product rounded in the reference's order (w first, then x, y, z).
// ``shift`` is the interlacing offset a/2, added in float32 before the
// division as the reference adds it to the positions, so no shifted copy of
// the positions exists; a scalar weight is an argument, never an array.
//
// Determinism: each window weight is rounded once to an int64 count of
// 2^-s units (__double2ll_rn, round half to even) and added with an integer
// atomicAdd, so the sums do not depend on the order the atomics land in:
// two calls give the same bits, and so does the plain version
// (ops/paint.py:deposit_plain, index_add_ of the same int64 terms).  The
// host picks s with sum |w| 2^s < 2^62, so no cell and no total overflows.
// The second kernel writes float32((acc 2^-s) (1 / mean) - 1), each
// float64 operation rounded as written, in the plain version's order (a
// product by the host's reciprocal: PyTorch divides a CUDA tensor by a
// scalar that way, so the plain version does the same on every device).
//
// What bounds it on the H100: the positions read once (12 bytes a particle,
// 16 with per-particle weights) and the int64 grid written (8 bytes a cell;
// its atomics mostly meet in L2).  One thread a particle; a grid-stride loop.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Args {
  const float* pos;       // (3, n) contiguous: x, then y, then z
  const float* weights;   // (n,) or null for the scalar w0
  float w0;
  long long n;
  int dims[3];
  float spacing;
  float shift;
  double scale;           // 2^s
  unsigned long long* grid;
};

__device__ __forceinline__ long long wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ void add(unsigned long long* grid, long long flat,
                                    float w, double scale) {
  const long long q = __double2ll_rn(__dmul_rn(static_cast<double>(w), scale));
  atomicAdd(grid + flat, static_cast<unsigned long long>(q));
}

template <int ORDER>
__global__ void __launch_bounds__(kThreads) paint_kernel(const Args p) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < p.n; i += stride) {
    const float w = p.weights ? p.weights[i] : p.w0;
    float u[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      u[a] = __fdiv_rn(__fadd_rn(p.pos[a * p.n + i], p.shift), p.spacing);
    }
    if (ORDER == 1) {
      long long flat = 0;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        flat = flat * p.dims[a] +
               wrap(static_cast<int>(floorf(u[a])), p.dims[a]);
      }
      add(p.grid, flat, w, p.scale);
    } else if (ORDER == 2) {
      int i0[3];
      float f[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float uc = __fsub_rn(u[a], 0.5f);
        const float fl = floorf(uc);
        i0[a] = static_cast<int>(fl);
        f[a] = __fsub_rn(uc, static_cast<float>(i0[a]));
      }
#pragma unroll
      for (int corner = 0; corner < 8; ++corner) {
        float wc = w;
        long long flat = 0;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const int o = (corner >> a) & 1;
          wc = __fmul_rn(wc, o ? f[a] : __fsub_rn(1.f, f[a]));
          flat = flat * p.dims[a] + wrap(i0[a] + o, p.dims[a]);
        }
        add(p.grid, flat, wc, p.scale);
      }
    } else {
      int i0[3];
      float w3[3][3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float uc = __fsub_rn(u[a], 0.5f);
        i0[a] = static_cast<int>(rintf(uc));
        const float s = __fsub_rn(uc, static_cast<float>(i0[a]));
        const float lo = __fsub_rn(0.5f, s);
        const float hi = __fadd_rn(0.5f, s);
        w3[0][a] = __fmul_rn(0.5f, __fmul_rn(lo, lo));
        w3[1][a] = __fsub_rn(0.75f, __fmul_rn(s, s));
        w3[2][a] = __fmul_rn(0.5f, __fmul_rn(hi, hi));
      }
#pragma unroll
      for (int corner = 0; corner < 27; ++corner) {
        float wc = w;
        long long flat = 0;
        int rest = corner;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const int o = rest % 3;
          rest /= 3;
          wc = __fmul_rn(wc, w3[o][a]);
          flat = flat * p.dims[a] + wrap(i0[a] + o - 1, p.dims[a]);
        }
        add(p.grid, flat, wc, p.scale);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
contrast_kernel(const long long* __restrict__ acc, float* __restrict__ out,
                long long cells, double inv_scale, double inv_mean) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < cells; i += stride) {
    const double m = __dmul_rn(static_cast<double>(acc[i]), inv_scale);
    out[i] = __double2float_rn(__dsub_rn(__dmul_rn(m, inv_mean), 1.0));
  }
}

unsigned grid_blocks(long long n) {
  const long long want = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(want < 132 * 64 ? (want > 0 ? want : 1)
                                               : 132 * 64);
}

}  // namespace

// pos: float32 (3, n) contiguous positions in length units; weights: float32
// (n,) or null (then every particle weighs w0); grid: int64 (nx, ny, nz),
// zeroed by the caller, accumulated in 2^-s units with scale = 2^s.
// order: 1 NGP, 2 CIC, 3 TSC.  Returns the CUDA error of the launch.
extern "C" int rf_paint(const void* pos, const void* weights, float w0,
                        long long n, int nx, int ny, int nz, float spacing,
                        float shift, double scale, int order, void* grid,
                        void* stream) {
  if (order < 1 || order > 3 || nx < 1 || ny < 1 || nz < 1 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const Args args{static_cast<const float*>(pos),
                  static_cast<const float*>(weights), w0, n, {nx, ny, nz},
                  spacing, shift, scale,
                  static_cast<unsigned long long*>(grid)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = grid_blocks(n);
  if (order == 1) {
    paint_kernel<1><<<blocks, kThreads, 0, st>>>(args);
  } else if (order == 2) {
    paint_kernel<2><<<blocks, kThreads, 0, st>>>(args);
  } else {
    paint_kernel<3><<<blocks, kThreads, 0, st>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

// acc: int64 (cells,) sums in units of 2^-s, inv_scale = 2^-s; out: float32
// (cells,) = (acc inv_scale) inv_mean - 1.  Returns the CUDA error.
extern "C" int rf_paint_contrast(const void* acc, void* out, long long cells,
                                 double inv_scale, double inv_mean,
                                 void* stream) {
  if (cells <= 0) return 0;
  contrast_kernel<<<grid_blocks(cells), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(acc), static_cast<float*>(out), cells,
      inv_scale, inv_mean);
  return static_cast<int>(cudaGetLastError());
}
