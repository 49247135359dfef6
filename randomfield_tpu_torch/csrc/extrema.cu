// KX: lattice extrema over each voxel's periodic 27-cube, in two modes.
//
//   peaks: u = (sign delta) / sigma0 in float32 (a correctly rounded
//          division, as the JAX package forms u); a voxel is a peak iff u
//          is >= each of its 26 neighbours (u == max of its 27-cube,
//          non-strict); int64 counts of the peaks by height bin (the count
//          of float32 edges <= u, less 1, as searchsorted(side='right') - 1
//          gives; out-of-range heights in no bin) and the total, and on
//          request a uint8 mask, 1 where a peak has lo <= u < hi.  sign = -1
//          counts the minima (the peaks of -delta).
//   voids: key = rv - 1e-9 delta in float64 (each operand widened from
//          float32, the product and the difference rounded as numpy rounds
//          them); a candidate is a voxel with rv > 0 whose key is above
//          each of its 26 neighbours' (strict).  Their flat indices go out
//          through one atomic counter, the first ``cap`` of them written;
//          the caller sorts them, so the order does not matter.
//
// Replaces the XLA work of randomfield_tpu/validate/peaks.py:202 _cube_max
// and :212 _peak_bins (six rolled maxima, a one-hot count a bin; no Pallas
// kernel) and of randomfield_tpu/models/voids.py:287 find_voids' candidate
// test (26 rolled copies of a float64 host grid).  Neighbours are the
// periodic (x +- 1, y +- 1, z +- 1) of numpy's roll, so on an axis of 1 or
// 2 cells a voxel meets itself or one cell twice, as the rolls do.
//
// What bounds it on the H100: device-memory bytes, one read of delta a
// voxel in the peak mode (4.295 GB, 1.28 ms at 1024^3 and 3.35 TB/s; the
// mask adds a byte a voxel) and of rv and delta in the void mode (2.56
// ms).  Design: a block owns a (y, z) tile, 32 x 64 columns in the peak
// mode and 16 x 64 in the void mode (z fastest, so a warp loads whole
// lines; the periodic halo is 1.10x and 1.16x the tile), and walks a run
// of rx consecutive x planes (the host's ``ops/extrema.py:run_length``: 64
// on large grids) with one halo plane at each end, (rx + 2) / rx.  A step
// takes one halo plane.  Each of its cells is loaded from device memory
// once a block into a ring of raw planes in shared memory (cp.async, the
// next plane in flight), converted once (u, or the void key and
// rv > 0) by the thread that loaded it, and stored into one of two plane
// slots.  A thread owns 2 adjacent z of a few consecutive y (4 in the peak
// mode, 2 in the void mode); it reduces each plane once to the 3 x 3
// (y, z) maxima of its columns (two 8- or 16-byte shared loads a row give
// the 4 z its 2 columns span, so shared-memory instructions, not
// arithmetic, stay few), and a rolling window of three reduced planes in
// registers gives voxel x's 27-cube maximum from planes x - 1, x, x + 1.
// One __syncthreads a step: a slot is written two steps after its last
// read, with the barrier of the step between.  The maxima keep NaNs, as
// the rolled maxima do.  Bins are counted in shared memory (32-bit
// atomics), then one 64-bit global atomicAdd a bin a block: integer sums,
// so every call gives the same counts.
#include <cuda_runtime.h>

namespace {

constexpr int kTZ = 64;        // a tile's z columns
constexpr int kCols = 2;       // z columns a thread
constexpr int kThreads = 256;  // a block
constexpr int kHZ = kTZ + 2;
constexpr int kStages = 2;     // raw planes in the ring

// A walk's geometry: tiles of TY x kTZ columns, ROWS consecutive y a
// thread (a warp a group of rows), the halo plane and each thread's share
// of its loads.
template <int TY, int ROWS>
struct Walk {
  static constexpr int kTY = TY, kRows = ROWS;
  static constexpr int kHY = TY + 2;
  static constexpr int kPlane = kHY * kHZ;
  static constexpr int kLoads = (kPlane + kThreads - 1) / kThreads;
  static_assert(TY / ROWS * (kTZ / kCols) == kThreads, "a thread a slice");
};
using PeakWalk = Walk<32, 4>;  // 2244 halo cells a plane, 9 a thread
using VoidWalk = Walk<16, 2>;  // 1188, 5 a thread

// i mod n for i in [-1, n + tile]: two selects when n > tile, else a
// remainder
__device__ __forceinline__ int wrap(int i, int n, int tile) {
  if (n <= tile) {
    i %= n;
    return i < 0 ? i + n : i;
  }
  return i < 0 ? i + n : i >= n ? i - n : i;
}

// A thread stages the halo cells e = threadIdx.x + k kThreads, k < kLoads,
// of every plane (the last k only while e < kPlane).  Their (y, z)
// offsets in a plane are computed once, in 32 bits unless a plane holds
// 2^32 cells or more (Off); each plane adds its x row.
template <class W>
__device__ __forceinline__ bool cell_live(int k) {
  return k + 1 < W::kLoads || threadIdx.x + k * kThreads < W::kPlane;
}

template <class W, typename Off>
struct PlaneCells {
  Off yz[W::kLoads];
};

template <class W, typename Off>
__device__ __forceinline__ PlaneCells<W, Off> plane_cells(int y0, int z0,
                                                          int ny, int nz) {
  PlaneCells<W, Off> c;
#pragma unroll
  for (int k = 0; k < W::kLoads; ++k) {
    const int e = cell_live<W>(k) ? threadIdx.x + k * kThreads : 0;
    const int gy = wrap(y0 - 1 + e / kHZ, ny, W::kTY);
    const int gz = wrap(z0 - 1 + e % kHZ, nz, kTZ);
    c.yz[k] = static_cast<Off>(gy) * static_cast<Off>(nz) + gz;
  }
  return c;
}

// The raw planes in flight: a thread copies its own cells of halo plane s
// (grid plane x0 - 1 + s) into stage s % kStages of a ring in shared
// memory (cp.async, 4 bytes a cell, one commit group a plane, committed
// also past the run so every thread counts the same groups) and, kStages
// - 1 planes later, reads back only the cells it copied, so waiting for
// its own groups is enough.
__device__ __forceinline__ void copy_cell(float* dst, const float* src) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(at), "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit_plane() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// waits until the oldest plane in flight has landed (PER: commit groups
// a plane)
template <int PER>
__device__ __forceinline__ void wait_plane() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PER * (kStages - 1))
               : "memory");
}

// issues halo plane s of a run into its stage, if the run has it (plane:
// the cells of an x plane)
template <class W, typename Off>
__device__ __forceinline__ void fetch_plane(float* ring, const float* field,
                                            int s, int steps, int x0, int nx,
                                            long long plane,
                                            const PlaneCells<W, Off>& c) {
  if (s < steps) {
    const float* row = field + wrap(x0 - 1 + s, nx, 1) * plane;
    // keeps row + offset one wide multiply-add a cell
    asm("" : "+l"(row));
    float* stage = ring + (s % kStages) * W::kPlane + threadIdx.x;
#pragma unroll
    for (int k = 0; k < W::kLoads; ++k) {
      if (cell_live<W>(k)) copy_cell(stage + k * kThreads, row + c.yz[k]);
    }
  }
  commit_plane();
}

// Bit kCols j + c set where the thread's voxel (row j, column c) lies
// inside the grid: y + j < ny and z + c < nz.
template <class W>
__device__ __forceinline__ unsigned live_voxels(int y, int z, int ny, int nz) {
  unsigned live = 0u;
#pragma unroll
  for (int j = 0; j < W::kRows; ++j) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (y + j < ny && z + c < nz) live |= 1u << (kCols * j + c);
    }
  }
  return live;
}

// max that keeps a NaN, as jnp.maximum and np.maximum do (a NaN anywhere in
// a neighbourhood then fails every comparison against it): one FMNMX.NAN
// in float32
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ double nan_max(double a, double b) {
  return (a != a || a > b) ? a : b;
}

// The count of edges <= u, less 1 (edges ascending, n_edges of them).
__device__ __forceinline__ int edge_bin(const float* edges, int n_edges,
                                        float u) {
  int lo = 0, hi = n_edges;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (edges[mid] <= u) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo - 1;
}

struct PeakArgs {
  const float* delta;
  const float* edges;
  unsigned long long* counts;  // nbins + 1: the bins, then the total
  unsigned char* mask;         // nullptr: no mask
  int nx, ny, nz, nbins, rx;
  float sigma0, sign, lo, hi;
};

template <bool kMask, typename Off>
__global__ void __launch_bounds__(kThreads, 4)
peaks_kernel(const __grid_constant__ PeakArgs p) {
  using W = PeakWalk;
  constexpr int kRows = W::kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);  // kStages raw planes
  float* slots = ring + kStages * W::kPlane;     // two planes of u
  float* edges = slots + 2 * W::kPlane;
  unsigned int* bins = reinterpret_cast<unsigned int*>(edges + p.nbins + 1);
  const int z0 = blockIdx.x * kTZ, y0 = blockIdx.y * W::kTY;
  const int x0 = blockIdx.z * p.rx;
  const int steps = min(p.rx, p.nx - x0) + 2;
  const long long plane = static_cast<long long>(p.ny) * p.nz;
  const PlaneCells<W, Off> cells = plane_cells<W, Off>(y0, z0, p.ny, p.nz);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    fetch_plane(ring, p.delta, s, steps, x0, p.nx, plane, cells);
  }
  for (int i = threadIdx.x; i <= p.nbins; i += kThreads) {
    edges[i] = p.edges[i];
    bins[i] = 0u;
  }
  // (sign delta) / sigma0 is delta / (sign sigma0) in every rounding
  const float sigma = p.sign < 0.f ? -p.sigma0 : p.sigma0;
  // a warp a group of rows, a thread 2 adjacent z
  const int tz = threadIdx.x % 32 * kCols, ty = threadIdx.x / 32 * kRows;
  const unsigned live = live_voxels<W>(y0 + ty, z0 + tz, p.ny, p.nz);
  // the thread's first mask cell in plane x0
  unsigned char* mask =
      kMask ? p.mask + (x0 * plane + static_cast<long long>(y0 + ty) * p.nz +
                        z0 + tz)
            : nullptr;
  // the window: each column's 3 x 3 maxima of planes s - 2 and s - 1, and
  // its u in plane s - 1
  float m_prev[kRows][kCols] = {}, m_cur[kRows][kCols] = {};
  float u_cur[kRows][kCols] = {};
  for (int s = 0; s < steps; ++s) {
    fetch_plane(ring, p.delta, s + kStages - 1, steps, x0, p.nx, plane, cells);
    wait_plane<1>();
    const float* stage = ring + (s % kStages) * W::kPlane + threadIdx.x;
    float* slot = slots + (s & 1) * W::kPlane;
#pragma unroll
    for (int k = 0; k < W::kLoads; ++k) {
      if (cell_live<W>(k)) {
        slot[threadIdx.x + k * kThreads] =
            __fdiv_rn(stage[k * kThreads], sigma);
      }
    }
    __syncthreads();
    // the 3-wide z maxima of the thread's 2 columns in each of its halo
    // rows, from the 4 z they span (two 8-byte loads a row)
    float zmax[kRows + 2][kCols], u_new[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows + 2; ++r) {
      const float* row = slot + (ty + r) * kHZ + tz;
      const float2 a = *reinterpret_cast<const float2*>(row);
      const float2 b = *reinterpret_cast<const float2*>(row + 2);
      const float mid = nan_max(a.y, b.x);
      zmax[r][0] = nan_max(a.x, mid);
      zmax[r][1] = nan_max(mid, b.y);
      if (r >= 1 && r <= kRows) {
        u_new[r - 1][0] = a.y;
        u_new[r - 1][1] = b.x;
      }
    }
    float m_new[kRows][kCols];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        m_new[j][c] =
            nan_max(nan_max(zmax[j][c], zmax[j + 1][c]), zmax[j + 2][c]);
      }
    }
    if (s >= 2) {  // voxels of plane x0 + s - 2
      bool peak[kRows][kCols], any = false;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          peak[j][c] = (live >> (kCols * j + c) & 1u) &&
                       u_cur[j][c] >= nan_max(nan_max(m_prev[j][c],
                                                      m_cur[j][c]),
                                              m_new[j][c]);
          any = any || peak[j][c];
        }
      }
      if (any) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            if (peak[j][c]) {
              atomicAdd(&bins[p.nbins], 1u);
              const int b = edge_bin(edges, p.nbins + 1, u_cur[j][c]);
              if (b >= 0 && b < p.nbins) atomicAdd(&bins[b], 1u);
            }
          }
        }
      }
      if (kMask) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          unsigned char v[kCols];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            v[c] = peak[j][c] && u_cur[j][c] >= p.lo && u_cur[j][c] < p.hi;
          }
          unsigned char* at = mask + j * p.nz;
          if ((p.nz & 1) == 0) {  // both columns in or out, 2-byte aligned
            if (live >> (kCols * j) & 1u) {
              *reinterpret_cast<unsigned short*>(at) =
                  static_cast<unsigned short>(v[0] | v[1] << 8);
            }
          } else {
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              if (live >> (kCols * j + c) & 1u) at[c] = v[c];
            }
          }
        }
        mask += plane;
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        m_prev[j][c] = m_cur[j][c];
        m_cur[j][c] = m_new[j][c];
        u_cur[j][c] = u_new[j][c];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i <= p.nbins; i += kThreads) {
    if (bins[i]) atomicAdd(&p.counts[i], static_cast<unsigned long long>(bins[i]));
  }
}

struct VoidArgs {
  const float* rv;
  const float* delta;
  unsigned long long* found;  // the candidates seen (all of them)
  long long* index;           // the first ``cap`` candidates' flat indices
  long long cap;
  int nx, ny, nz, rx;
};

template <typename Off>
__global__ void __launch_bounds__(kThreads, 3)
voids_kernel(const __grid_constant__ VoidArgs p) {
  using W = VoidWalk;
  constexpr int kRows = W::kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring_rv = reinterpret_cast<float*>(smem);  // kStages raw planes each
  float* ring_delta = ring_rv + kStages * W::kPlane;
  double* slots =  // two planes of keys
      reinterpret_cast<double*>(ring_delta + kStages * W::kPlane);
  // rv > 0 of two planes, a cell's flag one byte after its index, so a
  // thread's 2 centres (halo z tz + 1, tz + 2) are one aligned 2-byte load
  unsigned char* pos = reinterpret_cast<unsigned char*>(slots + 2 * W::kPlane);
  const int z0 = blockIdx.x * kTZ, y0 = blockIdx.y * W::kTY;
  const int x0 = blockIdx.z * p.rx;
  const int steps = min(p.rx, p.nx - x0) + 2;
  const long long plane = static_cast<long long>(p.ny) * p.nz;
  const PlaneCells<W, Off> cells = plane_cells<W, Off>(y0, z0, p.ny, p.nz);
  auto fetch = [&](int s) {
    fetch_plane(ring_rv, p.rv, s, steps, x0, p.nx, plane, cells);
    fetch_plane(ring_delta, p.delta, s, steps, x0, p.nx, plane, cells);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);
  const int tz = threadIdx.x % 32 * kCols, ty = threadIdx.x / 32 * kRows;
  const unsigned live = live_voxels<W>(y0 + ty, z0 + tz, p.ny, p.nz);
  // the window: each column's full 3 x 3 maximum of plane s - 2, the
  // maximum of the 8 around it (ring), its key and rv > 0 in plane s - 1
  double full_prev[kRows][kCols] = {}, ring_cur[kRows][kCols] = {};
  double key_cur[kRows][kCols] = {};
  bool pos_cur[kRows][kCols] = {};
  for (int s = 0; s < steps; ++s) {
    fetch(s + kStages - 1);
    wait_plane<2>();  // rv and delta
    const int at = (s % kStages) * W::kPlane + threadIdx.x;
    double* slot = slots + (s & 1) * W::kPlane;
    unsigned char* slot_pos = pos + (s & 1) * W::kPlane;
#pragma unroll
    for (int k = 0; k < W::kLoads; ++k) {
      if (cell_live<W>(k)) {
        const int e = threadIdx.x + k * kThreads;
        const float r = ring_rv[at + k * kThreads];
        const float d = ring_delta[at + k * kThreads];
        slot[e] = __dsub_rn(static_cast<double>(r),
                            __dmul_rn(1e-9, static_cast<double>(d)));
        slot_pos[e + 1] = r > 0.f;
      }
    }
    __syncthreads();
    // per halo row, the 3-wide z maxima of the thread's 2 columns (zmax)
    // and the same without the centre (zpair), from the 4 z they span
    // (two 16-byte loads a row)
    double zmax[kRows + 2][kCols], zpair[kRows][kCols], key_new[kRows][kCols];
    bool pos_new[kRows][kCols];
#pragma unroll
    for (int q = 0; q < kRows + 2; ++q) {
      const int c = (ty + q) * kHZ + tz;
      const double2 a = *reinterpret_cast<const double2*>(slot + c);
      const double2 b = *reinterpret_cast<const double2*>(slot + c + 2);
      const double mid = nan_max(a.y, b.x);
      zmax[q][0] = nan_max(a.x, mid);
      zmax[q][1] = nan_max(mid, b.y);
      if (q >= 1 && q <= kRows) {
        zpair[q - 1][0] = nan_max(a.x, b.x);
        zpair[q - 1][1] = nan_max(a.y, b.y);
        key_new[q - 1][0] = a.y;
        key_new[q - 1][1] = b.x;
        const unsigned short two =
            *reinterpret_cast<const unsigned short*>(slot_pos + c + 2);
        pos_new[q - 1][0] = two & 0xffu;
        pos_new[q - 1][1] = two >> 8;
      }
    }
    if (s >= 2) {  // voxels of plane x0 + s - 2
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          if (!(live >> (kCols * j + c) & 1u) || !pos_cur[j][c]) continue;
          const double full_next = nan_max(
              nan_max(zmax[j][c], zmax[j + 1][c]), zmax[j + 2][c]);
          const double top =
              nan_max(nan_max(full_prev[j][c], ring_cur[j][c]), full_next);
          if (key_cur[j][c] > top) {
            const unsigned long long n = atomicAdd(p.found, 1ull);
            if (static_cast<long long>(n) < p.cap) {
              p.index[n] = (x0 + s - 2) * plane +
                           static_cast<long long>(y0 + ty + j) * p.nz + z0 +
                           tz + c;
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        full_prev[j][c] = nan_max(ring_cur[j][c], key_cur[j][c]);
        ring_cur[j][c] =
            nan_max(nan_max(zmax[j][c], zmax[j + 2][c]), zpair[j][c]);
        key_cur[j][c] = key_new[j][c];
        pos_cur[j][c] = pos_new[j][c];
      }
    }
  }
}

template <class W>
dim3 walk_grid(int nx, int ny, int nz, int rx) {
  return dim3((nz + kTZ - 1) / kTZ, (ny + W::kTY - 1) / W::kTY,
              (nx + rx - 1) / rx);
}

template <class W>
bool shape_ok(int nx, int ny, int nz, int rx) {
  return nx >= 1 && ny >= 1 && nz >= 1 && rx >= 1 && rx <= nx &&
         (ny + W::kTY - 1) / W::kTY <= 65535 && (nx + rx - 1) / rx <= 65535;
}

// 32-bit offsets in a plane while they fit
bool narrow(int ny, int nz) {
  return static_cast<unsigned long long>(ny) * nz <= 0xffffffffull;
}

size_t peak_smem(int nbins) {
  return sizeof(float) * ((kStages + 2) * PeakWalk::kPlane +
                          static_cast<size_t>(nbins) + 1) +
         sizeof(unsigned int) * (static_cast<size_t>(nbins) + 1);
}

constexpr size_t kVoidSmem = 2 * sizeof(float) * kStages * VoidWalk::kPlane +
                             (sizeof(double) + 1) * 2 * VoidWalk::kPlane + 2;

template <typename Args>
int launch(void (*kernel)(Args), const Args& args, dim3 grid, size_t smem,
           void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

void (*peak_instance(bool mask, bool narrow_off))(PeakArgs) {
  if (narrow_off) {
    return mask ? peaks_kernel<true, unsigned> : peaks_kernel<false, unsigned>;
  }
  return mask ? peaks_kernel<true, unsigned long long>
              : peaks_kernel<false, unsigned long long>;
}

void (*void_instance(bool narrow_off))(VoidArgs) {
  return narrow_off ? voids_kernel<unsigned> : voids_kernel<unsigned long long>;
}

}  // namespace

// Peak mode.  delta: float32 (nx, ny, nz), contiguous.  edges: float32
// (nbins + 1,) ascending.  counts: int64 (nbins + 1,), zeroed by the caller;
// the bins, then the total.  mask: uint8 (nx, ny, nz) or 0.  sigma0: the
// float32 divisor; sign: +1 (maxima) or -1 (minima); lo, hi: the mask's
// height band; rx: x planes a block walks; wide: 1 takes the 64-bit plane
// offsets whatever the shape (a check of that instance).  Returns the
// CUDA error of the launch.
extern "C" int rf_extrema_peaks(void* delta, void* edges, int nbins,
                                void* counts, void* mask, int nx, int ny,
                                int nz, float sigma0, float sign, float lo,
                                float hi, int rx, int wide, void* stream) {
  const size_t smem = peak_smem(nbins);
  if (!shape_ok<PeakWalk>(nx, ny, nz, rx) || nbins < 1 || smem > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PeakArgs args{static_cast<const float*>(delta),
                      static_cast<const float*>(edges),
                      static_cast<unsigned long long*>(counts),
                      static_cast<unsigned char*>(mask), nx, ny, nz, nbins,
                      rx, sigma0, sign, lo, hi};
  return launch(peak_instance(mask != nullptr, !wide && narrow(ny, nz)), args,
                walk_grid<PeakWalk>(nx, ny, nz, rx), smem, stream);
}

// Void mode.  rv, delta: float32 (nx, ny, nz), contiguous.  found: int64
// (1,), zeroed by the caller: the number of candidates.  index: int64
// (cap,): the first cap candidates' flat indices, in no order.  rx, wide:
// as for the peak mode.
extern "C" int rf_extrema_voids(void* rv, void* delta, void* found,
                                void* index, long long cap, int nx, int ny,
                                int nz, int rx, int wide, void* stream) {
  if (!shape_ok<VoidWalk>(nx, ny, nz, rx) || cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const VoidArgs args{static_cast<const float*>(rv),
                      static_cast<const float*>(delta),
                      static_cast<unsigned long long*>(found),
                      static_cast<long long*>(index), cap, nx, ny, nz, rx};
  return launch(void_instance(!wide && narrow(ny, nz)), args,
                walk_grid<VoidWalk>(nx, ny, nz, rx), kVoidSmem, stream);
}

// Registers a thread, blocks an SM, threads a block and dynamic shared
// memory of the instance a grid with 32-bit plane offsets runs: the peak
// mode's at nbins (voids = 0; with the mask when mask = 1) or the void
// mode's (voids = 1), as cudaFuncGetAttributes and
// cudaOccupancyMaxActiveBlocksPerMultiprocessor report them.
extern "C" int rf_extrema_attributes(int voids, int mask, int nbins,
                                     void* registers, void* blocks_per_sm,
                                     void* threads, void* smem) {
  const void* kernel =
      voids ? reinterpret_cast<const void*>(void_instance(true))
            : reinterpret_cast<const void*>(peak_instance(mask != 0, true));
  const size_t bytes = voids ? kVoidSmem : peak_smem(nbins);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kThreads, bytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *static_cast<int*>(registers) = attr.numRegs;
  *static_cast<int*>(blocks_per_sm) = blocks;
  *static_cast<int*>(threads) = kThreads;
  *static_cast<int*>(smem) = static_cast<int>(bytes);
  return 0;
}
