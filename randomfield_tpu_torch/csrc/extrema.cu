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
// ms).  Design: a block takes an 8 x 8 x 32 tile (z fastest, a warp on 32
// consecutive z) and stages it with its one-voxel periodic halo in shared
// memory (10 x 10 x 34 entries: u in float32, or the key in float64), so
// each value is read from device memory once a tile (the halo's 1.66x of
// the tile's reads mostly hit L2).  A thread loads its entries of all 10
// halo planes into registers before it divides or stores any, so each has
// its 10 (or 20) loads in flight at once.  A thread takes a (y, z) column of the
// tile's 8 x planes: it reduces each of the 10 halo planes over the 3 x 3
// (y, z) around its column once, in registers, so a voxel's 27-cube is the
// maximum of three plane values (9 shared reads a plane, not 26 a voxel).
// The maxima keep NaNs, as the rolled maxima do.
// Bins are counted in shared memory (32-bit atomics), then one 64-bit
// global atomicAdd a bin a block: integer sums, so every call gives the
// same counts.
#include <cuda_runtime.h>

namespace {

constexpr int kTX = 8, kTY = 8, kTZ = 32;
constexpr int kHX = kTX + 2, kHY = kTY + 2, kHZ = kTZ + 2;
constexpr int kHalo = kHX * kHY * kHZ;
constexpr int kThreads = kTY * kTZ;  // a thread a (y, z), all 8 x planes

// i mod n for i in [-1, n + tile]: two selects when n > tile, else a
// remainder
__device__ __forceinline__ int wrap(int i, int n, int tile) {
  if (n <= tile) {
    i %= n;
    return i < 0 ? i + n : i;
  }
  return i < 0 ? i + n : i >= n ? i - n : i;
}

// A thread stages two entries of each halo x plane's 10 x 34 (y, z) cells:
// e = threadIdx.x and e + 256 (only the first 84 threads have a second).
// Their (y, z) offsets in the grid are computed once; each plane adds its
// wrapped x row, so a block issues its 10 planes' loads back to back.
constexpr int kPlane = kHY * kHZ;

struct HaloCells {
  long long yz[2];
  bool second;
};

__device__ __forceinline__ HaloCells halo_cells(int y0, int z0, int ny,
                                                int nz) {
  HaloCells c;
  c.second = threadIdx.x + kThreads < kPlane;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int e = k == 0 ? threadIdx.x : (c.second ? threadIdx.x + kThreads : 0);
    const int gy = wrap(y0 - 1 + e / kHZ, ny, kTY);
    const int gz = wrap(z0 - 1 + e % kHZ, nz, kTZ);
    c.yz[k] = static_cast<long long>(gy) * nz + gz;
  }
  return c;
}

// The first element of halo x plane hx's row in the grid.
__device__ __forceinline__ long long halo_row(int hx, int x0, int nx, int ny,
                                              int nz) {
  return static_cast<long long>(wrap(x0 - 1 + hx, nx, kTX)) * ny * nz;
}

// max that keeps a NaN, as jnp.maximum and np.maximum do (a NaN anywhere in
// a neighbourhood then fails every comparison against it)
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ int sidx(int hx, int hy, int hz) {
  return (hx * kHY + hy) * kHZ + hz;
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
  int nx, ny, nz, nbins;
  float sigma0, sign, lo, hi;
};

__global__ void __launch_bounds__(kThreads)
peaks_kernel(const PeakArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);
  float* edges = tile + kHalo;
  unsigned int* bins = reinterpret_cast<unsigned int*>(edges + p.nbins + 1);
  const int z0 = blockIdx.x * kTZ, y0 = blockIdx.y * kTY, x0 = blockIdx.z * kTX;
  for (int i = threadIdx.x; i <= p.nbins; i += kThreads) {
    edges[i] = p.edges[i];
    bins[i] = 0u;
  }
  {
    const HaloCells c = halo_cells(y0, z0, p.ny, p.nz);
    float v[kHX][2];
#pragma unroll
    for (int hx = 0; hx < kHX; ++hx) {
      const float* row = p.delta + halo_row(hx, x0, p.nx, p.ny, p.nz);
      v[hx][0] = row[c.yz[0]];
      v[hx][1] = c.second ? row[c.yz[1]] : 0.f;
    }
#pragma unroll
    for (int hx = 0; hx < kHX; ++hx) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (k == 0 || c.second) {
          const float d = v[hx][k];
          tile[hx * kPlane + threadIdx.x + k * kThreads] =
              __fdiv_rn(p.sign < 0.f ? -d : d, p.sigma0);
        }
      }
    }
  }
  __syncthreads();

  const int lz = threadIdx.x % kTZ, ly = threadIdx.x / kTZ;
  const int y = y0 + ly, z = z0 + lz;
  if (y < p.ny && z < p.nz) {
    // each halo x plane's maximum over the 3 x 3 (y, z) around the thread's
    // column, then a voxel's 27-cube maximum is that of three planes
    float m[kHX];
#pragma unroll
    for (int hx = 0; hx < kHX; ++hx) {
      float v = tile[sidx(hx, ly, lz)];
#pragma unroll
      for (int k = 1; k < 9; ++k) {
        v = nan_max(v, tile[sidx(hx, ly + k / 3, lz + k % 3)]);
      }
      m[hx] = v;
    }
#pragma unroll
    for (int lx = 0; lx < kTX; ++lx) {
      if (x0 + lx >= p.nx) break;
      const float u = tile[sidx(lx + 1, ly + 1, lz + 1)];
      const bool peak = u >= nan_max(nan_max(m[lx], m[lx + 1]), m[lx + 2]);
      if (peak) {
        atomicAdd(&bins[p.nbins], 1u);
        const int b = edge_bin(edges, p.nbins + 1, u);
        if (b >= 0 && b < p.nbins) atomicAdd(&bins[b], 1u);
      }
      if (p.mask != nullptr) {
        const long long at =
            (static_cast<long long>(x0 + lx) * p.ny + y) * p.nz + z;
        p.mask[at] = peak && u >= p.lo && u < p.hi;
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
  int nx, ny, nz;
};

__global__ void __launch_bounds__(kThreads)
voids_kernel(const VoidArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* key = reinterpret_cast<double*>(smem);
  float* rv = reinterpret_cast<float*>(key + kHalo);
  const int z0 = blockIdx.x * kTZ, y0 = blockIdx.y * kTY, x0 = blockIdx.z * kTX;
  {
    const HaloCells c = halo_cells(y0, z0, p.ny, p.nz);
    float r[kHX][2], d[kHX][2];
#pragma unroll
    for (int hx = 0; hx < kHX; ++hx) {
      const long long row = halo_row(hx, x0, p.nx, p.ny, p.nz);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const bool live = k == 0 || c.second;
        r[hx][k] = live ? p.rv[row + c.yz[k]] : 0.f;
        d[hx][k] = live ? p.delta[row + c.yz[k]] : 0.f;
      }
    }
#pragma unroll
    for (int hx = 0; hx < kHX; ++hx) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (k == 0 || c.second) {
          const int h = hx * kPlane + threadIdx.x + k * kThreads;
          rv[h] = r[hx][k];
          key[h] = __dsub_rn(static_cast<double>(r[hx][k]),
                             __dmul_rn(1e-9, static_cast<double>(d[hx][k])));
        }
      }
    }
  }
  __syncthreads();

  const int lz = threadIdx.x % kTZ, ly = threadIdx.x / kTZ;
  const int y = y0 + ly, z = z0 + lz;
  if (y >= p.ny || z >= p.nz) return;
  // each halo x plane's maximum over the 8 (y, z) neighbours of the
  // thread's column (ring) and with its own cell (full); a voxel's 26
  // neighbours are the full planes beside it and the ring of its own
  double ring[kHX], full[kHX];
#pragma unroll
  for (int hx = 0; hx < kHX; ++hx) {
    double v = key[sidx(hx, ly, lz)];
#pragma unroll
    for (int k = 1; k < 9; ++k) {
      if (k != 4) v = nan_max(v, key[sidx(hx, ly + k / 3, lz + k % 3)]);
    }
    ring[hx] = v;
    full[hx] = nan_max(v, key[sidx(hx, ly + 1, lz + 1)]);
  }
#pragma unroll
  for (int lx = 0; lx < kTX; ++lx) {
    if (x0 + lx >= p.nx) break;
    const int c = sidx(lx + 1, ly + 1, lz + 1);
    if (!(rv[c] > 0.f)) continue;
    const double top = nan_max(nan_max(full[lx], ring[lx + 1]), full[lx + 2]);
    if (key[c] > top) {
      const unsigned long long slot = atomicAdd(p.found, 1ull);
      if (static_cast<long long>(slot) < p.cap) {
        p.index[slot] = (static_cast<long long>(x0 + lx) * p.ny + y) * p.nz + z;
      }
    }
  }
}

dim3 tile_grid(int nx, int ny, int nz) {
  return dim3((nz + kTZ - 1) / kTZ, (ny + kTY - 1) / kTY, (nx + kTX - 1) / kTX);
}

bool shape_ok(int nx, int ny, int nz) {
  return nx >= 1 && ny >= 1 && nz >= 1 && (nx + kTX - 1) / kTX <= 65535 &&
         (ny + kTY - 1) / kTY <= 65535;
}

}  // namespace

// Peak mode.  delta: float32 (nx, ny, nz), contiguous.  edges: float32
// (nbins + 1,) ascending.  counts: int64 (nbins + 1,), zeroed by the caller;
// the bins, then the total.  mask: uint8 (nx, ny, nz) or 0.  sigma0: the
// float32 divisor; sign: +1 (maxima) or -1 (minima); lo, hi: the mask's
// height band.  Returns the CUDA error of the launch.
extern "C" int rf_extrema_peaks(void* delta, void* edges, int nbins,
                                void* counts, void* mask, int nx, int ny,
                                int nz, float sigma0, float sign, float lo,
                                float hi, void* stream) {
  const size_t smem = sizeof(float) * (kHalo + static_cast<size_t>(nbins) + 1) +
                      sizeof(unsigned int) * (static_cast<size_t>(nbins) + 1);
  if (!shape_ok(nx, ny, nz) || nbins < 1 || smem > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        peaks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const PeakArgs args{static_cast<const float*>(delta),
                      static_cast<const float*>(edges),
                      static_cast<unsigned long long*>(counts),
                      static_cast<unsigned char*>(mask), nx, ny, nz, nbins,
                      sigma0, sign, lo, hi};
  peaks_kernel<<<tile_grid(nx, ny, nz), kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// Void mode.  rv, delta: float32 (nx, ny, nz), contiguous.  found: int64
// (1,), zeroed by the caller: the number of candidates.  index: int64
// (cap,): the first cap candidates' flat indices, in no order.
extern "C" int rf_extrema_voids(void* rv, void* delta, void* found,
                                void* index, long long cap, int nx, int ny,
                                int nz, void* stream) {
  if (!shape_ok(nx, ny, nz) || cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (sizeof(double) + sizeof(float)) * kHalo;
  const VoidArgs args{static_cast<const float*>(rv),
                      static_cast<const float*>(delta),
                      static_cast<unsigned long long*>(found),
                      static_cast<long long*>(index), cap, nx, ny, nz};
  voids_kernel<<<tile_grid(nx, ny, nz), kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
