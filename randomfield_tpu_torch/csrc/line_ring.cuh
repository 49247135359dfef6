// The line staging that KB (bin_spectrum.cu) and KC (constraint_kernel.cu)
// share: a ring of shared-memory stages, each holding one tile of kTileRows
// whole kz lines (nzh = nz/2 + 1 floats a line) of up to four float32
// lattices, filled by the Tensor Memory Accelerator's 1-D bulk copy
// (cp.async.bulk) and an mbarrier a stage.
//
// A packed (rows, nzh) lattice is contiguous, so kTileRows = 4 lines from a
// line index that is a multiple of 4 are one span of 16 nzh bytes that
// starts 16-byte aligned (the lattice's base is): the bulk copy's rule.  The
// last tile of a lattice may hold fewer lines; its last (4 - n mod 4) mod 4
// floats, which the bulk copy cannot take, the issuing thread loads itself
// before it arrives on the stage's barrier (the arrive releases them, the
// wait acquires them).
//
// One thread issues, every thread waits.  A block walks its tiles in order:
// tile i goes to stage i mod S, and its copy is issued when tile i - S's
// stage has been read by every thread (a __syncthreads), so S - 1 tiles are
// in flight while the block works on one.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace rf {

constexpr int kTileRows = 4;
constexpr int kMaxRingArrays = 4;

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

struct LineRing {
  uint64_t* bars;  // one mbarrier a stage
  float* buf;      // stages x arrays x stride floats
  int stride;      // floats an array of a stage takes: 4 nzh, rounded up to 32
  int arrays, stages, nzh;
  long long rows;  // lines of each lattice

  // the floats a stage's array takes, 128-byte aligned
  static __host__ __device__ int stride_of(int nzh) {
    return (kTileRows * nzh + 31) / 32 * 32;
  }
  static __host__ __device__ size_t bytes(int arrays, int stages, int nzh) {
    return sizeof(float) * static_cast<size_t>(stride_of(nzh)) * arrays *
           stages;
  }

  __device__ float* stage(int s, int a) const {
    return buf + (static_cast<long long>(s) * arrays + a) * stride;
  }

  // Thread 0: the barriers, before a __syncthreads.
  __device__ void init() const {
    for (int s = 0; s < stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       shared_address(bars + s))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // Thread 0: copy the lines [row0, row0 + min(4, rows - row0)) of each
  // array src[a] into stage s.
  __device__ void issue(int s, const float* const* src,
                        long long row0) const {
    const long long nrows =
        rows - row0 < kTileRows ? rows - row0 : kTileRows;
    const long long n = nrows * nzh;  // floats an array
    const long long bulk = n & ~3LL;
    for (int a = 0; a < arrays; ++a) {
      for (long long j = bulk; j < n; ++j) {
        stage(s, a)[j] = src[a][row0 * nzh + j];
      }
    }
    const uint32_t bar = shared_address(bars + s);
    const uint32_t tx = static_cast<uint32_t>(4 * bulk * arrays);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                     "r"(bar),
                 "r"(tx)
                 : "memory");
    if (bulk > 0) {
      for (int a = 0; a < arrays; ++a) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];" ::"r"(shared_address(stage(s, a))),
            "l"(src[a] + row0 * nzh), "r"(static_cast<uint32_t>(4 * bulk)),
            "r"(bar)
            : "memory");
      }
    }
  }

  // Every thread: until the k-th fill of stage s (k = 0, 1, ...) landed.
  __device__ void wait(int s, int k) const {
    const uint32_t bar = shared_address(bars + s);
    const uint32_t parity = static_cast<uint32_t>(k & 1);
    uint32_t done = 0;
    do {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    } while (!done);
  }
};

// The tiles of a lattice of `rows` lines.
__host__ __device__ inline long long tile_count(long long rows) {
  return (rows + kTileRows - 1) / kTileRows;
}

// The blocks a persistent grid launches: the H100's 132 SMs times the
// blocks of `kernel` one SM holds with `smem` bytes of dynamic shared
// memory (at least 1), at most one a tile.  The SM count is a constant, not
// the card's, so the grid and with it the order of every sum depend on the
// shapes alone.
constexpr int kPersistentSMs = 132;

template <typename Kernel>
cudaError_t persistent_blocks(Kernel kernel, int threads, size_t smem,
                              long long tiles, int* blocks) {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  long long n = static_cast<long long>(kPersistentSMs) *
                (per_sm > 0 ? per_sm : 1);
  if (n > tiles) n = tiles;
  *blocks = static_cast<int>(n > 0 ? n : 1);
  return cudaSuccess;
}

}  // namespace rf
