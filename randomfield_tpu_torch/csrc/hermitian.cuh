// The Hermitian fix of a self-conjugate kz plane (kz = 0, and kz = nz/2 for
// even nz), decided per mode in the thread: the partner selection that K2F
// and K7 (draw_scale.cu), K1 and K8 (sample_modes.cu) and K5
// (sample_power_bins.cu) share.  On such a plane c(kx, ky) = conj(c(-kx,
// -ky)); the mode at (x, y) has its partner at ((-x) mod nx, (-y) mod ny).
// Of each pair the member first in (x, then y) order is canonical and keeps
// its own draw; the other is the partner's draw with im negated; a mode that
// is its own partner (x and y each 0 or n/2) keeps re times sqrt(2) and
// im = 0.  The same selection as ops/grid.py:hermitian_plane_masks (and its
// host mirror ops/sampler.py:plane_partner).  The streams are counter-based,
// so a thread draws its partner's counter itself: no second pass, and on a
// slab mesh no exchange.
#pragma once

#include <cuda_runtime.h>

namespace rf {

// (-i) mod n for 0 <= i < n: the partner's row or column.
__device__ __forceinline__ int partner_index(int i, int n) {
  return i == 0 ? 0 : n - i;
}

// Whether (x, y) comes after its partner (px, py) in (x, then y) order: the
// mode that takes its partner's draw.
__device__ __forceinline__ bool not_canonical(int x, int y, int px, int py) {
  return x > px || (x == px && y > py);
}

// Whether (x, y) is its own partner.
__device__ __forceinline__ bool self_conjugate(int x, int y, int px, int py) {
  return x == px && y == py;
}

// sqrt(2) in float32, the factor of a self-conjugate mode.
constexpr float kSqrt2 = 0x1.6a09e6p+0f;

}  // namespace rf
