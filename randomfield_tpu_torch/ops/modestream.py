"""The per-mode random stream of ``sampler='pallas'`` (K1 and K5).

The JAX package's fused sampler seeds the TPU's hardware PRNG per tile;
that stream cannot be replayed off the TPU (its interpreter even yields
zero bits).  The port defines its own counter-based stream instead, so
every mode's draw is a pure function of (seed, mode index):

* key: ``fold_in(key_from_seed(seed & 0x7FFFFFFF), STREAM_TAG)``, the JAX
  package's seed rule for this sampler (``pallas_sampler.py``,
  ``staged.py`` mask the seed to 31 bits) on JAX's Threefry key;
* counter: the flat 'xyz' mode index ``i = (x ny + y) nzh + kz`` as the
  two words ``(i >> 32, i & 0xFFFFFFFF)`` (64-bit: 2048^3 has more than
  2^32 modes);
* the two Threefry-2x32 output words are the mode's ``b1`` and ``b2``,
  the Box-Muller bits.

Because the counter is the mode index, the binned sampler (K5) draws
exactly the render sampler's (K1) numbers, so ``sample_power(seed)``
bins the realization ``generate_delta_field(seed)`` renders.
``STREAM_TAG`` is at least 2^31, so it never equals a canonical-stream
chunk index (``ops/sample.py:canonical_chunks``, at most 16): the two
samplers never share a key.
"""

from __future__ import annotations

import torch

from randomfield_tpu_torch.ops import threefry as _threefry

__all__ = ["STREAM", "STREAM_TAG", "SEED_MASK", "mode_key", "mode_bits"]

# the stream's name, as pallas_genfft.STREAM names the TPU's v6 stream
STREAM = "xyz-threefry2x32-mode-v1"
STREAM_TAG = 0xB1A55EED
SEED_MASK = 0x7FFFFFFF
_MASK = 0xFFFFFFFF


def mode_key(seed: int) -> tuple[int, int]:
    """The Threefry key of ``seed``'s mode stream, as two uint32 ints."""
    base = _threefry.key_from_seed(int(seed) & SEED_MASK)
    return _threefry.fold_in(base, STREAM_TAG)


def mode_bits(key, shape, x_off=0, nx_loc=None, device="cpu", y_off=0,
              ny_loc=None):
    """``(b1, b2)`` of the modes of x planes [x_off, x_off + nx_loc) and ky
    rows [y_off, y_off + ny_loc) (all rows by default).

    Int64 tensors of uint32 values, shaped (nx_loc, ny_loc, nz//2+1): the
    Threefry-2x32 hash under ``key`` of each mode's flat 'xyz' index in
    the whole (nx, ny, nz//2+1) spectrum, so a slab's bits are the
    matching slice of the whole grid's.
    """
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    nx_loc = nx - x_off if nx_loc is None else nx_loc
    ny_loc = ny - y_off if ny_loc is None else ny_loc
    xs = torch.arange(x_off, x_off + nx_loc, dtype=torch.int64, device=device)
    ys = torch.arange(y_off, y_off + ny_loc, dtype=torch.int64, device=device)
    zs = torch.arange(nzh, dtype=torch.int64, device=device)
    idx = ((xs[:, None] * ny + ys[None, :]) * nzh)[:, :, None] + zs
    b1, b2 = _threefry.threefry2x32(key, idx >> 32, idx & _MASK)
    return b1, b2
