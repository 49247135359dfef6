"""JAX's Threefry-2x32 random stream, bit for bit, on torch tensors.

The port draws the same numbers as ``jax.random`` so that every render can
be held to the JAX package at the same seed.  This module reproduces what
JAX 0.9 computes with ``jax_threefry_partitionable`` on (its default):

* a seed becomes the key ``[0, seed & 0xFFFFFFFF]`` (``jax.random.key``
  in 32-bit mode, then ``jax._src.prng.threefry_seed``);
* ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``
  (``prng._threefry_fold_in``), and ``split(key, n)[i]`` hashes the
  counter words ``(0, i)`` as well (``prng._threefry_split_foldlike`` over
  the flat index of an (n,) array), so it equals ``fold_in(key, i)``;
* ``random_bits(key, shape)`` hashes the flat element index ``i``, split
  into ``(i >> 32, i & 0xFFFFFFFF)``, and returns ``bits1 ^ bits2``
  (``prng._threefry_random_bits_partitionable``);
* ``normal(key, shape)`` maps those bits to a uniform on
  ``[nextafter(-1, 0), 1)`` through the mantissa trick of
  ``random._uniform`` and returns ``sqrt(2) * erfinv(u)``
  (``random._normal_real``), with ``erfinv`` evaluated by the same
  single-precision polynomial (Giles 2010) that XLA lowers ``erf_inv`` to.

The bits are exact.  The normals agree to a few float32 ulps (``log1p``
and the rounding of the polynomial's multiply-adds differ between
libraries); ``torch.erfinv`` itself would differ by up to ~90 ulps in the
tails.

torch's uint32 lacks most operators, so words live in int64 tensors masked
to 32 bits.  Keys are pairs of Python ints.  This is plain PyTorch, as the
JAX package leaves Threefry to XLA.  On the card the default render draws
the same stream inside the fused sigma-scale kernel (``csrc/draw_scale.cu``
through ``ops/sampler.py:draw_scale``; the device functions are
``csrc/threefry.cuh:jax_bits`` and ``jax_normal``, which repeat the float32
operations below in their order); this module is that kernel's plain
version and the CPU path.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["key_from_seed", "as_key", "split", "fold_in", "threefry2x32",
           "random_bits",
           "bits_at", "normal", "normal_at", "normal_exact"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# random._normal_real: the uniform's open lower end and its width, in float32
_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))
_WIDTH = np.float32(1.0) - _LO
_SQRT2 = np.float32(np.sqrt(2.0))
# XLA's ErfInv32 (Giles' approximation): coefficients for w < 5 and w >= 5
_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def key_from_seed(seed: int) -> tuple[int, int]:
    """The key ``jax.random.key(seed)`` holds, as two uint32 ints.

    JAX runs in its default 32-bit mode, where the seed is cut to its low
    32 bits before the key is made: the key is ``(0, seed mod 2**32)``.
    """
    seed = int(np.int64(int(seed)))  # raises OverflowError beyond int64, as JAX
    return (0, seed & _MASK)


def as_key(seed_or_key) -> tuple[int, int]:
    """The key of a seed (:func:`key_from_seed`), or a key pair (two uint32
    ints, e.g. from :func:`split`) as it is."""
    if isinstance(seed_or_key, (tuple, list)):
        if len(seed_or_key) != 2:
            raise ValueError(f"a Threefry key is two uint32 words, got "
                             f"{seed_or_key!r}")
        return (int(seed_or_key[0]) & _MASK, int(seed_or_key[1]) & _MASK)
    return key_from_seed(seed_or_key)


def split(key, n: int = 2) -> list[tuple[int, int]]:
    """``jax.random.key_data(jax.random.split(key, n))`` as ``n`` key pairs:
    key i is the hash of the counter words (0, i)."""
    return [threefry2x32(key, 0, i) for i in range(int(n))]


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key, x0, x1):
    """The 20-round Threefry-2x32 hash of counter words ``(x0, x1)``.

    ``key`` is a pair of ints; ``x0``/``x1`` are ints or int64 tensors of
    uint32 values.  Returns the two output words in the same form.
    """
    k1, k2 = key
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def fold_in(key, data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``."""
    return threefry2x32(key, 0, int(data) & _MASK)


def bits_at(key, idx: torch.Tensor) -> torch.Tensor:
    """The bits ``jax.random.bits(key, shape)`` holds at the flat indices
    ``idx`` (an int64 tensor) of its ``shape``: a pure function of the
    index, so any block of an array can be drawn on its own."""
    b1, b2 = threefry2x32(key, idx >> 32, idx & _MASK)
    return b1 ^ b2


def random_bits(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape)`` as an int64 tensor of uint32 values."""
    n = math.prod(shape)
    return bits_at(key, torch.arange(n, dtype=torch.int64,
                                     device=device)).reshape(shape)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """erfinv of float32 ``x`` in (-1, 1) as XLA evaluates it."""
    w = -torch.log1p(-x * x)
    central = w < 5.0
    w = torch.where(central, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for a, b in zip(_ERFINV_CENTRAL, _ERFINV_TAIL):
        c = torch.where(central, a, b)
        p = c if p is None else c + p * w
    return p * x


def normal(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` (to a few ulps)."""
    return _normal_from_bits(random_bits(key, shape, device))


def normal_at(key, idx: torch.Tensor) -> torch.Tensor:
    """The values of ``jax.random.normal(key, shape, float32)`` at the flat
    indices ``idx`` of its ``shape`` (:func:`bits_at`), shaped as ``idx``."""
    return _normal_from_bits(bits_at(key, idx))


def _normal_from_bits(bits):
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    u = mant.view(torch.float32) - 1.0
    u = torch.clamp_min(u * float(_WIDTH) + float(_LO), float(_LO))
    return _erfinv(u) * float(_SQRT2)


def normal_exact(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` with XLA's CPU erfinv
    repeated operation for operation (:func:`.xla_math.xla_erfinv`: its
    log1p and fused multiply-adds), not the single-precision evaluation of
    :func:`normal` that the render kernels share.  Equal to JAX's CPU
    normals except about 1.4e-5 of them, in the tail |u| > 0.9968, one ulp
    apart."""
    from randomfield_tpu_torch.ops.xla_math import xla_erfinv

    bits = random_bits(key, shape, device)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    u = mant.view(torch.float32) - 1.0
    u = torch.clamp_min(u * float(_WIDTH) + float(_LO), float(_LO))
    return xla_erfinv(u) * float(_SQRT2)
