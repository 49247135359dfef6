"""The port's Threefry stream vs jax.random, and its canonical draws vs the
JAX package's (randomfield_tpu_torch.ops.threefry / ops.sample)."""

import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from randomfield_tpu.ops import sample as jsample  # noqa: E402
from randomfield_tpu_torch.ops import sample as tsample  # noqa: E402
from randomfield_tpu_torch.ops import threefry  # noqa: E402

SEEDS = [0, 3, 7, 2**31 - 1, 2**31 + 5, 2**40 + 5, -1]
# torch's log1p and the polynomial's rounding differ from XLA's by a few
# float32 ulps (measured <= 3); 4 ulps is also < 1e-6 relative
MAX_ULPS = 4


def _key(seed):
    return tuple(int(v) for v in jax.random.key_data(jax.random.key(seed)))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("seed", SEEDS)
def test_key_from_seed_matches_jax(seed):
    assert threefry.key_from_seed(seed) == _key(seed)


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 5])
@pytest.mark.parametrize("data", [0, 1, 15, 2**32 - 1])
def test_fold_in_matches_jax(seed, data):
    want = tuple(int(v) for v in jax.random.key_data(
        jax.random.fold_in(jax.random.key(seed), data)))
    assert threefry.fold_in(threefry.key_from_seed(seed), data) == want


@pytest.mark.smoke
@pytest.mark.parametrize("seed", [0, 7, -1])
@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 4, 9, 16)])
def test_random_bits_match_jax_exactly(seed, shape):
    want = np.asarray(jax.random.bits(jax.random.key(seed), shape, jnp.uint32))
    got = threefry.random_bits(threefry.key_from_seed(seed), shape).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
@pytest.mark.parametrize("shape", [(2, 4, 9, 16), (2, 16, 33, 64)])
def test_normal_matches_jax_to_ulps(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape, jnp.float32))
    got = threefry.normal(threefry.key_from_seed(seed), shape).numpy()
    assert _ulps(got, want) <= MAX_ULPS
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@jax.jit
def _jax_normal_of_bits(bits):
    """jax.random.normal's float32 value of uint32 ``bits``: the steps of
    jax.random._uniform (the mantissa trick on [nextafter(-1, 0), 1)) and
    _normal_real (sqrt(2) erf_inv), as XLA compiles them."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    word = jax.lax.shift_right_logical(bits, jnp.uint32(9)) | jnp.uint32(
        0x3F800000)
    f = jax.lax.bitcast_convert_type(word, jnp.float32) - jnp.float32(1.0)
    u = jax.lax.max(jnp.float32(lo), f * (jnp.float32(1.0) - lo) + lo)
    return jnp.float32(np.sqrt(2.0)) * jax.lax.erf_inv(u)


@pytest.mark.parametrize("seed", [0, 7])
def test_normal_of_bits_is_jax_random_normal(seed):
    key = jax.random.key(seed)
    bits = jax.random.bits(key, (4096,), jnp.uint32)
    want = np.asarray(jax.random.normal(key, (4096,), jnp.float32))
    np.testing.assert_array_equal(np.asarray(_jax_normal_of_bits(bits)), want)


def test_normal_of_every_mantissa_matches_jax():
    # a normal reads only bits >> 9: all 2^23 inputs, erfinv's tail (|u| >=
    # 0.99663) included, are these words
    worst = 0
    for lo in range(0, 2**23, 2**21):
        v = np.arange(lo, lo + 2**21, dtype=np.uint32) << np.uint32(9)
        want = np.asarray(_jax_normal_of_bits(jnp.asarray(v)))
        got = threefry._normal_from_bits(torch.from_numpy(v.astype(np.int64)))
        worst = max(worst, _ulps(got.numpy(), want))
    assert worst <= MAX_ULPS


@pytest.mark.parametrize("seed", [0, 7])
def test_normal_exact_equals_jax_on_every_draw(seed):
    # XLA's erf_inv operation for operation, each multiply-add rounded once
    # and the tail's square root (w >= 5, |u| > 0.99663) correctly rounded:
    # equal to jax.random.normal on all 2^22 draws, about 14,000 of them in
    # the tail
    shape = (1 << 22,)
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape,
                                        jnp.float32))
    got = threefry.normal_exact(threefry.key_from_seed(seed), shape).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(8, 8, 8), (12, 6, 10), (32, 16, 9)])
def test_unit_draws_reim_match_jax(shape):
    want_re, want_im = jsample.unit_draws_reim(jax.random.key(3), shape)
    got_re, got_im = tsample.unit_draws_reim(threefry.key_from_seed(3), shape)
    assert got_re.shape == (shape[0], shape[1], shape[2] // 2 + 1)
    for got, want in ((got_re, want_re), (got_im, want_im)):
        assert _ulps(got.numpy(), want) <= MAX_ULPS
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("nx", [8, 12, 48, 100, 7, 1024])
def test_canonical_chunks_match_jax(nx):
    assert tsample.canonical_chunks(nx) == jsample.canonical_chunks(nx)
