"""KH's plain version (ops/poisson.py) and XLA's CPU functions
(ops/xla_math.py) against JAX.

(a) xla_log on every fourth float32 uniform and a wide sample, xla_exp,
    xla_lgamma on integers and reals, xla_log1p: bit for bit against jnp.log,
    jnp.exp, jax.lax.lgamma, jnp.log1p (the log of every uniform <= 0 is
    what lets a Knuth walk stop at its first sum <= -lambda);
(b) poisson_plain against jax.random.poisson at lambda in {0, 1e-3, 0.3,
    3, 9.99, 10, 40, 1e3} on 4096 cells, three keys each, and on grids
    mixing both branches, NaN and 0 (the rejection loop's global count),
    whole and in chunks: equal on every cell (no float32 tie occurs
    here: every log, exp and lgamma is XLA's own to the bit);
(c) the kernel's key table and the chain it derives past the table, the
    intensity forms, and the refusals;
(d) xla_math._fma rounds once, as XLA's fused multiply-add and the
    kernel's __fmaf_rn do: equal to jax.jit(a * b + c) on (1 + 2^-23,
    1 - 2^-23, 16777218), where a float64 sum rounded twice gives
    16777220, and on 4096 searched triples where the two roundings differ;
    equal to an exact fractions.Fraction rounding on 10^5 random triples.
"""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from randomfield_tpu_torch.ops import poisson as kh  # noqa: E402
from randomfield_tpu_torch.ops import threefry  # noqa: E402
from randomfield_tpu_torch.ops import xla_math  # noqa: E402

LAMBDAS = (0.0, 1e-3, 0.3, 3.0, 9.99, 10.0, 40.0, 1e3)
GRID = (64, 64)
SEEDS = (0, 1, 2)


def _all_uniforms():
    """Every float32 value jax.random.uniform can return."""
    bits = np.arange(2**23, dtype=np.uint32) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def _reference(fn, x):
    return np.asarray(jax.jit(fn)(x))


@pytest.mark.parametrize("name", ["log", "exp", "lgamma", "log1p"])
def test_xla_functions_bit_for_bit(name):
    rng = np.random.default_rng(3)
    if name == "log":
        u = _all_uniforms()[::4]
        x = np.concatenate([u, rng.integers(0x30000000, 0x48000000, 2**19)
                            .astype(np.uint32).view(np.float32),
                            np.float32([0.0, -1.0, np.inf])])
        got = xla_math.xla_log(torch.from_numpy(x)).numpy()
        assert float(got[1:u.size].max()) < 0.0  # log u < 0 for u in (0, 1)
        want = _reference(jnp.log, x)
    elif name == "exp":
        x = rng.uniform(-87.0, 88.0, 2**21).astype(np.float32)
        got, want = xla_math.xla_exp(torch.from_numpy(x)).numpy(), \
            _reference(jnp.exp, x)
    elif name == "lgamma":
        x = np.concatenate([np.arange(1, 2**18, dtype=np.float32),
                            rng.uniform(0.5, 1e4, 2**19).astype(np.float32)])
        got = xla_math.xla_lgamma(torch.from_numpy(x)).numpy()
        want = _reference(jax.lax.lgamma, x)
    else:
        x = rng.uniform(-0.9, 50.0, 2**20).astype(np.float32)
        got = xla_math.xla_log1p(torch.from_numpy(x)).numpy()
        want = _reference(jnp.log1p, x)
    np.testing.assert_array_equal(got, want)


def _jax_poisson(seed, lam):
    return np.asarray(jax.random.poisson(jax.random.key(seed), lam,
                                         dtype=jnp.int32))


@pytest.mark.parametrize("lam", LAMBDAS)
def test_poisson_plain_equals_jax(lam):
    lamv = np.full(GRID, lam, np.float32)
    for seed in SEEDS:
        got = kh.poisson_plain(threefry.key_from_seed(seed),
                               torch.from_numpy(lamv)).numpy()
        np.testing.assert_array_equal(got, _jax_poisson(seed, lamv))
        assert got.dtype == np.int32


def _mixed(seed):
    rng = np.random.default_rng(seed)
    lam = rng.uniform(0.0, 30.0, GRID).astype(np.float32)
    lam[0, :6] = [0.0, np.nan, 9.999999, 10.0, 1e4, 1e-30]
    lam[1:4] = rng.uniform(0.0, 2.0, (3, GRID[1]))
    return lam


@pytest.mark.parametrize("seed", SEEDS)
def test_poisson_plain_mixed_grid_equals_jax(seed):
    # lambda < 10 and >= 10 together: the rejection loop's global count
    # decides the >= 10 cells, whole or in chunks
    lam = _mixed(seed)
    want = _jax_poisson(seed + 10, lam)
    key = threefry.key_from_seed(seed + 10)
    for chunk in (1 << 24, 1000, 4096 // 3):
        got = kh.poisson_plain(key, torch.from_numpy(lam), chunk=chunk)
        np.testing.assert_array_equal(got.numpy(), want)


def _chain(key, table, width, iters):
    """The subkeys csrc/poisson.cu's Chain::at yields for iterations 0..
    iters - 1 from one bin's row of key_tables (Knuth: width 2, one
    subkey; rejection: width 4, two), the table first, then derived from
    the chain key after it."""
    row = kh.key_tables([key], table)[0].view(np.uint32)
    start = 0 if width == 2 else 2 * table + 2
    row = row[start:]
    nsub = width // 2
    out, rng = [], None
    for i in range(iters):
        if i < table:
            out.append(tuple((int(row[i * width + 2 * s]),
                              int(row[i * width + 2 * s + 1]))
                             for s in range(nsub)))
            continue
        if i == table:
            rng = (int(row[table * width]), int(row[table * width + 1]))
        out.append(tuple(threefry.threefry2x32(rng, 0, s + 1)
                         for s in range(nsub)))
        rng = threefry.threefry2x32(rng, 0, 0)
    return out


@pytest.mark.parametrize("table", [0, 3, kh.TABLE])
def test_key_table_and_derived_chain(table):
    key = threefry.fold_in(threefry.key_from_seed(7), 0x48414C4F)
    iters = kh.TABLE + 5
    rng, want = key, []
    for _ in range(iters):
        rng, sub = threefry.split(rng)
        want.append((sub,))
    assert _chain(key, table, 2, iters) == want
    rng, want = key, []
    for _ in range(iters):
        rng, s0, s1 = threefry.split(rng, 3)
        want.append((s0, s1))
    assert _chain(key, table, 4, iters) == want
    assert kh.key_tables([key, key], table).shape == (2, 6 * table + 4)


def test_counts_refuse_a_negative_key_table():
    g = torch.zeros((4, 4, 4))
    with pytest.raises(ValueError, match="table"):
        kh.poisson_counts(g, [threefry.key_from_seed(1)], "linear", table=-1)


def test_intensity_forms_and_counts_plain():
    rng = np.random.default_rng(5)
    g = rng.normal(0.0, 1.2, (8, 16, 16)).astype(np.float32)
    lam0, bias, sig2 = np.array([0.02, 0.3, 4.0]), np.array([1.1, 1.8, 3.5]), \
        1.44
    keys = [threefry.key_from_seed(s) for s in (1, 2, 3)]
    got = kh.poisson_counts(torch.from_numpy(g), keys, "lognormal", lam0=lam0,
                            bias=bias, sigma_g2=sig2)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 8, 16, 16)
    l0, b, c = kh.lognormal_constants(lam0, bias, sig2)
    # the JAX package's scan body on the same float32 scalars, compiled once
    body = jax.jit(lambda x, l0, bb: l0 * jnp.exp(
        bb * x - np.float32(0.5) * bb * bb * np.float32(sig2)))
    for i in range(3):
        lam = body(g, l0[i], b[i])
        mine = kh.intensity(torch.from_numpy(g), "lognormal", i, lam0, bias,
                            sig2)
        np.testing.assert_array_equal(mine.numpy(), np.asarray(lam))
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(jax.random.poisson(
                jax.random.key(i + 1), lam, dtype=jnp.int32)))
    lin = kh.poisson_counts(torch.from_numpy(g), [keys[0]], "linear",
                            scale=2.5)
    want = jax.random.poisson(jax.random.key(1), jnp.maximum(
        (1.0 + g) * np.float32(2.5), 0.0), dtype=jnp.int32)
    np.testing.assert_array_equal(lin[0].numpy(), np.asarray(want))


def test_refusals():
    g = torch.zeros(4, 4, 4)
    with pytest.raises(ValueError):
        kh.poisson_counts(g, [1], "cubic")
    with pytest.raises(ValueError):
        kh.poisson_counts(g, [1, 2], "linear", scale=1.0)
    with pytest.raises(ValueError):
        kh.poisson_counts(g, [1, 2], "lognormal", lam0=[1.0], bias=[1.0, 2.0])
    with pytest.raises(ValueError):
        kh.poisson_counts(g.double(), [1], "linear")
    with pytest.raises(ValueError):
        kh.poisson_counts(g, [1], "linear", out=torch.zeros(1, 4, 4, 4))


def _twice_rounded(a, b, c):
    """a b + c as a float64 sum rounded to float64, then to float32."""
    a, b, c = (torch.from_numpy(v).double() for v in (a, b, c))
    return (a * b + c).float().numpy()


def _fma(a, b, c):
    return xla_math._fma(*(torch.from_numpy(v) for v in (a, b, c))).numpy()


def _xla_fma(a, b, c):
    return np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))


def _fraction_rounded(a, b, c):
    """float32 of the exact a b + c, ties to even (Fraction arithmetic)."""
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    if x == 0:
        return 0.0
    num, den = abs(x.numerator), x.denominator
    e = num.bit_length() - den.bit_length()
    if (num < den << e) if e >= 0 else (num << -e < den):
        e -= 1  # now 2^e <= |x| < 2^(e + 1): keep 24 bits
    shift = 23 - e
    top, bottom = (num << shift, den) if shift >= 0 else (num, den << -shift)
    q, r = divmod(top, bottom)
    if 2 * r > bottom or (2 * r == bottom and q & 1):
        q += 1
    return float(np.copysign(q * 2.0**-shift, float(x)))


def _near_midpoints(n, seed):
    """Triples whose exact a b + c lies within half a float64 ulp of a
    float32 rounding midpoint, not on it: c = +-m 2^(k - 23) with m odd in
    [2^23, 2^24) and a b = +-2^(k - 24) (1 - j^2 2^-46), 1 <= j <= 361, so
    that the float64 sum is the midpoint."""
    rng = np.random.default_rng(seed)
    m = 2 * rng.integers(1 << 22, 1 << 23, n) + 1
    k = rng.integers(-40, 80, n)
    j = rng.integers(1, 362, n).astype(np.float64)
    e1 = rng.integers(-30, 31, n)
    a = rng.choice([-1.0, 1.0], n) * np.ldexp(1.0 + j * 2.0**-23, e1)
    b = np.ldexp(1.0 - j * 2.0**-23, k - 24 - e1)
    c = rng.choice([-1.0, 1.0], n) * np.ldexp(m.astype(np.float64), k - 23)
    return tuple(v.astype(np.float32) for v in (a, b, c))


def test_fma_rounds_once_as_xla():
    a, b, c = (np.float32([v]) for v in (1 + 2**-23, 1 - 2**-23, 16777218))
    assert _xla_fma(a, b, c)[0] == np.float32(16777218)
    assert _twice_rounded(a, b, c)[0] == np.float32(16777220)
    assert _fma(a, b, c)[0] == np.float32(16777218)


def test_fma_equals_xla_where_two_roundings_differ():
    a, b, c = _near_midpoints(4096, 1)
    differ = _twice_rounded(a, b, c) != _fma(a, b, c)
    assert differ.sum() >= 4000
    a, b, c = a[differ], b[differ], c[differ]
    np.testing.assert_array_equal(_fma(a, b, c), _xla_fma(a, b, c))
    np.testing.assert_array_equal(
        _fma(a, b, c), np.float32([_fraction_rounded(*t)
                                   for t in zip(a, b, c)]))


def test_fma_equals_the_exact_rounding():
    rng = np.random.default_rng(11)

    def draws(n):  # random signs, mantissas and exponents in 2^[-40, 40)
        m = rng.integers(0, 1 << 23, n, dtype=np.uint32)
        e = rng.integers(127 - 40, 127 + 40, n, dtype=np.uint32)
        s = rng.integers(0, 2, n, dtype=np.uint32)
        return ((s << 31) | (e << 23) | m).view(np.float32)

    a, b, c = draws(10**5), draws(10**5), draws(10**5)
    want = np.float32([_fraction_rounded(*t) for t in zip(a, b, c)])
    np.testing.assert_array_equal(_fma(a, b, c), want)
