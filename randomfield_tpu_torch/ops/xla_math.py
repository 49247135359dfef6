"""XLA's CPU float32 elementwise functions, operation for operation.

The JAX package's reference results come from XLA's CPU backend, which
evaluates ``log``, ``exp``, ``log1p``, ``lgamma`` and ``erf_inv`` with its
own float32 polynomials (Cephes' log and exp, a rational log1p, a Lanczos
lgamma, Giles' erfinv) rather than the C library, and whose LLVM code
generation contracts each multiply that feeds one add into a fused
multiply-add.  The functions here repeat those operations in their order,
each fused multiply-add rounded once, as XLA's (:func:`_fma`: the float64
sum of the exact float64 product and the addend, rounded to odd, then to
float32), and each square root correctly rounded (:func:`_sqrt`; torch's
float32 sqrt on a CPU can miss by an ulp).  The port's replays of
``jax.random.poisson`` (:mod:`.poisson`, KH) and ``jax.random.normal``
(:func:`.threefry.normal_exact`) give the JAX package's numbers bit for
bit on every tested input.  ``csrc/poisson.cu`` repeats the same
operations on the card, each multiply-add one ``__fmaf_rn``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["xla_log", "xla_exp", "xla_log1p", "xla_lgamma", "xla_erfinv"]

_F32 = torch.float32
_F64 = torch.float64


def _f32(x):
    return float(np.float32(x))


def _hexf(bits):
    """The float32 value of a float64 bit pattern as XLA's LLVM IR writes
    float constants."""
    return float(np.float32(np.array([bits], np.uint64).view(np.float64)[0]))


_MIN_NORM = float(np.finfo(np.float32).tiny)


def _div(c, t):
    """float32 c / t, rounded once (a Python number over a tensor would be
    multiplied by the tensor's reciprocal)."""
    return torch.full_like(t, c) / t


def _fma(a, b, c):
    """a b + c for float32 values, rounded once to float32 as a fused
    multiply-add rounds it (for results in float32's normal range; XLA's
    CPU backend flushes subnormal ones, which its callers here do).  The
    float64 product of two float32 values is exact and their float64 sum
    s rounds to float32 as the exact sum does unless s is a float32
    rounding midpoint: only there is s made the sum rounded to odd
    (TwoSum's error says whether s was inexact; an inexact s with an even
    last bit steps one ulp toward the exact sum), and a float64 rounded to
    odd, 29 bits longer than float32, rounds to float32 as the exact sum
    does (Boldo and Melquiond, "Emulation of FMA and correctly rounded
    sums: proved algorithms using rounding to odd", IEEE Trans. Computers
    57, 2008)."""
    # in place (a float32 factor's shape is the result's); the product is
    # formed again where it is needed
    s = a.to(_F64, copy=True).mul_(b).add_(c)
    near = (s.view(torch.int64) & 0x1FFFFFFF).eq_(0x10000000)
    if bool(near.any()):
        i = near.nonzero(as_tuple=True)

        def at(x):
            return x.expand(s.shape)[i].to(_F64) if torch.is_tensor(x) else x

        ps, cs, ss = at(a) * at(b), at(c), s[i]
        pb = ss - ps
        err = (ps - (ss - pb)) + (cs - pb)
        even = (ss.view(torch.int64) & 1) == 0
        toward = torch.where(err > 0, torch.inf, -torch.inf).to(_F64)
        s[i] = torch.where((err != 0) & even, torch.nextafter(ss, toward), ss)
    return s.to(_F32)


def _fma_of_exact(a, b, c):
    """a b + c, one of XLA's fused multiply-adds (``fma32`` in
    ``csrc/poisson.cu``) where the product a b is exact in float32 (one
    factor a power of two, or an integer of 8 bits times a constant of 10):
    the float32 sum then rounds once, as the fused one does, and costs less
    than :func:`_fma`."""
    return a * b + c


def _sqrt(x):
    """float32 sqrt, correctly rounded (the float64 root of a float32 value
    rounds to float32 as the float32 root would)."""
    return torch.sqrt(x.to(_F64)).to(_F32)


_LOG_P = [_f32(v) for v in (7.0376836292e-2, -1.1514610310e-1,
                            1.1676998740e-1, -1.2420140846e-1,
                            1.4249322787e-1, -1.6668057665e-1,
                            2.0000714765e-1, -2.4999993993e-1,
                            3.3333331174e-1)]
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)
_SQRTHF = _f32(0.707106781186547524)


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """float32 log as XLA's CPU backend evaluates it (Cephes' polynomial,
    its multiply-adds fused): -inf at 0, NaN below, +inf at +inf."""
    x = x.to(_F32)
    t = torch.where(x > _MIN_NORM, x, _MIN_NORM)
    bits = t.view(torch.int32)
    e = ((bits >> 23) - 127).to(_F32) + 1.0
    m = ((bits & -0x7F800001) | 0x3F000000).view(_F32)
    low = m < _SQRTHF
    e = e - low.to(_F32)
    m = (m - 1.0) + torch.where(low, m, 0.0)
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma(m, p[0], p[1])
    y1 = _fma(m, p[3], p[4])
    y2 = _fma(m, p[6], p[7])
    y = _fma(y, m, p[2])
    y1 = _fma(y1, m, p[5])
    y2 = _fma(y2, m, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)
    r = _fma_of_exact(x2, -0.5, m) + y
    r = _fma_of_exact(e, _LOG_Q2, r)
    r = torch.where(x > 0, r, torch.where(x == 0, -torch.inf, torch.nan))
    return torch.where(x == torch.inf, torch.inf, r)


_EXP_LO, _EXP_HI = _hexf(0xC055F33340000000), _hexf(0x4056333340000000)
_EXP_LOG2E = _hexf(0x3FF7154760000000)
_EXP_C1, _EXP_C2 = _hexf(0x3FE6300000000000), _hexf(0xBF2BD01060000000)
_EXP_P = [_hexf(v) for v in (0x3F2A0D2CE0000000, 0x3F56E879C0000000,
                             0x3F81112100000000, 0x3FA5553820000000,
                             0x3FC5555540000000)] + [0.5]


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """float32 exp as XLA's CPU backend evaluates it (Cephes, the input
    clamped to [-87.8, 88.8], multiply-adds fused, a subnormal result
    flushed to zero)."""
    x = torch.clamp(x.to(_F32), _EXP_LO, _EXP_HI)
    fx = torch.floor(_fma(x, _EXP_LOG2E, 0.5)).clamp(-127.0, 127.0)
    t = _fma_of_exact(fx, -_EXP_C1, x)
    t = _fma(fx, -_EXP_C2, t)
    y = torch.full_like(t, _EXP_P[0])
    for c in _EXP_P[1:]:
        y = _fma(y, t, c)
    y = _fma(y, t * t, t) + 1.0
    scale = ((fx.to(torch.int32) + 127) << 23).view(_F32)
    return _flush(y * scale)


def _flush(x):
    """XLA's CPU backend flushes subnormal results to zero."""
    return torch.where(x.abs() < _MIN_NORM, 0.0, x)


_L1P_P = [_hexf(v) for v in (0x402E2035A0000000, 0x4054C30B60000000,
                             0x406BB865A0000000, 0x4073519460000000,
                             0x406B0DB140000000, 0x404E0F3040000000)]
_L1P_Q = [_hexf(v) for v in (0x3F07BC0960000000, 0x3FDFE818A0000000,
                             0x401A509F40000000, 0x403DE97380000000,
                             0x404E798EC0000000, 0x404C8E75A0000000,
                             0x40340A2020000000)]
_L1P_SMALL = _hexf(0x3FDA8279A0000000)


def xla_log1p(w):
    """XLA's float32 log1p: a rational approximation for |w| < 0.41421357,
    else log(1 + w)."""
    big = xla_log(w + 1.0)
    p = torch.ones_like(w)
    for c in _L1P_P:
        p = _fma(p, w, c)
    q = torch.full_like(w, _L1P_Q[0])
    for c in _L1P_Q[1:]:
        q = _fma(q, w, c)
    w2 = w * w
    small = w + _fma_of_exact(w2, -0.5, (w * w2) * (q / p))
    return torch.where(w.abs() < _L1P_SMALL, small, big)


# the Lanczos approximation XLA's lgamma uses (g = 7), float32 coefficients
_LANCZOS = [_f32(v) for v in (676.520368121885098567009190444019,
                              -1259.13921672240287047156078755283,
                              771.3234287776530788486528258894,
                              -176.61502916214059906584551354,
                              12.507343278686904814458936853,
                              -0.13857109526572011689554707,
                              9.984369578019570859563e-6,
                              1.50563273514931155834e-7)]
_LG_INV_T = _hexf(0x3FC1111120000000)      # 1 / 7.5
_LG_LOG_T = _hexf(0x40001E8580000000)      # log(7.5)
_LG_LOG_SQRT_2PI = _hexf(0x3FED67F1C0000000)


def xla_lgamma(x: torch.Tensor) -> torch.Tensor:
    """float32 lgamma as XLA's CPU backend evaluates it, for x >= 0.5 (its
    reflection branch for smaller x is left out: the rejection loop reads
    lgamma(k + 1) only where k >= 0, a rejected k < 0 discards it)."""
    z = x.to(_F32) - 1.0
    acc = _div(_LANCZOS[0], z + 1.0) + 1.0
    for i, c in enumerate(_LANCZOS[1:], start=2):
        acc = acc + _div(c, z + float(i))
    t = z + 7.5
    log_t = xla_log1p(z * _LG_INV_T) + _LG_LOG_T
    out = _fma(log_t, (z + 0.5) - t / log_t, _LG_LOG_SQRT_2PI) + xla_log(acc)
    return torch.where(x == torch.inf, torch.inf, out)


# Giles' single-precision erfinv as XLA lowers erf_inv: w < 5, then w >= 5
_ERFINV_CENTRAL = [_f32(v) for v in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)]
_ERFINV_TAIL = [_f32(v) for v in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)]


def xla_erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv of x in [-1, 1] as XLA's CPU backend evaluates it:
    l = log1p(-x x) (the product rounded, then XLA's log1p), the central or
    tail polynomial in w = -l with fused multiply-adds, times x; +-inf at
    |x| = 1."""
    x = x.to(_F32)
    l = xla_log1p(x * -x)
    central = l > -5.0
    t = torch.where(central, -2.5 - l, _sqrt(-l) - 3.0)
    p = None
    for a, b in zip(_ERFINV_CENTRAL, _ERFINV_TAIL):
        c = torch.where(central, a, b)
        p = c if p is None else _fma(p, t, c)
    p = torch.where(x.abs() == 1.0, torch.inf, p)
    return x * p
