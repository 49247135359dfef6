"""The algebra of the register-radix Stockham core (csrc/fft_radix.cuh) on
the CPU: ``ops/fft.py:stockham_emulated`` replays the kernel's passes on
plain tensors from the same ``radix_plan`` and the same ``pass_twiddles``
tables the launchers hand the kernels.

It is held to numpy's float64 transforms for every length and both signs,
and, composed with each kernel's own algebra (K3's middle-axis views, K4's
fold and interleave, K6's pack and unfold, K9's rotation), to numpy, to
the plain versions and to the JAX package's kernels in interpret mode, as
tests/test_torch_kernels.py, tests/test_torch_r2c.py and
tests/test_torch_staged.py hold the plain versions.

Tolerances, relative to the largest output: 2e-6 against numpy and the
plain versions (float32 butterflies against float64 or cuFFT's float32),
5e-6 for K4 (the bar of tests/test_pallas_fft.py:test_irfft_tail_matches_
numpy), 1e-6 against the JAX r2c head (the same float32 unfold after an
m-point transform of another summation order), 3e-6 against the JAX
minor-axis and sublane kernels (the bars of tests/test_pallas_fft.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from randomfield_tpu_torch.ops import fft  # noqa: E402

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

LENGTHS = (16, 32, 64, 128, 256, 512, 1024, 2048)
NUMPY_TOL = 2e-6
K4_TOL = 5e-6
JAX_HEAD_TOL = 1e-6
JAX_SUBLANE_TOL = 3e-6
JAX_MINOR_TOL = 3e-6


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("n", LENGTHS)
def test_radix_plan_fits_the_kernels(n):
    plan = fft.radix_plan(n)
    assert int(np.prod(plan)) == n
    assert 2 <= len(plan) <= 3 and set(plan) <= {4, 8, 16}
    # a thread holds plan[0] elements and runs whole butterflies of each pass
    assert all(plan[0] % radix == 0 for radix in plan)
    # three passes: the first exchange leaves runs of 16 for the second
    assert len(plan) == 2 or plan[0] == 16
    assert fft._plan3(n)[:len(plan)] == plan
    assert int(np.prod(fft._plan3(n))) == n
    # a K9 block: whole lines, at least 8 columns, at most 1024 threads
    threads = fft.rotate_panel(n) * n // plan[0]
    assert fft.rotate_panel(n) >= 8 and 256 <= threads <= 1024


@pytest.mark.parametrize("n", (8, 24, 4096))
def test_radix_plan_refuses_other_lengths(n):
    with pytest.raises(ValueError, match="power of two"):
        fft.radix_plan(n)


@pytest.mark.parametrize("sign", (+1, -1))
@pytest.mark.parametrize("n", LENGTHS)
def test_pass_twiddles_are_the_passes_roots(n, sign):
    plan = fft.radix_plan(n)
    table = fft.pass_twiddles(n, sign, "cpu").numpy()
    assert table.dtype == np.float32
    assert table.shape == (sum((r - 1) * int(np.prod(plan[:i + 1]))
                               for i, r in enumerate(plan[1:])), 2)
    ns, offset = plan[0], 0
    for radix in plan[1:]:
        block = table[offset:offset + (radix - 1) * ns].reshape(radix - 1, ns, 2)
        r = np.arange(1, radix)[:, None]
        k = np.arange(ns)[None, :]
        want = np.exp(sign * 2j * np.pi * r * k / (ns * radix))
        np.testing.assert_allclose(block[..., 0] + 1j * block[..., 1], want,
                                   atol=6e-8)
        offset += (radix - 1) * ns
        ns *= radix


@pytest.mark.parametrize("sign", (+1, -1))
@pytest.mark.parametrize("radix", (4, 8, 16))
def test_register_butterfly_is_a_dft(radix, sign):
    a = _complex((3, radix, 5), radix)
    got = fft._dft_registers(torch.as_tensor(a), sign).numpy()
    jk = np.outer(np.arange(radix), np.arange(radix))
    want = np.einsum("kn,bnj->bkj", np.exp(sign * 2j * np.pi * jk / radix),
                     a.astype(np.complex128))
    assert _rel(got, want) <= 1e-6


@pytest.mark.smoke
@pytest.mark.parametrize("sign", (+1, -1))
@pytest.mark.parametrize("n", LENGTHS)
def test_stockham_passes_match_numpy(n, sign):
    x = _complex((3, 5, n), n)
    got = fft.stockham_emulated(torch.as_tensor(x), sign)
    assert got.dtype == torch.complex64 and tuple(got.shape) == x.shape
    wide = x.astype(np.complex128)
    want = (np.fft.ifft(wide, norm="forward") if sign > 0 else np.fft.fft(wide))
    assert _rel(got.numpy(), want) <= NUMPY_TOL


@pytest.mark.parametrize("n", (16, 1024))
def test_stockham_passes_invert(n):
    x = _complex((4, n), 3)
    there = fft.stockham_emulated(torch.as_tensor(x), -1)
    back = fft.stockham_emulated(there, +1)
    assert _rel(back.numpy(), n * x) <= NUMPY_TOL


@pytest.mark.parametrize("nz", (32, 64, 128, 256, 512, 1024, 2048, 4096))
def test_r2c_head_on_the_core_matches_numpy_and_plain(nz):
    x = np.random.default_rng(nz).normal(size=(2, 3, nz)).astype(np.float32)
    re, im = fft.r2c_head_emulated(torch.as_tensor(x))
    assert tuple(re.shape) == (2, 3, nz // 2 + 1)
    got = re.numpy() + 1j * im.numpy()
    assert _rel(got, np.fft.rfft(x.astype(np.float64))) <= NUMPY_TOL
    pre, pim = fft.r2c_head_plain(torch.as_tensor(x))
    assert _rel(got, pre.numpy() + 1j * pim.numpy()) <= NUMPY_TOL
    assert float(im[..., 0].abs().max()) == 0.0
    assert float(im[..., -1].abs().max()) == 0.0


@pytest.mark.parametrize("lead,nz", [((3,), 256), ((2, 5), 256), ((2,), 1024)])
def test_r2c_head_on_the_core_matches_jax_head(lead, nz):
    import jax.numpy as jnp

    from randomfield_tpu.ops import pallas_fft as pf

    x = np.random.default_rng(0).normal(size=(*lead, nz)).astype(np.float32)
    jre, jim = pf.rfft_minor_half_reim(jnp.asarray(x), interpret=True)
    re, im = fft.r2c_head_emulated(torch.as_tensor(x))
    want = np.asarray(jre) + 1j * np.asarray(jim)
    assert _rel(re.numpy() + 1j * im.numpy(), want) <= JAX_HEAD_TOL


@pytest.mark.parametrize("n,groups,cols", [(128, 2, 256), (256, 1, 128),
                                           (512, 3, 128)])
def test_ifft_rotate_on_the_core_matches_pallas_sublane(n, groups, cols):
    import jax.numpy as jnp

    from randomfield_tpu.ops import pallas_fft as jfft

    x = _complex((groups * n, cols), 7)
    gre, gim = jfft.ifft_sublane_pallas_reim(
        jnp.asarray(x.real), jnp.asarray(x.imag), n, interpret=True)
    want = (np.asarray(gre) + 1j * np.asarray(gim))[:, jfft.digit_perm(n)]
    re, im = fft.ifft_rotate_emulated(torch.as_tensor(x.real.copy()),
                                      torch.as_tensor(x.imag.copy()),
                                      groups, n, cols)
    got = re.numpy() + 1j * im.numpy()
    assert got.shape == want.shape == (groups * cols, n)
    assert _rel(got, want) <= JAX_SUBLANE_TOL


@pytest.mark.parametrize("groups,n,cols", [(1, 16, 40), (3, 32, 5), (2, 64, 1),
                                           (1, 2048, 3)])
def test_ifft_rotate_on_the_core_matches_plain(groups, n, cols):
    x = _complex((groups * n, cols), 11)
    args = (torch.as_tensor(x.real.copy()), torch.as_tensor(x.imag.copy()),
            groups, n, cols)
    a, b = fft.ifft_rotate_emulated(*args)
    c, d = fft.ifft_rotate_plain(*args)
    assert a.is_contiguous() and tuple(a.shape) == (groups * cols, n)
    assert _rel(a.numpy() + 1j * b.numpy(), c.numpy() + 1j * d.numpy()) <= NUMPY_TOL


# ---- K3: the core along the middle axis of (outer, n, inner) views ----------

def _axis_views(n):
    # inner = 1, a ragged inner (no whole K3 panel) and inner = 513 (a
    # render's y pass) at the smaller lengths
    views = [(3, n, 1), (2, n, fft.rotate_panel(n) + 3)]
    return views + [(2, n, 513)] if n <= 64 else views


@pytest.mark.parametrize("sign", (+1, -1))
@pytest.mark.parametrize("n", LENGTHS)
def test_axis_on_the_core_matches_numpy_and_plain(n, sign):
    plain = fft.ifft_axis_plain if sign > 0 else fft.fft_axis_plain
    for view in _axis_views(n):
        x = _complex(view, n + view[2])
        re, im = torch.as_tensor(x.real.copy()), torch.as_tensor(x.imag.copy())
        got = fft.axis_emulated(re, im, *view, sign)
        assert got[0] is re and got[1] is im  # in place, as the kernel
        got = re.numpy() + 1j * im.numpy()
        wide = x.astype(np.complex128)
        want = (np.fft.ifft(wide, axis=1, norm="forward") if sign > 0
                else np.fft.fft(wide, axis=1))
        assert _rel(got, want) <= NUMPY_TOL, view
        pre, pim = plain(torch.as_tensor(x.real.copy()),
                         torch.as_tensor(x.imag.copy()), *view)
        assert _rel(got, pre.numpy() + 1j * pim.numpy()) <= NUMPY_TOL, view


@pytest.mark.parametrize("shape", [(4, 128), (2, 256)])
def test_axis_on_the_core_matches_pallas_minor(shape):
    import jax.numpy as jnp

    from randomfield_tpu.ops import pallas_fft as jfft

    x = _complex(shape, 3)
    gre, gim = jfft.ifft_minor_pallas_reim(jnp.asarray(x.real), jnp.asarray(x.imag),
                                           interpret=True)
    want = np.asarray(gre) + 1j * np.asarray(gim)
    re, im = torch.as_tensor(x.real.copy()), torch.as_tensor(x.imag.copy())
    fft.axis_emulated(re, im, shape[0], shape[1], 1, +1)
    assert _rel(re.numpy() + 1j * im.numpy(), want) <= JAX_MINOR_TOL


# ---- K4: the fold, the m-point core, the interleave and the weights ---------

def _hermitian_lines(lead, m, seed):
    c = _complex((*lead, m + 1), seed)
    c[..., 0] = c[..., 0].real    # a packed half-spectrum's DC and
    c[..., -1] = c[..., -1].real  # Nyquist terms are real
    w = np.random.default_rng(seed).uniform(0.5, 1.5, size=2 * m)
    return c, w.astype(np.float32)


@pytest.mark.parametrize("m", LENGTHS)
def test_c2r_tail_on_the_core_matches_numpy_and_plain(m):
    c, w = _hermitian_lines((2, 3), m, m)
    nz = 2 * m
    args = (torch.as_tensor(c.real.copy()), torch.as_tensor(c.imag.copy()), nz,
            torch.as_tensor(w))
    got = fft.c2r_tail_emulated(*args)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 3, nz)
    want = np.fft.irfft(c.astype(np.complex128), n=nz, axis=-1, norm="forward") * w
    assert _rel(got.numpy(), want) <= K4_TOL
    assert _rel(got.numpy(), fft.c2r_tail_plain(*args).numpy()) <= K4_TOL


@pytest.mark.parametrize("nz", (256, 512))
def test_c2r_tail_on_the_core_matches_pallas_tail(nz):
    import jax.numpy as jnp

    from randomfield_tpu.ops import pallas_fft as jfft

    c, w = _hermitian_lines((2, 8), nz // 2, 5)
    want = np.asarray(jfft.irfft_tail_pallas(
        jnp.asarray(c.real), jnp.asarray(c.imag), nz, jnp.asarray(w),
        interpret=True))
    got = fft.c2r_tail_emulated(torch.as_tensor(c.real.copy()),
                                torch.as_tensor(c.imag.copy()), nz,
                                torch.as_tensor(w))
    assert _rel(got.numpy(), want) <= K4_TOL
