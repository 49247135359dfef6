"""The algebra of the register-radix Stockham core (csrc/fft_radix.cuh) on
the CPU: ``ops/fft.py:stockham_emulated`` replays the kernel's passes on
plain tensors from the same ``radix_plan`` and the same ``pass_twiddles``
tables the launchers hand the kernels.

It is held to numpy's float64 transforms for every length and both signs,
and, composed with K6's pack and unfold and with K9's rotation, to the JAX
package's kernels in interpret mode, as tests/test_torch_r2c.py and
tests/test_torch_staged.py hold the plain versions.

Tolerances, relative to the largest output: 2e-6 against numpy (float32
butterflies against float64), 1e-6 against the JAX r2c head (the same
float32 unfold after an m-point transform of another summation order), 3e-6
against the JAX sublane kernel (the bar of
tests/test_pallas_fft.py:test_sublane_matches_numpy).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from randomfield_tpu_torch.ops import fft  # noqa: E402

LENGTHS = (16, 32, 64, 128, 256, 512, 1024, 2048)
NUMPY_TOL = 2e-6
JAX_HEAD_TOL = 1e-6
JAX_SUBLANE_TOL = 3e-6


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
