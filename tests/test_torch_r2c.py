"""The forward transforms of the port: K6's plain version (the half-length
r2c head), the forward K3 and the distributed forward on one rank, vs the
JAX package's r2c head and numpy.

Tolerances, relative to the largest output: 1e-6 against the JAX head in
interpret mode (the same float32 algebra, two FFT libraries' rounding) and
2e-6 against numpy's float64 transforms (float32 butterflies).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

from randomfield_tpu_torch.ops import fft  # noqa: E402
from randomfield_tpu_torch.parallel import dfft  # noqa: E402
from randomfield_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

JAX_TOL = 1e-6
NUMPY_TOL = 2e-6


def _field(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("lead", [(3,), (2, 5)])
def test_r2c_head_plain_matches_jax_head(lead):
    import jax.numpy as jnp

    from randomfield_tpu.ops import pallas_fft as pf

    x = _field((*lead, 256))
    jre, jim = pf.rfft_minor_half_reim(jnp.asarray(x), interpret=True)
    re, im = fft.r2c_head_plain(torch.as_tensor(x))
    want = np.asarray(jre) + 1j * np.asarray(jim)
    assert re.shape == (*lead, 129)
    assert _rel(re.numpy() + 1j * im.numpy(), want) <= JAX_TOL
    assert _rel(re.numpy() + 1j * im.numpy(), np.fft.rfft(x)) <= NUMPY_TOL


@pytest.mark.parametrize("nz", [2, 16, 64, 2048])
def test_r2c_head_matches_numpy(nz):
    x = _field((4, 3, nz), nz)
    re, im = fft.r2c_head(torch.as_tensor(x))  # CPU: the plain version
    assert re.dtype == torch.float32 and re.shape == (4, 3, nz // 2 + 1)
    assert _rel(re.numpy() + 1j * im.numpy(), np.fft.rfft(x)) <= NUMPY_TOL
    # the DC and Nyquist terms of a real transform are real, exactly
    assert float(im[..., 0].abs().max()) == 0.0
    assert float(im[..., -1].abs().max()) == 0.0


def test_r2c_head_rejects_what_it_cannot_take():
    with pytest.raises(ValueError, match="float32"):
        fft.r2c_head(torch.zeros(4, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="even"):
        fft.r2c_head(torch.zeros(4, 7))


@pytest.mark.parametrize("view", [(1, 16, 40), (3, 32, 5), (2, 64, 1)])
def test_fft_axis_forward_matches_numpy_and_inverts(view):
    x = _field(view, 1) + 1j * _field(view, 2)
    re = torch.as_tensor(x.real.copy())
    im = torch.as_tensor(x.imag.copy())
    fft.fft_axis(re, im, *view)
    want = np.fft.fft(x.astype(np.complex128), axis=1)
    assert _rel(re.numpy() + 1j * im.numpy(), want) <= NUMPY_TOL
    fft.ifft_axis(re, im, *view)  # unnormalized: n times the input
    assert _rel(re.numpy() + 1j * im.numpy(), view[1] * x) <= NUMPY_TOL


@pytest.mark.parametrize("shape", [(16, 8, 32), (8, 16, 12)])
def test_one_rank_distributed_forward_matches_rfftn(shape):
    x = _field(shape, 3)
    re, im = dfft.rfftn_slab(torch.as_tensor(x), shape,
                             make_mesh(device="cpu"))
    want = np.fft.rfftn(x.astype(np.float64))
    assert _rel(re.numpy() + 1j * im.numpy(), want) <= NUMPY_TOL
    # and back: the inverse of a forward spectrum is nx ny nz times the field
    field = dfft.irfftn_slab_reim(re, im, shape, make_mesh(device="cpu"),
                                  torch.ones(shape[2]))
    assert _rel(field.numpy(), np.prod(shape) * x) <= NUMPY_TOL
