"""K10 (ops/genfft.py: sample_fftx, plane_spectra, its stream) vs the JAX
package's fused sample + x-FFT kernel (ops/pallas_genfft.py).

The JAX kernel runs here as its own tests run it (tests/test_pallas_genfft.py):
in the Mosaic interpreter, whose hardware PRNG yields zero bits, so every
bulk mode draws u1 = 2^-25, u2 = 0.  The port's plain K10 takes its bits as
arguments and is fed the same zero bits; the planes are Threefry draws in
both packages and are held to each other at the same seed.  The port's own
bulk stream is held to jax.extend.random.threefry_2x32 bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.extend.random as jexr  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import randomfield_tpu as rf  # noqa: E402
from randomfield_tpu.ops import pallas_genfft as jgf  # noqa: E402
from randomfield_tpu.ops.pallas_fft import digit_perm  # noqa: E402
from randomfield_tpu_torch.ops import genfft, modestream, sampler  # noqa: E402
from randomfield_tpu_torch.ops import transform  # noqa: E402

SHAPE = (128, 128, 64)  # the smallest grid the JAX kernel takes
SPACING = 16.0
# plain K10 on zero bits vs the JAX kernel, every row, of the largest
# output: the bar of tests/test_pallas_genfft.py's bulk rows
KERNEL_TOL = 2e-5
# plane_spectra of the two packages at one seed: normals within a few ulps,
# the same float32 scale
PLANE_TOL = 1e-5


def _max_rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def jax_gen():
    return rf.Generator(*SHAPE, grid_spacing=SPACING, sampler="pallas")


@pytest.fixture(scope="module")
def state(jax_gen):
    """The port's scene state carried across from the JAX scene."""
    lk0, dlk, stab = jax_gen._pallas_table
    return sampler.load_reference_state(
        stab, lk0, dlk, jax_gen.state.lightcone_weights, jax_gen.power.k,
        jax_gen.power.Pk)


# ---- (d) the stream ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_genfft_key_is_the_jax_fold_in_and_its_own(seed):
    want = jax.random.fold_in(jax.random.key(seed & 0x7FFFFFFF),
                              genfft.GENFFT_TAG)
    assert genfft.genfft_key(seed) == tuple(
        int(v) for v in jax.random.key_data(want))
    assert genfft.genfft_key(seed) == genfft.genfft_key(seed + 2**31)
    assert genfft.genfft_key(seed) != modestream.mode_key(seed)
    tags = {genfft.GENFFT_TAG, genfft.PLANE_TAG, modestream.STREAM_TAG}
    assert len(tags) == 3 and all(2**31 <= t < 2**32 for t in tags)
    assert genfft.STREAM != modestream.STREAM


@pytest.mark.parametrize("shape,kz_off,nkz", [
    ((8, 6, 10), 0, 6), ((16, 4, 8), 2, 2),
    # the last kz row of 2048^3: every counter is past 2^32
    ((2048, 2048, 2048), 1024, 1),
])
def test_genfft_bits_equal_jax_threefry(shape, kz_off, nkz):
    nx, ny, _ = shape
    rows = 3 if nx == 2048 else ny  # a few y rows of the big grid are enough
    key = genfft.genfft_key(11)
    b1, b2 = genfft.genfft_bits(key, shape, kz_off, nkz)
    assert tuple(b1.shape) == (nkz, ny, nx)
    idx = np.concatenate([
        np.arange((kz * ny) * nx, (kz * ny + rows) * nx, dtype=np.uint64)
        for kz in range(kz_off, kz_off + nkz)])
    count = np.concatenate([(idx >> np.uint64(32)).astype(np.uint32),
                            (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)])
    out = np.asarray(jexr.threefry_2x32(jnp.asarray(key, jnp.uint32),
                                        jnp.asarray(count)))
    n = idx.size
    np.testing.assert_array_equal(b1[:, :rows].flatten().numpy(),
                                  out[:n].astype(np.int64))
    np.testing.assert_array_equal(b2[:, :rows].flatten().numpy(),
                                  out[n:].astype(np.int64))


# ---- (c) the planes ------------------------------------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 24.0])
def test_plane_spectra_match_jax_from_a_carried_table(jax_gen, state, smoothing):
    jre, jim = jgf.plane_spectra(7, jax_gen._pallas_table, SHAPE, SPACING,
                                 smoothing)
    pre, pim = genfft.plane_spectra(7, state.table, SHAPE, SPACING, smoothing)
    ny, nx = SHAPE[1], SHAPE[0]
    assert tuple(pre.shape) == tuple(pim.shape) == (2 * ny, nx)
    scale = max(np.abs(np.asarray(jre)).max(), np.abs(np.asarray(jim)).max())
    assert scale > 0
    assert np.abs(pre.numpy() - np.asarray(jre)).max() <= PLANE_TOL * scale
    assert np.abs(pim.numpy() - np.asarray(jim)).max() <= PLANE_TOL * scale
    # Hermitian: each (y, x) plane is its own conjugate mirror; DC is zero
    for rows in (slice(0, ny), slice(ny, 2 * ny)):
        c = pre[rows].numpy() + 1j * pim[rows].numpy()
        mirror = np.conj(np.roll(c[::-1, ::-1], (1, 1), axis=(0, 1)))
        np.testing.assert_array_equal(c, mirror)
    assert float(pre[0, 0]) == 0.0 and float(pim[0, 0]) == 0.0


# ---- (b) the kernel's algebra ---------------------------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 32.0])
def test_plain_k10_on_zero_bits_matches_pallas_kernel(jax_gen, state, smoothing):
    nx, ny, nz = SHAPE
    nzh = nz // 2 + 1
    jre, jim = jgf.sample_fftx_pallas(7, jax_gen._pallas_table, SHAPE, SPACING,
                                      smoothing, interpret=True)
    perm = digit_perm(nx)
    want = (np.asarray(jre) + 1j * np.asarray(jim))[:, perm]
    zeros = torch.zeros((nzh, ny, nx), dtype=torch.int64)
    pre, pim = genfft.plane_spectra(7, state.table, SHAPE, SPACING, smoothing)
    re, im = genfft.sample_fftx_plain(zeros, zeros.clone(), pre, pim,
                                      state.table, SHAPE, SPACING, smoothing)
    got = re.numpy() + 1j * im.numpy()
    assert got.shape == want.shape == (nzh * ny, nx)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= KERNEL_TOL * scale
    # bulk rows and plane rows each on their own scale
    plane = np.zeros(nzh * ny, bool)
    plane[:ny] = plane[(nz // 2) * ny:] = True
    for rows in (plane, ~plane):
        assert _max_rel(got[rows], want[rows]) <= KERNEL_TOL


# ---- the wrapper on the CPU ----------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 16, 16), (12, 10, 8), (32, 8, 40)])
@pytest.mark.parametrize("smoothing", [0.0, 12.0])
def test_sample_fftx_is_the_x_transform_of_a_hermitian_spectrum(shape, smoothing):
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    table = sampler.make_sigma_table(rf.load_default_power(), shape, SPACING)
    re, im = genfft.sample_fftx(5, table, shape, SPACING, smoothing)
    assert tuple(re.shape) == (nzh * ny, nx) and re.dtype == torch.float32
    again = genfft.sample_fftx(5, table, shape, SPACING, smoothing)
    assert torch.equal(re, again[0]) and torch.equal(im, again[1])
    other = genfft.sample_fftx(6, table, shape, SPACING, smoothing)
    assert not torch.equal(re, other[0])
    # undo x: an 'xyz' spectrum whose planes are already Hermitian
    spec = torch.fft.fft(torch.complex(re, im).view(nzh, ny, nx).to(
        torch.complex128), dim=-1) / nx
    sre = spec.real.permute(2, 1, 0).contiguous()
    sim = spec.imag.permute(2, 1, 0).contiguous()
    fre, fim = transform.symmetrize_with_shape_reim(
        sre.clone(), sim.clone(), nz, scale_self_conjugate=False)
    scale = float(sre.abs().max())
    assert float((fre - sre).abs().max()) <= 1e-6 * scale
    assert float((fim - sim).abs().max()) <= 1e-6 * scale
    assert abs(complex(spec[0, 0, 0])) <= 1e-6 * scale
    # the bulk rows are the stream's draws, chunk by chunk
    planes = genfft.plane_spectra(5, table, shape, SPACING, smoothing)
    b1, b2 = genfft.genfft_bits(genfft.genfft_key(5), shape, 1, 2)
    r2, i2 = genfft.sample_fftx_plain(b1, b2, *planes, table, shape, SPACING,
                                      smoothing, kz_off=1)
    assert torch.equal(re[ny:3 * ny], r2) and torch.equal(im[ny:3 * ny], i2)


def test_can_genfft_is_the_cuda_kernels_rule():
    assert genfft.can_genfft((128, 128, 64))
    assert genfft.can_genfft((1024, 1024, 1024))
    assert genfft.can_genfft((16, 120, 6))      # any ny, any even nz
    assert genfft.can_genfft((2048, 8, 2))
    assert not genfft.can_genfft((96, 128, 64))    # nx not a power of two
    assert not genfft.can_genfft((8, 128, 64))     # nx below 16
    assert not genfft.can_genfft((4096, 128, 64))  # nx above 2048
    assert not genfft.can_genfft((128, 128, 63))   # odd nz


def test_sample_fftx_rejects_odd_nz_and_bad_inputs():
    shape = (16, 8, 8)
    table = sampler.make_sigma_table(rf.load_default_power(), shape, SPACING)
    with pytest.raises(ValueError, match="even"):
        genfft.sample_fftx(0, table, (16, 8, 9), SPACING)
    with pytest.raises(ValueError, match="even"):
        genfft.plane_spectra(0, table, (16, 8, 9), SPACING)
    pre, pim = genfft.plane_spectra(0, table, shape, SPACING)
    z = torch.zeros((5, 8, 16), dtype=torch.int64)
    with pytest.raises(ValueError, match="pre/pim"):
        genfft.sample_fftx_plain(z, z, pre[:8], pim[:8], table, shape, SPACING)
    with pytest.raises(ValueError, match="b1/b2"):
        genfft.sample_fftx_plain(z, z, pre, pim, table, shape, SPACING, kz_off=1)
    with pytest.raises(ValueError, match="b1/b2"):
        genfft.sample_fftx_plain(z.to(torch.int32), z, pre, pim, table, shape,
                                 SPACING)
