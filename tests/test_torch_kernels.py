"""The port's kernel modules vs the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; the JAX
kernels run in Pallas interpret mode, as the JAX package's own tests run
them.  The CUDA kernels themselves are tested in test_torch_cuda.py.
"""

import re as _re

import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from randomfield_tpu.ops import pallas_fft as jfft  # noqa: E402
from randomfield_tpu.ops import pallas_sampler as jps  # noqa: E402
from randomfield_tpu.ops import power as jpower  # noqa: E402
from randomfield_tpu.ops import transform as jtransform  # noqa: E402
from randomfield_tpu_torch.ops import _build, fft, grid, sampler, transform  # noqa: E402
from randomfield_tpu_torch.ops import power as tpower  # noqa: E402

SPACING = 16.0


def _rng_pair(shape, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _table_from_jax(tab):
    lk0, dlk, rows = tab
    return sampler.SigmaTable(float(lk0), float(dlk),
                              torch.as_tensor(sampler.flat_knots(rows)))


# ---- the sigma table ----------------------------------------------------------

@pytest.mark.parametrize("shape", [(32, 32, 32), (16, 256, 24), (8, 200, 8),
                                   (64, 64, 64)])
def test_flat_table_equals_deduplicated_jax_rows(shape):
    power = tpower.load_default_power()
    lk0, dlk, rows = jps.make_sigma_table(power, shape, SPACING, layout="xzy")
    got = sampler.make_sigma_table(power, shape, SPACING)
    assert (got.lk0, got.dlk) == (lk0, dlk)
    np.testing.assert_array_equal(got.knots.numpy(), sampler.flat_knots(rows))
    # consecutive JAX rows share their boundary knot
    np.testing.assert_array_equal(rows[1:, 0], rows[:-1, -1])


@pytest.mark.smoke
def test_table_sigma_tracks_tabulated_sigma():
    # the table's linear-in-log10k sigma vs the direct per-mode sigma
    # (the JAX package's 2e-3 table bound, pallas_sampler.make_sigma_table)
    shape = (16, 32, 24)
    power = tpower.load_default_power()
    table = sampler.make_sigma_table(power, shape, SPACING)
    amp = sampler.sigma_amplitude(table, shape, SPACING).numpy()
    ref = tpower.tabulate_sigmas(shape, SPACING, power).numpy()
    np.testing.assert_allclose(amp, ref, rtol=2e-3, atol=0)


# ---- K2 -------------------------------------------------------------------------

# relative bar of K2 vs the Pallas kernel: the same float32 operations in
# the same order; log/exp of two libraries differ by an ulp
K2_TOL = 1e-6


@pytest.mark.parametrize("shape", [(8, 16, 12), (16, 32, 24)])
@pytest.mark.parametrize("smoothing", [0.0, 6.0])
def test_scale_sigma_matches_pallas_xyz(shape, smoothing):
    power = tpower.load_default_power()
    tab = jps.make_sigma_table(power, shape, SPACING, layout="xyz")
    nzh = shape[2] // 2 + 1
    re0, im0 = _rng_pair((shape[0], shape[1], nzh))
    want = jps.scale_shard_pallas_reim(
        jnp.asarray(re0), jnp.asarray(im0), jnp.float32(smoothing),
        jnp.float32(tab[0]), jnp.float32(1.0 / tab[1]), jnp.asarray(tab[2]),
        0, 0, shape, SPACING, interpret=True,
    )
    re, im = torch.as_tensor(re0.copy()), torch.as_tensor(im0.copy())
    out = sampler.scale_sigma(re, im, _table_from_jax(tab), shape, SPACING,
                              smoothing)
    assert out[0] is re and out[1] is im  # in place
    for got, w in zip((re, im), want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=K2_TOL,
                                   atol=K2_TOL * np.abs(w).max())


def test_scale_sigma_block_offsets_match_pallas_shard():
    shape, smoothing = (16, 32, 24), 4.0
    x_off, y_off, bx, by = 4, 8, 8, 16
    power = tpower.load_default_power()
    tab = jps.make_sigma_table(power, shape, SPACING, layout="xyz")
    re0, im0 = _rng_pair((bx, by, shape[2] // 2 + 1), seed=1)
    want = jps.scale_shard_pallas_reim(
        jnp.asarray(re0), jnp.asarray(im0), jnp.float32(smoothing),
        jnp.float32(tab[0]), jnp.float32(1.0 / tab[1]), jnp.asarray(tab[2]),
        x_off, y_off, shape, SPACING, interpret=True,
    )
    re, im = torch.as_tensor(re0.copy()), torch.as_tensor(im0.copy())
    sampler.scale_sigma(re, im, _table_from_jax(tab), shape, SPACING,
                        smoothing, x_off=x_off, y_off=y_off)
    for got, w in zip((re, im), want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=K2_TOL,
                                   atol=K2_TOL * np.abs(w).max())


@pytest.mark.parametrize("smoothing", [0.0, 6.0])
def test_scale_sigma_matches_pallas_xzy_transposed(smoothing):
    # the single-device 'xzy' kernel (the TPU main path's K2) after a
    # transpose; its |k|^2 sums in another order, an ulp at most
    shape = (8, 16, 12)
    power = tpower.load_default_power()
    tab = jps.make_sigma_table(power, shape, SPACING, layout="xzy")
    re0, im0 = _rng_pair((shape[0], shape[1], shape[2] // 2 + 1), seed=2)
    want = jps.scale_spectrum_pallas_reim(
        jnp.asarray(re0.transpose(0, 2, 1)), jnp.asarray(im0.transpose(0, 2, 1)),
        tab, shape, SPACING, jnp.float32(smoothing), interpret=True,
    )
    re, im = torch.as_tensor(re0.copy()), torch.as_tensor(im0.copy())
    sampler.scale_sigma(re, im, _table_from_jax(tab), shape, SPACING, smoothing)
    for got, w in zip((re, im), want):
        w = np.asarray(w).transpose(0, 2, 1)
        np.testing.assert_allclose(got.numpy(), w, rtol=K2_TOL,
                                   atol=K2_TOL * np.abs(w).max())


@pytest.mark.parametrize("smoothing", [0.0, 6.0])
def test_scale_sigma_gain_matches_pallas_on_prescaled_input(smoothing):
    # a render folds its 1/sqrt(2) into K2's amplitude; the JAX package
    # scales the draws first: x (g a) vs (x g) a, an ulp apart
    shape = (16, 32, 24)
    gain = float(np.float32(0.5 ** 0.5))
    power = tpower.load_default_power()
    tab = jps.make_sigma_table(power, shape, SPACING, layout="xyz")
    re0, im0 = _rng_pair((shape[0], shape[1], shape[2] // 2 + 1), seed=3)
    want = jps.scale_shard_pallas_reim(
        jnp.asarray(re0 * np.float32(gain)), jnp.asarray(im0 * np.float32(gain)),
        jnp.float32(smoothing), jnp.float32(tab[0]), jnp.float32(1.0 / tab[1]),
        jnp.asarray(tab[2]), 0, 0, shape, SPACING, interpret=True,
    )
    re, im = torch.as_tensor(re0.copy()), torch.as_tensor(im0.copy())
    sampler.scale_sigma(re, im, _table_from_jax(tab), shape, SPACING,
                        smoothing, gain=gain)
    for got, w in zip((re, im), want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=K2_TOL,
                                   atol=K2_TOL * np.abs(w).max())


def test_scale_sigma_dc_is_zero_and_filter_is_gaussian():
    shape = (8, 8, 8)
    table = sampler.make_sigma_table(tpower.load_default_power(), shape, SPACING)
    a0 = sampler.sigma_amplitude(table, shape, SPACING).numpy()
    a1 = sampler.sigma_amplitude(table, shape, SPACING, 10.0).numpy()
    assert a0[0, 0, 0] == 0.0 and a1[0, 0, 0] == 0.0
    kx, ky, kz = (np.asarray(v) for v in grid.kvectors(shape, SPACING))
    k2 = kx[:, None, None] ** 2 + ky[None, :, None] ** 2 + kz[None, None, :] ** 2
    np.testing.assert_allclose(a1, a0 * np.exp(-0.5 * k2 * 100.0), rtol=2e-6,
                               atol=0)


def test_scale_sigma_rejects_bad_blocks():
    shape = (8, 8, 8)
    table = sampler.make_sigma_table(tpower.load_default_power(), shape, SPACING)
    z = torch.zeros((8, 8, 4))
    with pytest.raises(ValueError, match="blocks"):
        sampler.scale_sigma(z, z.clone(), table, shape, SPACING)
    z = torch.zeros((4, 8, 5))
    with pytest.raises(ValueError, match="outside the grid"):
        sampler.scale_sigma(z, z.clone(), table, shape, SPACING, x_off=6)
    with pytest.raises(ValueError, match="float32"):
        sampler.scale_sigma(z.double(), z.double(), table, shape, SPACING)


# ---- K3 -------------------------------------------------------------------------

# the JAX package's bar for its CT FFT vs numpy (tests/test_pallas_fft.py)
FFT_TOL = 3e-6


@pytest.mark.parametrize("shape", [(4, 128), (2, 256)])
def test_ifft_axis_matches_pallas_minor(shape):
    re0, im0 = _rng_pair(shape, seed=3)
    gre, gim = jfft.ifft_minor_pallas_reim(jnp.asarray(re0), jnp.asarray(im0),
                                           interpret=True)
    want = np.asarray(gre) + 1j * np.asarray(gim)
    ref = np.fft.ifft(re0.astype(np.float64) + 1j * im0, axis=-1,
                      norm="forward")
    re, im = torch.as_tensor(re0.copy()), torch.as_tensor(im0.copy())
    fft.ifft_axis(re, im, shape[0], shape[1], 1)
    got = re.numpy() + 1j * im.numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - want).max() <= FFT_TOL * scale
    assert np.abs(got - ref).max() <= FFT_TOL * scale


@pytest.mark.parametrize("view", [(1, 16, 40), (3, 32, 5), (2, 64, 1)])
def test_ifft_axis_middle_axis_matches_numpy(view):
    re0, im0 = _rng_pair(view, seed=4)
    ref = np.fft.ifft(re0.astype(np.float64) + 1j * im0, axis=1,
                      norm="forward")
    re, im = torch.as_tensor(re0.ravel().copy()), torch.as_tensor(im0.ravel().copy())
    fft.ifft_axis(re, im, *view)
    got = (re.numpy() + 1j * im.numpy()).reshape(view)
    assert np.abs(got - ref).max() <= FFT_TOL * np.abs(ref).max()


def test_ifft_axis_rejects_bad_views():
    z = torch.zeros(48)
    with pytest.raises(ValueError, match="view"):
        fft.ifft_axis(z, z.clone(), 2, 16, 2)
    with pytest.raises(ValueError, match="share shape"):
        fft.ifft_axis(z, torch.zeros(47), 1, 48, 1)
    zt = torch.zeros((6, 8)).t()
    with pytest.raises(ValueError, match="contiguous"):
        fft.ifft_axis(zt, zt.clone(), 1, 8, 6)


# ---- K4 -------------------------------------------------------------------------

@pytest.mark.smoke
@pytest.mark.parametrize("shape,nz", [((2, 8, 129), 256), ((3, 4, 17), 32)])
def test_c2r_tail_matches_pallas(shape, nz):
    rng = np.random.RandomState(3)
    c = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)
    c[..., 0] = c[..., 0].real    # a packed half-spectrum's DC and
    c[..., -1] = c[..., -1].real  # Nyquist terms are real
    w = rng.uniform(0.5, 1.5, size=nz).astype(np.float32)
    ref = np.fft.irfft(c, n=nz, axis=-1, norm="forward") * w
    got = fft.c2r_tail(torch.as_tensor(c.real.copy()),
                       torch.as_tensor(c.imag.copy()), nz,
                       torch.as_tensor(w)).numpy()
    scale = np.abs(ref).max()
    # the bar of tests/test_pallas_fft.py:test_irfft_tail_matches_numpy
    assert np.abs(got - ref).max() <= 5e-6 * scale
    if nz // 2 % 128 == 0:  # the Pallas tail takes nz/2 = A * 128
        want = np.asarray(jfft.irfft_tail_pallas(
            jnp.asarray(c.real), jnp.asarray(c.imag), nz, jnp.asarray(w),
            interpret=True,
        ))
        assert np.abs(got - want).max() <= 5e-6 * scale


def test_c2r_tail_rejects_bad_shapes():
    z = torch.zeros((2, 8, 100))
    with pytest.raises(ValueError, match="minor axis"):
        fft.c2r_tail(z, z.clone(), 256, torch.ones(256))
    z = torch.zeros((2, 8, 129))
    with pytest.raises(ValueError, match="weights"):
        fft.c2r_tail(z, z.clone(), 256, torch.ones(255))


def test_kernel_length_rule():
    assert [n for n in range(1, 5000) if fft.kernel_length_ok(n)] == [
        16, 32, 64, 128, 256, 512, 1024, 2048]


# ---- Hermitian symmetrization ---------------------------------------------------

@pytest.mark.parametrize("shape", [(6, 4, 10), (5, 7, 9), (8, 6, 9), (16, 8, 8)])
@pytest.mark.parametrize("scale", [True, False])
def test_symmetrize_matches_jax(shape, scale):
    nzh = shape[2] // 2 + 1
    re0, im0 = _rng_pair((shape[0], shape[1], nzh), seed=5)
    wre, wim = jtransform.symmetrize_with_shape_reim(
        jnp.asarray(re0), jnp.asarray(im0), shape[2], scale)
    re, im = torch.as_tensor(re0.copy()), torch.as_tensor(im0.copy())
    transform.symmetrize_with_shape_reim(re, im, shape[2], scale)
    np.testing.assert_array_equal(re.numpy(), np.asarray(wre))
    np.testing.assert_array_equal(im.numpy(), np.asarray(wim))


def test_plain_irfftn_matches_numpy():
    shape = (8, 6, 10)
    re0, im0 = _rng_pair((8, 6, 6), seed=6)
    c = re0 + 1j * im0
    re, im = torch.as_tensor(re0), torch.as_tensor(im0)
    transform.symmetrize_with_shape_reim(re, im, shape[2], False)
    c = jtransform.symmetrize_with_shape(jnp.asarray(c, jnp.complex64),
                                         shape[2], False)
    want = np.fft.irfftn(np.asarray(c), s=shape, axes=(0, 1, 2), norm="forward")
    got = transform.irfftn(re, im, shape).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("smoothing", [0.0, 7.5])
def test_filter_modes_matches_jax(smoothing):
    shape = (8, 6, 10)
    re0, im0 = _rng_pair((8, 6, 6), seed=7)
    want = np.asarray(jpower.filter_modes(jnp.asarray(re0 + 1j * im0),
                                          shape, SPACING, smoothing))
    got = tpower.filter_modes(torch.complex(torch.as_tensor(re0),
                                            torch.as_tensor(im0)),
                              shape, SPACING, smoothing).numpy()
    # exp of two libraries: an ulp or two of float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_tabulate_sigmas_matches_jax():
    shape = (8, 16, 12)
    power = tpower.load_default_power()
    want = np.asarray(jpower.tabulate_sigmas(shape, SPACING, power))
    got = tpower.tabulate_sigmas(shape, SPACING, power).numpy()
    # float64 host evaluation vs the JAX float32 device one
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)


# ---- the build and the C interface -----------------------------------------------

def test_c_entries_match_ctypes_signatures():
    # every int entry in csrc is declared for ctypes, and each declaration
    # has the C parameters' count and types (no compiler here to check the
    # binding; a pointer or a uint32 passed as an int would be cut)
    import ctypes

    c_types = {"void*": ctypes.c_void_p, "const void*": ctypes.c_void_p,
               "int": ctypes.c_int, "long long": ctypes.c_longlong,
               "float": ctypes.c_float, "uint32_t": ctypes.c_uint32,
               "double": ctypes.c_double}
    sources = "".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    entries = dict(_re.findall(r'extern "C" int (rf_\w+)\(([^)]*)\)', sources))
    assert set(entries) == set(_build._SIGNATURES)
    assert {"rf_sample_modes", "rf_sample_power_bins"} <= set(entries)
    for name, argtypes in _build._SIGNATURES.items():
        params = [" ".join(a.split()) for a in entries[name].split(",")]
        declared = [c_types[p.rsplit(" ", 1)[0].replace(" *", "*")]
                    for p in params]
        assert declared == list(argtypes), name


def test_build_is_keyed_on_sources(tmp_path, monkeypatch):
    monkeypatch.setenv("RF_TORCH_BUILD_DIR", str(tmp_path))
    assert _build.build_dir() == tmp_path
    h = _build._source_hash()
    assert h == _build._source_hash() and len(h) == 16
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    assert _build._source_hash() != h
