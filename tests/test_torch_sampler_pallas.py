"""sampler='pallas' in the port (K1, K5, their stream and the Generator) vs
the JAX package.

The JAX fused sampler runs here as its own tests run it
(tests/test_pallas_sampler.py): in the Mosaic interpreter, whose hardware
PRNG yields zero bits, so every mode draws u1 = 2^-25, u2 = 0.  The port's
plain kernels take their bits as arguments, so they are fed the same zero
bits for the algebra, and the port's own counter-based stream (held to
jax.extend.random.threefry_2x32 bit for bit) for everything else.
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
import randomfield_tpu_torch as rft  # noqa: E402
from randomfield_tpu.ops import grid as jgrid  # noqa: E402
from randomfield_tpu.ops import pallas_sampler as jps  # noqa: E402
from randomfield_tpu.ops import power as jpower  # noqa: E402
from randomfield_tpu.ops import transform as jtransform  # noqa: E402
from randomfield_tpu.validate import stats as jstats  # noqa: E402
from randomfield_tpu_torch.ops import modestream, sample, sampler, threefry  # noqa: E402
from randomfield_tpu_torch.ops import transform  # noqa: E402
from randomfield_tpu_torch.parallel.mesh import make_pencil_mesh  # noqa: E402
from randomfield_tpu_torch.validate import sampler_gate  # noqa: E402
from randomfield_tpu_torch.validate import stats  # noqa: E402

SPACING = 8.0
BIN_SHAPES = [(16, 16, 16), (8, 12, 10), (16, 16, 15)]
NBINS = 6
# the same float32 operations on both sides; libm's log/cos/exp differ from
# XLA's by an ulp or two
ALGEBRA_TOL = 1e-6
# numpy Box-Muller times the JAX sigma-scale kernel: the same factors
# multiplied in another order (sigma / sqrt(2) first on the port's side)
REAL_BITS_TOL = 2e-6
# binned sums: the JAX package contracts float32 terms, the port adds the
# same terms in float64 (tests/test_pallas_sampler.py's bar)
SUM_RTOL = 3e-5


def _jax_table(shape):
    return jps.make_sigma_table(jpower.load_default_power(), shape, SPACING,
                                layout="xzy")


def _port_table(jtab):
    lk0, dlk, rows = jtab
    return sampler.SigmaTable(float(lk0), float(dlk),
                              torch.as_tensor(sampler.flat_knots(rows)))


def _zero_bits(shape):
    z = torch.zeros((shape[0], shape[1], shape[2] // 2 + 1), dtype=torch.int64)
    return z, z.clone()


def _max_rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---- 1. the stream ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 123456789])
def test_mode_key_is_the_jax_fold_in(seed):
    want = jax.random.fold_in(jax.random.key(seed & 0x7FFFFFFF),
                              modestream.STREAM_TAG)
    want = tuple(int(v) for v in jax.random.key_data(want))
    assert modestream.mode_key(seed) == want
    assert modestream.mode_key(seed) == modestream.mode_key(seed + 2**31)


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
@pytest.mark.parametrize("shape,x_off,nx_loc", [
    ((4, 6, 10), 0, 4), ((8, 8, 8), 3, 2), ((5, 3, 9), 0, 5),
    # x plane 2047 of 2048^3: every counter is past 2^32
    ((2048, 2048, 2048), 2047, 1),
])
def test_mode_bits_equal_jax_threefry(seed, shape, x_off, nx_loc):
    key = modestream.mode_key(seed)
    b1, b2 = modestream.mode_bits(key, shape, x_off, nx_loc)
    plane = shape[1] * (shape[2] // 2 + 1)
    idx = np.arange(x_off * plane, (x_off + nx_loc) * plane, dtype=np.uint64)
    count = np.concatenate([(idx >> np.uint64(32)).astype(np.uint32),
                            (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)])
    out = np.asarray(jexr.threefry_2x32(jnp.asarray(key, jnp.uint32),
                                        jnp.asarray(count)))
    n = idx.size
    np.testing.assert_array_equal(b1.flatten().numpy(), out[:n].astype(np.int64))
    np.testing.assert_array_equal(b2.flatten().numpy(), out[n:].astype(np.int64))


def test_stream_tag_is_no_canonical_chunk_index():
    assert 2**31 <= modestream.STREAM_TAG < 2**32
    assert max(sample.canonical_chunks(n) for n in range(1, 4097)) \
        < modestream.STREAM_TAG
    base = threefry.key_from_seed(5)
    keys = {threefry.fold_in(base, i) for i in range(sample.CANONICAL_CHUNK_TARGET)}
    assert modestream.mode_key(5) not in keys


# ---- 2-3. K1's algebra --------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 16, 16), (8, 12, 10)])
@pytest.mark.parametrize("smoothing", [0.0, 2.0])
def test_plain_k1_on_zero_bits_matches_pallas_kernel(shape, smoothing):
    jtab = _jax_table(shape)
    jre, jim = jps.sample_spectrum_pallas_reim(7, jtab, shape, SPACING,
                                               smoothing, interpret=True)
    want = (np.asarray(jre).transpose(0, 2, 1)
            + 1j * np.asarray(jim).transpose(0, 2, 1))
    re, im = sampler.sample_modes_plain(*_zero_bits(shape), _port_table(jtab),
                                        shape, SPACING, smoothing)
    re, im = transform.symmetrize_with_shape_reim(re, im, shape[2])
    got = re.numpy() + 1j * im.numpy()
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= ALGEBRA_TOL * np.abs(want).max()


@pytest.mark.parametrize("shape", [(16, 16, 16), (8, 12, 10)])
@pytest.mark.parametrize("smoothing", [0.0, 5.0])
def test_plain_k1_on_real_bits_is_box_muller_times_pallas_scale(shape, smoothing):
    b1, b2 = modestream.mode_bits(modestream.mode_key(11), shape)
    f32 = np.float32
    u1 = (b1.numpy() >> 8).astype(f32) * f32(2**-24) + f32(2**-25)
    u2 = (b2.numpy() >> 8).astype(f32) * f32(2**-24)
    r = np.sqrt(f32(-2.0) * np.log(u1))
    theta = f32(2 * np.pi) * u2
    inv = f32(1 / np.sqrt(2.0))
    zre, zim = (r * np.cos(theta)) * inv, (r * np.sin(theta)) * inv
    jtab = _jax_table(shape)
    jre, jim = jps.scale_spectrum_pallas_reim(
        jnp.asarray(zre.transpose(0, 2, 1)), jnp.asarray(zim.transpose(0, 2, 1)),
        jtab, shape, SPACING, smoothing, interpret=True)
    re, im = sampler.sample_modes_plain(b1, b2, _port_table(jtab), shape,
                                        SPACING, smoothing)
    for got, want in ((re, jre), (im, jim)):
        want = np.asarray(want).transpose(0, 2, 1)
        assert _max_rel(got.numpy(), want) <= REAL_BITS_TOL


def test_seeded_plain_k1_is_its_slabs_and_its_bits():
    shape = (70, 8, 6)  # two slabs of the plain version
    table = _port_table(_jax_table(shape))
    re, im = sampler.seeded_modes_plain(4, table, shape, SPACING, 1.0)
    b1, b2 = modestream.mode_bits(modestream.mode_key(4), shape, 66, 4)
    r2, i2 = sampler.sample_modes_plain(b1, b2, table, shape, SPACING, 1.0, 66)
    assert torch.equal(re[66:], r2) and torch.equal(im[66:], i2)
    # K1 (its CPU path) fixes the planes and leaves every other mode alone
    fre, fim = sampler.sample_modes(4, table, shape, SPACING, 1.0)
    assert torch.equal(fre[..., 1:3], re[..., 1:3])
    assert torch.equal(fim[..., 1:3], im[..., 1:3])
    for t in (re, im, fre, fim):
        assert float(t[0, 0, 0]) == 0.0


# ---- 4-5. K5 ---------------------------------------------------------------------

def _jax_binned(shape, smoothing, jtab):
    """The JAX binned kernel (interpret) plus its plane path, as
    tests/test_pallas_sampler.py assembles it."""
    lk0, dlk, stab = jtab
    args = (jnp.uint32(7), jnp.float32(smoothing), jnp.float32(lk0),
            jnp.float32(1.0 / dlk), jnp.asarray(stab))
    edges, _ = jstats._bin_setup(shape, SPACING, NBINS)
    ledges = np.log10(edges)
    acc, pre, pim = jps.sample_power_bins_reim(
        *args, shape, SPACING, NBINS, float(ledges[0]),
        float(NBINS / (ledges[-1] - ledges[0])), interpret=True)
    nx, ny, nz = shape
    out = [np.asarray(acc[i, :NBINS], np.float64) for i in range(3)]
    two_pi = 2.0 * np.pi
    kx2 = jnp.asarray((two_pi * np.fft.fftfreq(nx, d=SPACING)) ** 2, jnp.float32)
    ky2 = jnp.asarray((two_pi * np.fft.fftfreq(ny, d=SPACING)) ** 2, jnp.float32)
    volume = nx * ny * nz * SPACING ** 3
    for i, p in enumerate(jgrid.self_conjugate_kz_planes(nz)):
        kzv = (two_pi / (nz * SPACING)) * p
        fre, fim = jtransform._symmetrize_plane_reim(pre[:, i, :], pim[:, i, :],
                                                     True)
        km = jnp.sqrt(kx2[:, None] + ky2[None, :] + jnp.float32(kzv * kzv))
        pval = (fre * fre + fim * fim) * jnp.float32(volume)
        sums = jstats._masked_bins(km, jnp.float32(1.0), pval,
                                   jnp.asarray(edges, jnp.float32), NBINS,
                                   per_slab=False)
        for j in range(3):
            out[j] = out[j] + np.asarray(sums[j], np.float64)
    return out


def _port_binned(b1, b2, table, shape, smoothing):
    edges, _ = stats.bin_setup(shape, SPACING, NBINS)
    acc, pre, pim = sampler.power_bins_plain(b1, b2, table, shape, SPACING,
                                             smoothing, edges)
    return (acc + stats.plane_bins(pre, pim, shape, SPACING, NBINS)).numpy()


@pytest.mark.parametrize("shape", BIN_SHAPES)
@pytest.mark.parametrize("smoothing", [0.0, 4.0])
def test_plain_k5_on_zero_bits_matches_pallas_binned_kernel(shape, smoothing):
    jtab = _jax_table(shape)
    want = _jax_binned(shape, smoothing, jtab)
    got = _port_binned(*_zero_bits(shape), _port_table(jtab), shape, smoothing)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=SUM_RTOL)
    np.testing.assert_allclose(got[2], want[2], rtol=SUM_RTOL)


@pytest.mark.parametrize("shape", BIN_SHAPES)
@pytest.mark.parametrize("smoothing", [0.0, 4.0])
def test_plain_k5_matches_binning_the_k1_spectrum(shape, smoothing):
    table = _port_table(_jax_table(shape))
    b1, b2 = modestream.mode_bits(modestream.mode_key(21), shape)
    got = _port_binned(b1, b2, table, shape, smoothing)
    re, im = sampler.sample_modes_plain(b1, b2, table, shape, SPACING, smoothing)
    re, im = transform.symmetrize_with_shape_reim(re, im, shape[2])
    k, p, n = stats.spectrum_power((re, im), shape, SPACING, NBINS)
    np.testing.assert_array_equal(got[0], n)
    live = n > 0
    np.testing.assert_allclose(got[1][live] / n[live], p[live], rtol=SUM_RTOL)
    np.testing.assert_allclose(got[2][live] / n[live], k[live], rtol=SUM_RTOL)


def test_k5_wrapper_planes_are_k1_draws_and_bins_are_capped():
    # K5 returns the fused sums: its interior bins plus its planes, drawn as
    # K1 draws them, made Hermitian and binned with multiplicity 1
    shape = (8, 12, 10)
    table = _port_table(_jax_table(shape))
    edges, _ = stats.bin_setup(shape, SPACING, NBINS)
    acc = sampler.sample_power_bins(3, table, shape, SPACING, 2.0, edges)
    assert tuple(acc.shape) == (3, NBINS) and acc.dtype == torch.float64
    b1, b2 = modestream.mode_bits(modestream.mode_key(3), shape)
    assert np.array_equal(acc.numpy(), _port_binned(b1, b2, table, shape, 2.0))
    raw, pre, pim = sampler.power_bins_plain(b1, b2, table, shape, SPACING,
                                             2.0, edges)
    re, im = sampler.sample_modes(3, table, shape, SPACING, 2.0)
    assert tuple(pre.shape) == (8, 2, 12)
    for i, p in enumerate((0, 5)):
        fre, fim = transform.symmetrize_plane_reim(pre[:, i], pim[:, i])
        assert torch.equal(fre, re[..., p]) and torch.equal(fim, im[..., p])
    # the planes add every plane mode but DC once
    assert float((acc[0] - raw[0]).sum()) == 2 * 8 * 12 - 1
    with pytest.raises(ValueError, match="ascending edges"):
        sampler.sample_power_bins(3, table, shape, SPACING, 0.0,
                                  np.logspace(-2, 0, 131))
    with pytest.raises(ValueError, match="ascending edges"):
        sampler.sample_power_bins(3, table, shape, SPACING, 0.0, edges[::-1])


# ---- 6. the Generator ------------------------------------------------------------

@pytest.fixture(scope="module")
def gen16():
    return rft.Generator(16, 16, 16, grid_spacing=SPACING, device="cpu",
                         sampler="pallas")


def test_pallas_render_is_deterministic_and_batched(gen16):
    a = gen16.generate_delta_field(5, smoothing_length=9.0)
    assert a.dtype == torch.float32 and tuple(a.shape) == (16, 16, 16)
    assert torch.equal(gen16.generate_delta_field(5, smoothing_length=9.0), a)
    assert not torch.equal(gen16.generate_delta_field(6, smoothing_length=9.0), a)
    batch = gen16.generate_delta_fields([5], smoothing_length=9.0)
    assert torch.equal(batch[0], a)
    # the render is K1 + symmetrize, then the threefry path's transforms
    re, im = sampler.sample_spectrum(5, gen16.state.table, gen16.shape,
                                     SPACING, 9.0)
    want = torch.fft.irfftn(torch.complex(re, im), s=gen16.shape,
                            norm="forward") * gen16.state.lightcone_weights
    assert float((a - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("sampler_name,smoothing", [("pallas", 0.0),
                                                    ("pallas", 3.0),
                                                    ("threefry", 0.0)])
def test_sample_power_matches_calculate_power(sampler_name, smoothing):
    g = rft.Generator(16, 16, 16, grid_spacing=SPACING, device="cpu",
                      sampler=sampler_name)
    k, p, n = g.sample_power(8, smoothing, nbins=10)
    field = g.generate_delta_field(8, smoothing, apply_lightcone=False)
    kf, pf, nf = g.calculate_power(field, nbins=10)
    np.testing.assert_array_equal(n, nf)
    live = n > 0
    # the spectrum's round trip through c2r and the forward rfft
    np.testing.assert_allclose(p[live], pf[live], rtol=1e-4)
    np.testing.assert_allclose(k[live], kf[live], rtol=1e-6)


def test_sample_power_batch_rows_and_wide_bins(gen16):
    k, p, n = gen16.sample_power_batch([3, 4], nbins=12)
    assert p.shape == (2, 12)
    for row, seed in zip(p, (3, 4)):
        k1, p1, n1 = gen16.sample_power(seed, nbins=12)
        np.testing.assert_array_equal(row, p1)
        np.testing.assert_array_equal(n, n1)
    # above K5's 128 bins the spectrum is sampled and binned instead
    kw, pw, nw = gen16.sample_power(3, nbins=130)
    re, im = sampler.sample_spectrum(3, gen16.state.table, gen16.shape, SPACING)
    want = stats.spectrum_power((re, im), gen16.shape, SPACING, 130)
    np.testing.assert_array_equal(pw, want[1])
    assert np.nansum(nw) == 16 ** 3 - 1


def test_pallas_scene_rejects_noise_io_and_keeps_its_table(gen16):
    with pytest.raises(ValueError, match="sampler='pallas'"):
        gen16.generate_noise(1)
    with pytest.raises(ValueError, match="sampler='pallas'"):
        gen16.generate_from_noise(np.zeros((2, 16, 16, 9), np.float32))
    gj = rf.Generator(16, 16, 16, grid_spacing=SPACING, sampler="pallas")
    np.testing.assert_array_equal(gen16.state.table.knots.numpy(),
                                  sampler.flat_knots(gj._pallas_table[2]))
    assert gen16.state.table.lk0 == gj._pallas_table[0]
    assert gen16.state.table.dlk == gj._pallas_table[1]


def test_pallas_scene_accepts_any_pipeline_and_rejects_meshes():
    rft.Generator(16, 16, 16, grid_spacing=SPACING, device="cpu",
                  sampler="pallas", pipeline="staged")
    with pytest.raises(NotImplementedError, match="pencil mesh"):
        rft.Generator(16, 16, 16, grid_spacing=SPACING, device="cpu",
                      sampler="pallas",
                      mesh=make_pencil_mesh(data=1, spx=2, spy=2))
    with pytest.raises(TypeError, match="SlabMesh"):
        rft.Generator(16, 16, 16, grid_spacing=SPACING, sampler="pallas",
                      mesh=object())


# ---- 7. the statistical gate -----------------------------------------------------

def test_sampler_gate_passes_on_the_cpu():
    out = sampler_gate.run_checks(n_seeds=300, shape=(16, 16, 16), device="cpu")
    assert out["per_mode_max"] < out["per_mode_tol"]
    assert abs(out["kurtosis"] - 3.0) < 0.1


def test_gate_projection_matches_the_oracle():
    from randomfield_tpu.validate import oracle

    rng = np.random.default_rng(0)
    c = rng.normal(size=(6, 4, 5)) + 1j * rng.normal(size=(6, 4, 5))
    np.testing.assert_array_equal(
        sampler_gate.hermitian_projection(c, 8),
        oracle.oracle_symmetrize(c, nz=8, scale_self_conjugate=False))
