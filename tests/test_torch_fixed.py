"""The port's fixed & paired fields, sigmas and field_moments vs the JAX package.

(a) generate_fixed_field(s) at the same seed as the JAX Generator, both
    streams, flip or not;
(b) the fixed field's contract: |c_k| is the amplitude, the variance is the
    prediction within 1e-4, the paired field is the exact negation;
(c) the sigma grid and field_moments against the JAX package's;
(d) the refusals, as the JAX package's.
"""

import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import randomfield_tpu as rf  # noqa: E402
import randomfield_tpu_torch as rft  # noqa: E402
from randomfield_tpu.validate import stats as jstats  # noqa: E402
from randomfield_tpu_torch.ops import sample, sampler, threefry  # noqa: E402
from randomfield_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from randomfield_tpu_torch.validate import stats  # noqa: E402

SPACING = 16.0
# tests/test_torch_generator.py's bar for the public API
PUBLIC = 1e-3
# tests/test_fixed.py's bar: the fixed field's variance is the prediction to
# float32 rounding
VAR_TOL = 1e-4
# tests/test_torch_kernels.py's bar for the sigma grid: float64 host
# evaluation on both sides, rounded to float32
SIGMA_RTOL = 2e-6
SAMPLERS = ["threefry", "nested"]


def _max_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def jax_gens():
    return {name: rf.Generator(32, 32, 32, grid_spacing=SPACING,
                               sampler=name)
            for name in SAMPLERS}


@pytest.mark.parametrize("name", SAMPLERS)
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("smoothing,lightcone", [(0.0, True), (10.0, False)])
def test_fixed_field_matches_jax(jax_gens, name, flip, smoothing, lightcone):
    want = jax_gens[name].generate_fixed_field(
        2, smoothing_length=smoothing, apply_lightcone=lightcone, flip=flip)
    g = rft.Generator(32, 32, 32, grid_spacing=SPACING, sampler=name,
                      device="cpu")
    got = g.generate_fixed_field(2, smoothing_length=smoothing,
                                 apply_lightcone=lightcone, flip=flip)
    assert got.dtype == torch.float32 and tuple(got.shape) == (32, 32, 32)
    assert _max_rel(got.numpy(), want) <= PUBLIC


@pytest.mark.parametrize("name", SAMPLERS)
@pytest.mark.parametrize("smoothing", [0.0, 12.0])
def test_fixed_variance_and_pairing(name, smoothing):
    g = rft.Generator(32, 32, 32, grid_spacing=SPACING, sampler=name,
                      device="cpu")
    fixed = g.generate_fixed_field(3, smoothing, apply_lightcone=False)
    paired = g.generate_fixed_field(3, smoothing, apply_lightcone=False,
                                    flip=True)
    assert torch.equal(paired, -fixed)
    _, var = stats.field_moments(fixed)
    assert abs(var / g.predicted_variance(smoothing) - 1.0) <= VAR_TOL
    batch = g.generate_fixed_fields([3, 4], smoothing, apply_lightcone=False)
    assert torch.equal(batch[0], fixed)
    assert torch.equal(batch[1], g.generate_fixed_field(
        4, smoothing, apply_lightcone=False))


@pytest.mark.parametrize("nested", [False, True])
@pytest.mark.parametrize("shape", [(16, 16, 16), (16, 8, 12)])
def test_fixed_spectrum_modulus_is_the_amplitude(nested, shape):
    table = sampler.make_sigma_table(rft.load_default_power(), shape, SPACING)
    key = threefry.key_from_seed(5)
    re, im = sample.sample_fixed_spectrum(key, table, shape, SPACING, 6.0,
                                          nested=nested)
    amp = sampler.sigma_amplitude(table, shape, SPACING, 6.0)
    mag = torch.sqrt(re * re + im * im)
    assert float((mag - amp).abs().max()) <= 3e-7 * float(amp.max())
    # a self-conjugate mode is its sign times the amplitude
    for kz in (0, shape[2] // 2):
        for x in (0, shape[0] // 2):
            for y in (0, shape[1] // 2):
                assert float(im[x, y, kz]) == 0.0
                assert abs(float(re[x, y, kz])) == float(amp[x, y, kz])


def test_unit_phase():
    re = torch.tensor([3.0, 0.0, -2.0, 0.0])
    im = torch.tensor([4.0, 0.0, 0.0, -0.5])
    sample.unit_phase(re, im)
    # each quotient correctly rounded; |z| = 0 gives 1, a real z its sign
    np.testing.assert_array_equal(re.numpy(),
                                  np.float32([0.6, 1.0, -1.0, 0.0]))
    np.testing.assert_array_equal(im.numpy(),
                                  np.float32([0.8, 0.0, 0.0, -1.0]))


@pytest.mark.parametrize("name", SAMPLERS)
def test_sigmas_match_jax(jax_gens, name):
    g = rft.Generator(32, 32, 32, grid_spacing=SPACING, sampler=name,
                      device="cpu")
    got = g.sigmas
    assert got is g.sigmas  # built once
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_gens[name].sigmas),
                               rtol=SIGMA_RTOL, atol=0)


@pytest.mark.parametrize("shape", [(32, 32, 32), (16, 24, 10)])
def test_field_moments_match_jax(shape):
    rng = np.random.default_rng(1)
    field = (0.3 + 2.0 * rng.standard_normal(shape)).astype(np.float32)
    mean, var = stats.field_moments(torch.as_tensor(field))
    jmean, jvar = jstats.field_moments(jnp.asarray(field))
    assert abs(mean - jmean) <= 1e-6 * abs(jmean)
    assert abs(var - jvar) <= 1e-6 * jvar
    # a one-rank slab mesh sums its one slab: the single-device moments
    mmean, mvar = stats.field_moments(
        torch.as_tensor(field), mesh=pmesh.make_mesh(space=1, device="cpu"))
    assert abs(mmean - mean) <= 1e-12 * abs(mean)
    assert abs(mvar - var) <= 1e-12 * var
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        stats.field_moments(torch.as_tensor(field),
                            mesh=pmesh.make_pencil_mesh(spx=2, spy=2))


def test_fixed_refusals_match_jax():
    for kw in (dict(sampler="pallas"), dict(pipeline="staged")):
        g = rft.Generator(16, 16, 16, grid_spacing=SPACING, device="cpu",
                          **kw)
        with pytest.raises(ValueError, match="fixed fields"):
            g.generate_fixed_field(1)
        with pytest.raises(ValueError, match="fixed fields"):
            g.generate_fixed_fields([1, 2])
    # a one-rank mesh renders the single-device fixed field and sigmas; a
    # pallas mesh scene refuses fixed fields as one device does
    one = rft.Generator(16, 16, 16, grid_spacing=SPACING, device="cpu")
    g = rft.Generator(16, 16, 16, grid_spacing=SPACING,
                      mesh=pmesh.make_mesh(space=1, device="cpu"))
    assert torch.equal(g.generate_fixed_field(1, flip=True),
                       one.generate_fixed_field(1, flip=True))
    assert torch.equal(g.sigmas, one.sigmas)
    g = rft.Generator(16, 16, 16, grid_spacing=SPACING, sampler="pallas",
                      mesh=pmesh.make_mesh(space=1, device="cpu"))
    with pytest.raises(ValueError, match="fixed fields"):
        g.generate_fixed_field(1)
