"""The port's render slice vs the JAX package (randomfield_tpu_torch.Generator).

(a) tight: the JAX package's own pieces (canonical draws, symmetrization,
    the Pallas sigma-scale kernel in interpret mode, numpy's irfftn) on
    the state the port is given through load_reference_state;
(b) the public API: both Generators at the same seed;
(c) generate_from_noise vs the float64 oracle on the same draws;
(d) the port imports no JAX;
(e) predicted_variance vs the JAX package's;
(f) shapes the CUDA kernels do not take raise at construction.
"""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import randomfield_tpu as rf  # noqa: E402
import randomfield_tpu_torch as rft  # noqa: E402
from randomfield_tpu.ops import pallas_sampler as jps  # noqa: E402
from randomfield_tpu.ops import sample as jsample  # noqa: E402
from randomfield_tpu.ops import transform as jtransform  # noqa: E402
from randomfield_tpu.validate import oracle  # noqa: E402
from randomfield_tpu_torch.ops import sampler  # noqa: E402
from randomfield_tpu_torch.parallel import mesh as pmesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPACING = 16.0
# (a): the same draws and the same table through the same float32 algebra;
# two FFT libraries' rounding remains
TIGHT = 1e-5
# (b): the JAX CPU path scales by its per-mode sigma grid, the port by the
# uniform table; their 3e-4 per-mode bound (tests/test_staged.py) carried
# through the inverse FFT
PUBLIC = 1e-3


def _max_rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def jax_gen32():
    return rf.Generator(32, 32, 32, grid_spacing=SPACING)


@pytest.mark.parametrize("shape", [(32, 32, 32), (16, 32, 24)])
@pytest.mark.parametrize("smoothing", [0.0, 10.0])
def test_slice_matches_jax_pieces_tight(shape, smoothing):
    seed = 3
    gj = rf.Generator(*shape, grid_spacing=SPACING)
    weights = np.asarray(gj.state.lightcone_weights)
    tab = jps.make_sigma_table(gj._aux["power"], shape, SPACING, layout="xyz")
    re, im = jsample.unit_draws_reim(jax.random.key(seed), shape)
    inv = jnp.float32(0.7071067811865476)
    re, im = jtransform.symmetrize_with_shape_reim(re * inv, im * inv, shape[2])
    re, im = jps.scale_shard_pallas_reim(
        re, im, jnp.float32(smoothing), jnp.float32(tab[0]),
        jnp.float32(1.0 / tab[1]), jnp.asarray(tab[2]), 0, 0, shape, SPACING,
        interpret=True,
    )
    c = np.asarray(re).astype(np.float64) + 1j * np.asarray(im)
    want = np.fft.irfftn(c, s=shape, axes=(0, 1, 2), norm="forward") * weights

    g = rft.Generator(*shape, grid_spacing=SPACING, device="cpu")
    g.state = sampler.load_reference_state(
        tab[2], tab[0], tab[1], weights, gj.power.k, gj.power.Pk)
    got = g.generate_delta_field(seed, smoothing_length=smoothing)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert _max_rel(got.numpy(), want) <= TIGHT


@pytest.mark.smoke
@pytest.mark.parametrize("smoothing,lightcone", [(0.0, True), (8.0, False)])
def test_public_api_matches_jax(jax_gen32, smoothing, lightcone):
    want = np.asarray(jax_gen32.generate_delta_field(
        5, smoothing_length=smoothing, apply_lightcone=lightcone))
    g = rft.Generator(32, 32, 32, grid_spacing=SPACING, device="cpu")
    got = g.generate_delta_field(5, smoothing_length=smoothing,
                                 apply_lightcone=lightcone).numpy()
    assert _max_rel(got, want) <= PUBLIC


def test_scene_matches_jax(jax_gen32):
    g = rft.Generator(32, 32, 32, grid_spacing=SPACING, device="cpu")
    np.testing.assert_array_equal(g.redshifts, jax_gen32.redshifts)
    np.testing.assert_array_equal(g.growth_function, jax_gen32.growth_function)
    np.testing.assert_array_equal(g.state.lightcone_weights.numpy(),
                                  np.asarray(jax_gen32.state.lightcone_weights))
    np.testing.assert_array_equal(g.power.k, jax_gen32.power.k)
    np.testing.assert_array_equal(g.power.Pk, jax_gen32.power.Pk)
    assert (g.k_min, g.k_max) == (jax_gen32.k_min, jax_gen32.k_max)
    assert g.shape == jax_gen32.shape and g.grid_spacing == SPACING


@pytest.mark.parametrize("cosmology,power", [("Planck18", "eh98"),
                                             ({"H0": 70.0}, "bbks")])
def test_named_models_match_jax(cosmology, power):
    shape = (16, 16, 16)
    gj = rf.Generator(*shape, grid_spacing=SPACING, cosmology=cosmology,
                      power=power)
    g = rft.Generator(*shape, grid_spacing=SPACING, cosmology=cosmology,
                      power=power, device="cpu")
    np.testing.assert_allclose(g.power.Pk, gj.power.Pk, rtol=1e-12)
    np.testing.assert_allclose(g.growth_function, gj.growth_function, rtol=1e-12)
    got = g.generate_delta_field(1).numpy()
    assert _max_rel(got, np.asarray(gj.generate_delta_field(1))) <= PUBLIC


@pytest.mark.parametrize("shape", [(8, 8, 8), (6, 4, 10), (8, 6, 9)])
@pytest.mark.parametrize("smoothing", [0.0, 3.0])
def test_generate_from_noise_matches_oracle(shape, smoothing):
    spacing = 4.0
    k = np.logspace(-3, 1.5, 300)
    pk = 2e4 * (k / 0.05) ** -2.0
    rng = np.random.RandomState(0)
    draws = rng.normal(size=(2, shape[0], shape[1], shape[2] // 2 + 1))
    draws = draws.astype(np.float32)
    g = rft.Generator(*shape, grid_spacing=spacing, power=(k, pk), device="cpu")
    got = g.generate_from_noise(draws, smoothing_length=smoothing,
                                apply_lightcone=False).numpy()
    want = oracle.render_from_noise(
        draws[0].astype(np.float64), draws[1].astype(np.float64), shape,
        spacing, (k, pk), smoothing_length=smoothing,
    )
    scale = np.std(want)
    # tests/test_oracle_parity.py's bar as it stands: the table sigma
    # (linear in log10 k over >= 513 knots) is within float32 rounding of
    # the oracle's exact sigma for this smooth power law
    np.testing.assert_allclose(got, want, atol=2e-5 * scale + 1e-7, rtol=2e-4)


def test_noise_roundtrip_and_determinism():
    g = rft.Generator(16, 8, 12, grid_spacing=SPACING, device="cpu")
    noise = g.generate_noise(4)
    assert tuple(noise.shape) == (2, 16, 8, 7)
    want_re, want_im = jsample.unit_draws_reim(jax.random.key(4), (16, 8, 12))
    np.testing.assert_allclose(noise[0].numpy(), np.asarray(want_re), rtol=1e-6)
    np.testing.assert_allclose(noise[1].numpy(), np.asarray(want_im), rtol=1e-6)
    field = g.generate_delta_field(4, smoothing_length=5.0)
    assert torch.equal(g.generate_from_noise(noise, smoothing_length=5.0), field)
    assert torch.equal(g.generate_delta_field(4, smoothing_length=5.0), field)
    batch = g.generate_delta_fields([4, 9], smoothing_length=5.0)
    assert tuple(batch.shape) == (2, 16, 8, 12)
    assert torch.equal(batch[0], field)
    assert not torch.equal(batch[1], field)
    with pytest.raises(ValueError, match="draws must have shape"):
        g.generate_from_noise(noise[:, :8])


@pytest.mark.smoke
def test_port_imports_no_jax():
    code = (
        "import sys; import randomfield_tpu_torch as rft; "
        "import randomfield_tpu_torch.validate.sampler_gate; "
        "g = rft.Generator(16, 16, 16, grid_spacing=8.0, device='cpu'); "
        "d = g.generate_delta_field(0); "
        "assert tuple(d.shape) == (16, 16, 16), d.shape; "
        "p = rft.Generator(16, 16, 16, grid_spacing=8.0, device='cpu', "
        "sampler='pallas'); "
        "k, ph, n = p.sample_power(0, nbins=8); "
        "p.calculate_power(p.generate_delta_field(0), nbins=8); "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'randomfield_tpu' or m.startswith('randomfield_tpu.')]; "
        "assert not bad, bad; print('ok')"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("smoothing,lightcone", [(0.0, False), (0.0, True),
                                                 (10.0, True)])
def test_predicted_variance_matches_jax(jax_gen32, smoothing, lightcone):
    g = rft.Generator(32, 32, 32, grid_spacing=SPACING, device="cpu")
    want = jax_gen32.predicted_variance(smoothing, lightcone)
    got = g.predicted_variance(smoothing, lightcone)
    assert abs(got / want - 1.0) <= 1e-3


@pytest.mark.parametrize("shape", [(48, 32, 32), (32, 32, 33), (32, 32, 24),
                                   (8, 32, 32), (4096, 16, 16)])
def test_cuda_rejects_shapes_the_kernels_do_not_take(shape):
    # the check runs before any tensor is placed, so it needs no card
    with pytest.raises(ValueError, match="not supported on CUDA"):
        rft.Generator(*shape, grid_spacing=SPACING, device="cuda")


@pytest.mark.parametrize("kw,what", [
    (dict(sampler="nested", mesh=pmesh.make_pencil_mesh(spx=2, spy=2)),
     "pencil"),
    (dict(mesh=pmesh.make_pencil_mesh(spx=2, spy=2)), "mesh"),
])
def test_unported_options_raise(kw, what):
    with pytest.raises(NotImplementedError) as err:
        rft.Generator(16, 16, 16, grid_spacing=SPACING, device="cpu", **kw)
    assert what in str(err.value) and "ROADMAP.md" in str(err.value)
    with pytest.raises(TypeError, match="SlabMesh"):
        rft.Generator(16, 16, 16, grid_spacing=SPACING, mesh=object())


def test_unknown_options_raise():
    with pytest.raises(ValueError, match="unknown sampler"):
        rft.Generator(16, 16, 16, grid_spacing=SPACING, device="cpu",
                      sampler="mystery")
    with pytest.raises(ValueError, match="unknown pipeline"):
        rft.Generator(16, 16, 16, grid_spacing=SPACING, device="cpu",
                      pipeline="mystery")
