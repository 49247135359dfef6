"""The port's derived fields (ops/derived.py, models/web.py, the Generator's
seed-direct methods) vs the JAX package.

(a) KD's plain version against the JAX package's apply_kernel_inline on one
    spectrum, and KD's in-thread k vectors (their host mirror) against the
    plain version's;
(b) the field-first helpers and 2LPT on one field;
(c) the seed-direct methods at the same seed as the JAX Generator, for the
    streams both packages share (threefry, nested);
(d) the identities: -div(psi) = delta on a band-limited field, trace(T) =
    delta, for every sampler;
(e) the T-web classes on one tidal input, and the refusals.
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
from randomfield_tpu.models import web as jweb  # noqa: E402
from randomfield_tpu.ops import derived as jderived  # noqa: E402
from randomfield_tpu.ops import grid as jgrid  # noqa: E402
from randomfield_tpu_torch.models import cosmology, web  # noqa: E402
from randomfield_tpu_torch.ops import derived, grid, transform  # noqa: E402
from randomfield_tpu_torch.parallel import mesh as pmesh  # noqa: E402

SPACING = 16.0
SHAPE = (32, 32, 32)
# tests/test_torch_generator.py's bar for the public API
PUBLIC = 1e-3
# one field through both packages' transforms: float32 FFTs of two libraries
FIELD = 1e-5
# KD's plain version vs the JAX kernel on one spectrum: the same float32
# operations (XLA may contract or reorder a product)
KERNEL = 1e-6
KINDS = ([("scalar", 0)] + [("grad", a) for a in range(3)]
         + [("tidal", c) for c in range(6)] + [("kaiser", a) for a in range(3)])
METHODS = [("generate_potential", dict(z=0.5)),
           ("generate_displacement", {}),
           ("generate_displacement", dict(order=2, component=1)),
           ("generate_velocity", dict(z=1.0, component=2)),
           ("generate_tidal_field", {}),
           ("generate_kaiser_field", dict(z=0.3, bias=1.5))]


def _max_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def jax_gens():
    return {name: rf.Generator(*SHAPE, grid_spacing=SPACING, sampler=name)
            for name in ("threefry", "nested")}


@pytest.fixture(scope="module")
def delta():
    g = rft.Generator(*SHAPE, grid_spacing=SPACING, device="cpu")
    return g.generate_delta_field(11, smoothing_length=20.0,
                                  apply_lightcone=False)


@pytest.mark.parametrize("shape", [(16, 16, 16), (16, 12, 9), (8, 6, 10)])
@pytest.mark.parametrize("zero", [False, True])
def test_kernel_vectors_mirror_the_plain_vectors(shape, zero):
    got = derived.kernel_vectors(shape, SPACING, zero_nyquist=zero)
    want = (derived.grad_kvectors(shape, SPACING) if zero
            else grid.kvectors(shape, SPACING))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    jax_want = (jderived._grad_kvectors(shape, SPACING, jnp.float32) if zero
                else jgrid.kvectors(shape, SPACING, jnp.float32))
    for g, w in zip(got, jax_want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("shape", [(16, 16, 16), (16, 12, 9)])
@pytest.mark.parametrize("kind,comp", KINDS)
def test_apply_kernel_plain_matches_jax(shape, kind, comp):
    rng = np.random.default_rng(3)
    nzh = shape[2] // 2 + 1
    re = rng.standard_normal((shape[0], shape[1], nzh)).astype(np.float32)
    im = rng.standard_normal((shape[0], shape[1], nzh)).astype(np.float32)
    pref = (1.5, 0.6) if kind == "kaiser" else -0.37
    want = np.asarray(jderived.apply_kernel_inline(
        jnp.asarray(re) + 1j * jnp.asarray(im), shape, SPACING, "xyz", kind,
        comp, pref))
    got = derived.apply_kernel(torch.as_tensor(re), torch.as_tensor(im),
                               shape, SPACING, kind, comp, pref)
    assert _max_rel(got[0].numpy(), want.real) <= KERNEL
    assert _max_rel(got[1].numpy(), want.imag) <= KERNEL


def test_field_first_helpers_match_jax(delta):
    d = jnp.asarray(delta.numpy())
    cases = [
        (derived.delta_to_potential(delta, SPACING, "Planck13", 0.5),
         jderived.delta_to_potential(d, SPACING, "Planck13", 0.5)),
        (derived.delta_to_displacement(delta, SPACING),
         jderived.delta_to_displacement(d, SPACING)),
        (derived.delta_to_velocity(delta, SPACING, "Planck13", 1.0),
         jderived.delta_to_velocity(d, SPACING, "Planck13", 1.0)),
        (derived.delta_to_tidal(delta, SPACING),
         jderived.delta_to_tidal(d, SPACING)),
        (derived.delta_to_tidal(delta, SPACING, component=4),
         jderived.delta_to_tidal(d, SPACING, component=4)),
        (derived.delta_to_displacement_2lpt(delta, SPACING),
         jderived.delta_to_displacement_2lpt(d, SPACING)),
    ]
    for got, want in cases:
        assert tuple(got.shape) == tuple(want.shape)
        assert _max_rel(got.numpy(), want) <= FIELD


@pytest.mark.parametrize("name", ["threefry", "nested"])
@pytest.mark.parametrize("method,kw", METHODS)
def test_seed_direct_fields_match_jax(jax_gens, name, method, kw):
    g = rft.Generator(*SHAPE, grid_spacing=SPACING, sampler=name,
                      device="cpu")
    got = getattr(g, method)(4, smoothing_length=8.0, **kw)
    want = getattr(jax_gens[name], method)(4, smoothing_length=8.0, **kw)
    assert tuple(got.shape) == tuple(np.shape(want))
    assert _max_rel(got.numpy(), want) <= PUBLIC


@pytest.mark.parametrize("name", ["threefry", "pallas", "nested"])
def test_divergence_and_trace_give_delta(name):
    # the gradient zeroes the Nyquist modes, so -div(psi) = delta holds on a
    # band-limited (smoothed) field: the bar of tests/test_derived.py
    g = rft.Generator(*SHAPE, grid_spacing=SPACING, sampler=name,
                      device="cpu")
    s = 10.0 * SPACING
    d = g.generate_delta_field(6, smoothing_length=s, apply_lightcone=False)
    psi = g.generate_displacement(6, smoothing_length=s)
    kx, ky, kz = grid.kvectors(SHAPE, SPACING, torch.float64)
    div = torch.zeros((SHAPE[0], SHAPE[1], SHAPE[2] // 2 + 1),
                      dtype=torch.complex128)
    for comp, k in zip(psi, (kx[:, None, None], ky[None, :, None],
                             kz[None, None, :])):
        div += 1j * k * torch.fft.rfftn(comp.double())
    got = -torch.fft.irfftn(div, s=SHAPE).numpy()
    want = d.double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * want.std())
    tidal = g.generate_tidal_field(6, smoothing_length=s)
    trace = (tidal[0] + tidal[1] + tidal[2]).double().numpy()
    np.testing.assert_allclose(trace, want, rtol=1e-3, atol=1e-4 * want.std())


def test_pallas_derived_fields_draw_k1_whatever_the_variant(monkeypatch):
    # the derived fields of a pallas scene draw its v5 spectrum (K1): the
    # staged switch, which picks v6's own stream for renders, moves nothing
    g = rft.Generator(16, 16, 16, grid_spacing=SPACING, sampler="pallas",
                      device="cpu")
    want = g.generate_potential(3, smoothing_length=20.0)
    monkeypatch.setenv("RF_STAGED_PIPELINE", "v6")
    assert torch.equal(g.generate_potential(3, smoothing_length=20.0), want)


def test_classify_web_matches_jax_on_one_tidal_input(delta):
    tidal = derived.delta_to_tidal(delta, SPACING)
    t = jnp.asarray(tidal.numpy())
    lam = web.eigenvalues_sym3(tidal).numpy()
    jlam = np.asarray(jweb.eigenvalues_sym3(t))
    np.testing.assert_allclose(lam, jlam, rtol=0,
                               atol=1e-5 * np.abs(jlam).max())
    for threshold in (0.0, 0.2 * float(delta.std())):
        got = web.classify_web(tidal, threshold).numpy()
        want = np.asarray(jweb.classify_web(t, threshold))
        # a voxel whose eigenvalue lies within rounding of the threshold
        # may count either way (a tie); every other voxel agrees
        tie = np.any(np.abs(jlam - threshold)
                     <= 1e-5 * np.abs(jlam).max(), axis=0)
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got[~tie], want[~tie])
        assert tie.mean() < 1e-3
        np.testing.assert_allclose(web.web_fractions(torch.as_tensor(got)),
                                   jweb.web_fractions(want), atol=1e-3)


def test_growth_rate_and_rfftn(delta):
    for name in ("Planck13", "Planck18"):
        ported = cosmology.create_cosmology(name)
        ref = rf.models.cosmology.create_cosmology(name)
        for z in (0.0, 0.5, 3.0):
            assert abs(float(ported.growth_rate(z))
                       - float(ref.growth_rate(z))) <= 1e-12
    re, im = transform.rfftn(delta)
    want = np.fft.rfftn(delta.numpy().astype(np.float64))
    assert _max_rel(re.numpy(), want.real) <= FIELD
    assert _max_rel(im.numpy(), want.imag) <= FIELD
    assert transform.is_hermitian(re, im, SHAPE[2], atol=1e-4)
    im[1, 0, 0] += 1.0  # (1, 0) and (31, 0) of kz = 0 no longer conjugate
    assert not transform.is_hermitian(re, im, SHAPE[2], atol=1e-4)


def test_derived_refusals():
    g = rft.Generator(16, 16, 16, grid_spacing=SPACING, device="cpu")
    with pytest.raises(ValueError, match="order"):
        g.generate_displacement(1, order=3)
    with pytest.raises(ValueError, match="bias"):
        g.generate_kaiser_field(1, bias=0.0)
    with pytest.raises(ValueError, match="component"):
        g.generate_tidal_field(1, component=6)
    with pytest.raises(ValueError, match="kind"):
        derived.apply_kernel(torch.zeros(16, 16, 9), torch.zeros(16, 16, 9),
                             (16, 16, 16), SPACING, "curl")
    # a one-rank mesh renders the single-device fields; a pallas mesh scene
    # renders plain fields only, as in the JAX package
    m = rft.Generator(16, 16, 16, grid_spacing=SPACING,
                      mesh=pmesh.make_mesh(space=1, device="cpu"))
    for method in ("generate_potential", "generate_displacement",
                   "generate_tidal_field"):
        assert torch.equal(getattr(m, method)(1), getattr(g, method)(1))
    m = rft.Generator(16, 16, 16, grid_spacing=SPACING, sampler="pallas",
                      mesh=pmesh.make_mesh(space=1, device="cpu"))
    for method in ("generate_potential", "generate_displacement",
                   "generate_tidal_field"):
        with pytest.raises(ValueError, match="plain renders only"):
            getattr(m, method)(1)
