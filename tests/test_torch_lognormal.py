"""The port's lognormal fields (models/lognormal.py, K4L's plain version)
vs the JAX package.

(a) transformed_power on the device (the CPU here) vs the reference's host
    float64 version: the table within 1e-5 relative plus 1e-6 of its peak
    (the float32 FFT noise floor of both, where P_G is clipped to ~0),
    sigma_g2 and clipped_fraction within 1e-6; KB's float32 edge search
    moves no mode to another bin at 32^3 or 64^3 (counted here);
(b) the exp map on one Gaussian field, and the fields at the same seed: on
    the same sigma table as the JAX package's staged pieces (the tight
    slice of tests/test_torch_generator.py) within 1e-5 max|delta|, through
    the public API within 1e-3 (the JAX CPU path scales by its sigma grid);
(c) the predictions, the reference's statistical gates, and the refusals.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from randomfield_tpu.models import lognormal as jl  # noqa: E402
from randomfield_tpu.ops import grid as jgrid  # noqa: E402
from randomfield_tpu.ops import pallas_sampler as jps  # noqa: E402
from randomfield_tpu.ops import power as jpower  # noqa: E402
from randomfield_tpu.ops import sample as jsample  # noqa: E402
from randomfield_tpu.ops import transform as jtransform  # noqa: E402
from randomfield_tpu_torch.models import lognormal as tl  # noqa: E402
from randomfield_tpu_torch.ops import fft, sampler  # noqa: E402
from randomfield_tpu_torch.validate import stats  # noqa: E402

SPACING = 8.0
# the same draws and table through the same float32 algebra (two FFT
# libraries), then expm1
TIGHT = 1e-5
# the JAX CPU path scales by its per-mode sigma grid, the port by the
# uniform table (tests/test_torch_generator.py's PUBLIC)
PUBLIC = 1e-3


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _target(amp_scale=1.0):
    table = jpower.load_default_power()
    return jpower.PowerTable(table.k, table.Pk * amp_scale)


@pytest.mark.parametrize("shape,spacing", [((32, 32, 32), 8.0),
                                           ((32, 32, 32), 16.0),
                                           ((64, 64, 64), 4.0),
                                           ((24, 16, 20), 8.0)])
def test_transformed_power_matches_jax(shape, spacing):
    want, winfo = jl.transformed_power(_target(), shape, spacing)
    got, info = tl.transformed_power(_target(), shape, spacing,
                                     device="cpu")
    np.testing.assert_allclose(got.k, want.k, rtol=1e-7)
    err = np.abs(got.Pk - want.Pk)
    assert np.all(err <= 1e-5 * np.abs(want.Pk) + 1e-6 * want.Pk.max())
    assert info["sigma_g2"] == pytest.approx(winfo["sigma_g2"], rel=1e-6)
    assert info["sigma2"] == pytest.approx(winfo["sigma2"], rel=1e-6)
    assert abs(info["clipped_fraction"] - winfo["clipped_fraction"]) < 1e-6


@pytest.mark.parametrize("n,spacing", [(32, 8.0), (64, 4.0)])
def test_kb_float32_edges_move_no_mode(n, spacing):
    # the reference searches its 256 edges in float64, KB in float32: on
    # these grids no |k| lies between an edge and its float32 rounding
    shape = (n, n, n)
    km = np.asarray(jgrid.kmag(shape, spacing, jnp.float32))
    kmin, kmax = jgrid.get_k_bounds(shape, spacing)
    edges = np.logspace(np.log10(kmin * 0.999), np.log10(kmax * 1.001), 257)
    i64 = np.searchsorted(edges, km.astype(np.float64)) - 1
    i32 = np.searchsorted(edges.astype(np.float32), km) - 1
    assert int((i64 != i32).sum()) == 0


def test_transformed_power_limits_and_refusal():
    n, spacing = 32, 8.0
    table = _target(1e-3)
    pg, info = tl.transformed_power(table, (n, n, n), spacing, device="cpu")
    k = np.logspace(np.log10(pg.k[1] * 1.01), np.log10(pg.k[-2] * 0.99), 40)
    p_target = np.interp(np.log10(k), np.log10(table.k), table.Pk)
    p_gauss = np.interp(np.log10(k), np.log10(pg.k), pg.Pk)
    np.testing.assert_allclose(p_gauss, p_target, rtol=0.05)
    assert info["clipped_fraction"] < 1e-6
    assert info["sigma_g2"] == pytest.approx(np.log1p(info["sigma2"]),
                                             rel=1e-6)
    k = np.logspace(-4, 2, 800)
    pk = 5e7 * np.exp(-((np.log(k / 0.05)) ** 2) * 8)
    for mod, kw in ((tl, dict(device="cpu")), (jl, {})):
        with pytest.raises(ValueError, match="lognormal"):
            mod.transformed_power((k, pk), (32, 32, 32), 8.0, **kw)


@pytest.mark.parametrize("bias,lightcone", [(1.0, False), (1.7, True)])
def test_exp_map_matches_jax(bias, lightcone):
    rng = np.random.default_rng(2)
    g = rng.normal(scale=0.7, size=(16, 12, 20)).astype(np.float32)
    w = np.linspace(1.0, 0.6, 20) if lightcone else None
    got = tl.gaussian_to_lognormal(torch.as_tensor(g), 0.49, w, bias)
    want = np.asarray(jl.gaussian_to_lognormal(jnp.asarray(g), 0.49, w, bias))
    assert _max_rel(got.numpy(), want) <= 1e-6


def test_lognormal_tail_plain_is_the_exp_map_of_k4():
    rng = np.random.default_rng(3)
    re = torch.as_tensor(rng.normal(size=(6, 4, 17)).astype(np.float32))
    im = torch.as_tensor(rng.normal(size=(6, 4, 17)).astype(np.float32))
    im[..., 0] = 0.0
    im[..., -1] = 0.0
    a = torch.linspace(0.01, 0.02, 32)
    c = torch.linspace(0.0, 0.1, 32)
    got = fft.c2r_tail_exp(re, im, 32, a, c)
    want = torch.expm1(fft.c2r_tail(re, im, 32, a) - c)
    assert torch.equal(got, want)
    emulated = torch.expm1(fft.c2r_tail_emulated(re, im, 32, a) - c)
    assert _max_rel(got, emulated) <= 5e-6


TIGHT_SHAPE = (16, 16, 32)


@pytest.fixture(scope="module")
def tight_scene():
    """The JAX package's uniform sigma table of its transformed spectrum,
    its plane weights, and a port LognormalGenerator put on that table."""
    gj = jl.LognormalGenerator(*TIGHT_SHAPE, grid_spacing=SPACING)
    gauss = gj.gaussian
    tab = jps.make_sigma_table(gauss._aux["power"], TIGHT_SHAPE, SPACING,
                               layout="xyz")
    weights = np.asarray(gauss.state.lightcone_weights)
    gt = tl.LognormalGenerator(*TIGHT_SHAPE, SPACING, device="cpu")
    gt.gaussian.state = sampler.load_reference_state(
        tab[2], tab[0], tab[1], weights, gauss.power.k, gauss.power.Pk)
    return tab, weights, gt


def _tight_pair(scene, method, seed, kw):
    """(port field, JAX field): both packages' lognormal renders on the
    JAX package's uniform sigma table of its transformed spectrum."""
    tab, weights, gt = scene
    shape = TIGHT_SHAPE
    smoothing = kw.get("smoothing_length", 0.0)
    lightcone = kw.get("apply_lightcone", True)
    got = getattr(gt, method)(seed, **kw).numpy()
    draw = jsample.unit_draws_reim(jax.random.key(seed), shape)
    inv = jnp.float32(0.7071067811865476)
    re, im = jtransform.symmetrize_with_shape_reim(draw[0] * inv,
                                                   draw[1] * inv, shape[2])
    if method == "generate_fixed_field":
        mag = jnp.sqrt(re * re + im * im)
        safe = jnp.where(mag > 0, mag, 1.0)
        re = jnp.where(mag > 0, re / safe, 1.0)
        im = jnp.where(mag > 0, im / safe, 0.0)
        gain = -1.0 if kw.get("flip") else 1.0
        re, im = re * gain, im * gain
    re, im = jps.scale_shard_pallas_reim(
        re, im, jnp.float32(smoothing), jnp.float32(tab[0]),
        jnp.float32(1.0 / tab[1]), jnp.asarray(tab[2]), 0, 0, shape, SPACING,
        interpret=True)
    c = np.asarray(re).astype(np.float64) + 1j * np.asarray(im)
    g = np.fft.irfftn(c, s=shape, axes=(0, 1, 2), norm="forward")
    if lightcone:
        g = g * weights
    var = gt.gaussian.predicted_variance(smoothing_length=smoothing)
    want = np.asarray(jl.gaussian_to_lognormal(
        jnp.asarray(g, jnp.float32), var,
        np.asarray(gt.growth_function) if lightcone else None,
        kw.get("bias", 1.0)))
    return got, want


@pytest.mark.parametrize("method,kw", [
    ("generate_delta_field", {}),
    ("generate_delta_field", dict(apply_lightcone=False,
                                  smoothing_length=12.0)),
    ("generate_biased_field", dict(bias=1.8, apply_lightcone=False)),
    ("generate_fixed_field", dict(flip=True)),
])
def test_fields_match_jax_tight(tight_scene, method, kw):
    got, want = _tight_pair(tight_scene, method, 5, kw)
    assert _max_rel(got, want) <= TIGHT


@pytest.mark.parametrize("method,kw", [
    ("generate_delta_field", {}),
    ("generate_biased_field", dict(bias=1.5, apply_lightcone=False)),
])
def test_fields_match_jax_public(method, kw):
    shape = (32, 32, 32)
    gj = jl.LognormalGenerator(*shape, grid_spacing=SPACING)
    gt = tl.LognormalGenerator(*shape, SPACING, device="cpu")
    assert gt.sigma_g2 == pytest.approx(gj.sigma_g2, rel=PUBLIC)
    got = getattr(gt, method)(3, **kw).numpy()
    want = np.asarray(getattr(gj, method)(3, **kw))
    assert _max_rel(got, want) <= PUBLIC


def test_predictions_match_jax():
    shape = (24, 24, 24)
    gj = jl.LognormalGenerator(*shape, grid_spacing=SPACING,
                               power=_target(0.25))
    gt = tl.LognormalGenerator(*shape, SPACING, power=_target(0.25),
                               device="cpu")
    for kw in (dict(bias=2.0), dict(bias=1.8, bias2=1.0),
               dict(smoothing_length=10.0)):
        got = gt.predicted_biased_power(nbins=8, **kw)
        want = gj.predicted_biased_power(nbins=8, **kw)
        np.testing.assert_array_equal(got[2], want[2])
        assert _max_rel(got[1], want[1]) <= PUBLIC
    assert gt.predicted_variance(bias=1.5) == pytest.approx(
        gj.predicted_variance(bias=1.5), rel=PUBLIC)
    xi = gt._xi_gaussian_grid().numpy()
    assert _max_rel(xi, gj._xi_gaussian_grid()) <= PUBLIC


def test_lognormal_power_matches_target():
    # the reference's gate (tests/test_lognormal.py): 8 seeds at 32^3
    n, spacing, nseeds, nbins = 32, 8.0, 8, 10
    gen = tl.LognormalGenerator(n, n, n, spacing, device="cpu")
    acc, allv = [], []
    for s in range(nseeds):
        d = gen.generate_delta_field(s, apply_lightcone=False)
        allv.append(d.numpy())
        k, p, cnt = stats.calculate_power(d, spacing, nbins=nbins)
        acc.append(p)
    allv = np.stack(allv)
    assert allv.min() > -1.0
    assert abs(allv.mean()) < 4 * np.sqrt(gen.predicted_variance()
                                          / allv.size)
    np.testing.assert_allclose(allv.var(), gen.predicted_variance(),
                               rtol=0.12)
    p_mean = np.mean(acc, axis=0)
    p_sd = np.std(acc, axis=0, ddof=1) / np.sqrt(nseeds)
    mask = cnt > 4
    p_target = np.interp(np.log10(k[mask]), np.log10(gen.power.k),
                         gen.power.Pk)
    resid = np.abs(p_mean[mask] - p_target)
    budget = 5.0 * p_sd[mask] + 0.06 * p_target
    assert (resid < budget).all(), (resid / budget).max()


def test_lightcone_per_plane_and_batch():
    n, spacing = 24, 10.0
    gen = tl.LognormalGenerator(n, n, n, spacing, device="cpu")
    d = gen.generate_delta_fields(np.arange(8)).numpy()
    assert np.array_equal(d[3], gen.generate_delta_field(3).numpy())
    w = np.asarray(gen.growth_function)
    var_planes = d.var(axis=(0, 1, 2))
    pred = np.expm1(w ** 2 * gen.sigma_g2)
    np.testing.assert_allclose(var_planes, pred, rtol=0.25)
    mean_planes = d.mean(axis=(0, 1, 2))
    assert np.abs(mean_planes).max() < 6 * np.sqrt(pred.max() / (8 * n * n))
    b = gen.generate_biased_field(3, bias=1.0)
    assert np.array_equal(b.numpy(), d[3])


def test_refusals_name_item_8():
    # item 8b brought the slab mesh (tests/test_torch_mesh_mocks.py); the
    # pencil mesh waits for item 5
    from randomfield_tpu_torch.parallel import mesh as pmesh

    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        tl.LognormalGenerator(16, 16, 16, 8.0,
                              mesh=pmesh.make_pencil_mesh(1, 2, 2))
    with pytest.raises(TypeError, match="SlabMesh"):
        tl.LognormalGenerator(16, 16, 16, 8.0, device="cpu", mesh=object())


@pytest.mark.gpu
def test_lognormal_on_the_card_matches_jax():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    shape = (32, 32, 32)
    gj = jl.LognormalGenerator(*shape, grid_spacing=SPACING)
    gt = tl.LognormalGenerator(*shape, SPACING, device="cuda")
    got = gt.generate_delta_field(3).cpu().numpy()
    assert _max_rel(got, gj.generate_delta_field(3)) <= PUBLIC
