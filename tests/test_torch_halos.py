"""The port's halo and HOD mocks (models/halos.py, models/hod.py) vs the
JAX package, on the CPU.

(a) the scene's numbers (nbar, bias, mass_centers, expected_counts,
    shot_noise) and the predictions (predicted_halo_power auto and cross,
    predicted_combined_power, the HOD's densities, bias and galaxy power)
    within 1e-6 relative (the grid predictions run through two float32
    FFT libraries; the rest is the same host float64);
(b) the counts: KH's plain version on the JAX package's own Gaussian render
    and float32 constants equals its generate_halo_counts on every cell;
    the port's end-to-end counts differ only where the two packages'
    float32 intensities differ (the renders agree within 1e-3 of their
    peak, the public-API bar; sigma_g2 within 1e-4), each such cell shown
    to be such a tie (KH at each side's intensity gives each side's
    count);
(c) counts_to_catalog bit for bit on one count cube, from a tensor or an
    array; generate_galaxy_catalog on one halo catalog bit for bit
    without RSD, with RSD within float32 rounding of psi;
(d) the occupation helpers and the refusals.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import jax  # noqa: E402,F401

from randomfield_tpu.models import halos as jh  # noqa: E402
from randomfield_tpu.models import hod as jhod  # noqa: E402
from randomfield_tpu_torch.models import halos as th  # noqa: E402
from randomfield_tpu_torch.models import hod as thod  # noqa: E402
from randomfield_tpu_torch.ops import poisson as kh  # noqa: E402

SHAPE, SPACING = (16, 16, 16), 16.0
HALO_KW = dict(nbins_mass=3, mmin=1e12, mmax=1e15)
HOD_KW = dict(nbins_mass=3)
PRED = 1e-6
SEED = 3
# the Gaussian renders of the two packages through the public API (the
# bar of tests/test_torch_generator.py: the JAX CPU path scales by its
# sigma grid, the port by K2's table amplitude)
PUBLIC = 1e-3
# the HOD's bin-pair mixture: expm1 of b_i b_j xi_G with b up to ~5 lifts
# the float32 FFT rounding of xi_G above PRED
PRED_MIXTURE = 1e-5


@pytest.fixture(scope="module")
def halos():
    return (jh.HaloGenerator(*SHAPE, SPACING, **HALO_KW),
            th.HaloGenerator(*SHAPE, SPACING, device="cpu", **HALO_KW))


@pytest.fixture(scope="module")
def jax_counts(halos):
    """The JAX package's Gaussian render and halo counts of SEED, computed
    once a module: (g, counts) as numpy arrays."""
    j, _ = halos
    g = np.asarray(j.lognormal.gaussian.generate_delta_field(
        SEED, apply_lightcone=False))
    return g, np.asarray(j.generate_halo_counts(SEED))


@pytest.fixture(scope="module")
def jax_counts_next(halos):
    """The JAX package's halo counts of SEED + 1, computed once a module."""
    return np.asarray(halos[0].generate_halo_counts(SEED + 1))


@pytest.fixture(scope="module")
def hods():
    return (jhod.HODGenerator(*SHAPE, SPACING, **HOD_KW),
            thod.HODGenerator(*SHAPE, SPACING, device="cpu", **HOD_KW))


@pytest.fixture(scope="module")
def jax_halo_catalog(hods):
    """The JAX package's halo catalog of SEED, computed once a module."""
    return hods[0].halos.generate_halo_catalog(SEED)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.nanmax(np.abs(got - want) / np.abs(want)))


@pytest.mark.parametrize("name", ["nbar", "bias", "mass_centers",
                                  "expected_counts", "shot_noise",
                                  "halo_abundance"])
def test_scene_numbers(halos, name):
    j, t = halos
    a, b = getattr(j, name), getattr(t, name)
    a, b = (a(), b()) if callable(a) else (a, b)
    for x, y in zip(np.atleast_2d(b), np.atleast_2d(a)):
        assert _rel(x, y) <= PRED
    np.testing.assert_array_equal(t.mass_edges, j.mass_edges)


@pytest.mark.parametrize("which", ["auto", "cross", "combined"])
def test_predictions(halos, which):
    j, t = halos
    if which == "auto":
        want, got = j.predicted_halo_power(1), t.predicted_halo_power(1)
    elif which == "cross":
        want = j.predicted_halo_power(0, 2, nbins=12, smoothing_length=20.0)
        got = t.predicted_halo_power(0, 2, nbins=12, smoothing_length=20.0)
    else:
        want, got = j.predicted_combined_power(), t.predicted_combined_power()
    np.testing.assert_array_equal(got[2], want[2])
    assert _rel(got[0], want[0]) <= PRED and _rel(got[1], want[1]) <= PRED


def test_counts_from_the_reference_field(halos, jax_counts):
    j, _ = halos
    g, want = jax_counts
    got = kh.poisson_counts(torch.from_numpy(g), th.halo_keys(SEED, 3),
                            "lognormal", lam0=j.nbar * j._cell_volume,
                            bias=j.bias, sigma_g2=j.lognormal.sigma_g2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_halo_counts_differ_only_at_ties(halos, jax_counts):
    j, t = halos
    g, want = jax_counts
    got = t.generate_halo_counts(SEED)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, *SHAPE)
    got = got.numpy()
    diff = np.argwhere(got != want)
    # the renders' amplitudes differ by float32 rounding (the JAX CPU path
    # scales by its sigma grid, the port by K2's table amplitude) and
    # sigma_g2 by the JAX package's float32 sum; at lambda ~ 30 (bin 0)
    # that moves a count on a few cells in a thousand
    assert len(diff) <= 1e-2 * got.size
    gj = torch.from_numpy(g)
    gt = t.lognormal.gaussian.generate_delta_field(SEED, apply_lightcone=False)
    assert float((gt - gj).abs().max() / gj.abs().max()) <= PUBLIC
    assert abs(t.lognormal.sigma_g2 / j.lognormal.sigma_g2 - 1.0) <= 1e-4
    keys = th.halo_keys(SEED, 3)
    for b in sorted(set(diff[:, 0])):
        lam_j = kh.intensity(gj, "lognormal", b, j.nbar * j._cell_volume,
                             j.bias, j.lognormal.sigma_g2)
        lam_t = kh.intensity(gt, "lognormal", b, t.nbar * t._cell_volume,
                             t.bias, t.lognormal.sigma_g2)
        cells = tuple(diff[diff[:, 0] == b, 1:].T)
        # KH at each side's intensity gives each side's count
        np.testing.assert_array_equal(
            kh.poisson_plain(keys[b], lam_j).numpy()[cells], want[b][cells])
        np.testing.assert_array_equal(
            kh.poisson_plain(keys[b], lam_t).numpy()[cells], got[b][cells])


@pytest.mark.parametrize("with_power", [True, False])
@pytest.mark.parametrize("as_tensor", [True, False])
def test_counts_to_catalog_bit_for_bit(halos, jax_counts_next, with_power,
                                       as_tensor):
    j, t = halos
    counts = jax_counts_next
    kw = dict(seed=SEED + 1, cosmology="Planck13", fit=j.fit,
              power=j._power if with_power else None)
    want = jh.counts_to_catalog(counts, j.mass_edges, SPACING, **kw)
    got = th.counts_to_catalog(torch.from_numpy(counts) if as_tensor
                               else counts, t.mass_edges, SPACING, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape[0] == int(counts.sum()) > 0


def test_halo_catalog_of_its_own_counts(halos):
    _, t = halos
    counts = t.generate_halo_counts(SEED)
    pos, mass = t.generate_halo_catalog(SEED)
    assert pos.shape == (int(counts.sum()), 3) and mass.shape == (pos.shape[0],)
    cells = np.floor(pos / SPACING).astype(int)
    occupied = np.zeros(SHAPE, int)
    np.add.at(occupied, tuple(cells.T), 1)
    np.testing.assert_array_equal(occupied, counts.sum(0).numpy())


@pytest.mark.parametrize("rsd", [False, True])
def test_galaxy_catalog_on_one_halo_catalog(hods, jax_halo_catalog,
                                           monkeypatch, rsd):
    j, t = hods
    cat = jax_halo_catalog
    # both packages occupy the same halo catalog
    monkeypatch.setattr(j.halos, "generate_halo_catalog",
                        lambda seed, smoothing_length=0.0: cat)
    monkeypatch.setattr(t.halos, "generate_halo_catalog",
                        lambda seed, smoothing_length=0.0: cat)
    want = j.generate_galaxy_catalog(SEED, rsd=rsd, los_axis=1)
    got = t.generate_galaxy_catalog(SEED, rsd=rsd, los_axis=1)
    np.testing.assert_array_equal(got[1], want[1])
    if rsd:
        # f psi at the halos' cells: float32 renders of two FFT libraries
        box = SHAPE[1] * SPACING
        d = np.abs(got[0] - want[0])
        d = np.minimum(d, box - d)
        assert float(d.max()) <= 1e-5 * box
    else:
        np.testing.assert_array_equal(got[0], want[0])
    assert got[0].shape[0] > 100


def test_galaxy_catalog_end_to_end(hods):
    _, t = hods
    pos, cen = t.generate_galaxy_catalog(SEED + 2)
    again = t.generate_galaxy_catalog(SEED + 2)
    np.testing.assert_array_equal(pos, again[0])
    box = np.array(SHAPE) * SPACING
    assert np.all((pos >= 0) & (pos < box)) and cen.dtype == bool


@pytest.mark.parametrize("what", ["density", "power", "mixture"])
def test_hod_expectations(hods, what):
    j, t = hods
    if what == "density":
        assert _rel(t.galaxy_density_bins, j.galaxy_density_bins) <= PRED
        assert _rel(t.galaxy_bias, j.galaxy_bias) <= PRED
        assert _rel(t.expected_galaxies(), j.expected_galaxies()) <= PRED
        return
    kw = dict(nbins=10, mixture=what == "mixture")
    want, got = j.predicted_galaxy_power(**kw), t.predicted_galaxy_power(**kw)
    np.testing.assert_array_equal(got[2], want[2])
    assert _rel(got[1], want[1]) <= (PRED_MIXTURE if kw["mixture"] else PRED)


def test_occupation_helpers():
    m = np.geomspace(1e12, 1e15, 40)
    for a, b in zip(thod.zheng05_occupation(m, alpha=1.2),
                    jhod.zheng05_occupation(m, alpha=1.2)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(thod.virial_dispersion(m),
                                  jhod.virial_dispersion(m))
    c = np.linspace(2.0, 12.0, 40)
    np.testing.assert_array_equal(
        thod.sample_nfw_radii(c, m / 1e13, np.random.default_rng(1)),
        jhod.sample_nfw_radii(c, m / 1e13, np.random.default_rng(1)))


def test_refusals():
    with pytest.raises(ValueError):
        th.HaloGenerator(*SHAPE, SPACING, mmin=1e15, mmax=1e13, device="cpu")
    with pytest.raises(ValueError):
        th.HaloGenerator(*SHAPE, SPACING, fit="tinker10", device="cpu")
    # the slab mesh runs it (tests/test_torch_mesh_mocks.py); the pencil
    # mesh waits for item 5
    from randomfield_tpu_torch.parallel import mesh as pmesh

    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        th.HaloGenerator(*SHAPE, SPACING,
                         mesh=pmesh.make_pencil_mesh(1, 2, 2))
    # the HOD's redshift-space catalog on a mesh is item 8b's second half
    with pytest.raises(NotImplementedError, match="Queue 1 item 8b"):
        thod.HODGenerator(*SHAPE, SPACING,
                          mesh=pmesh.make_mesh(space=1, device="cpu"))
    with pytest.raises(ValueError):
        th.counts_to_catalog(np.zeros((2, 4, 4, 4), int), [1.0, 2.0],
                             SPACING)
