"""The port's FKP, marked and velocity statistics (validate/fkp.py,
marked.py, velocity.py on the CPU, their plain versions) vs the JAX
package's, on the same numpy-seeded fields and catalogs.

Bars: the JAX tests' own where they hold an estimator to an exact
reference (FKP: 2e-4 of a bin's power, alpha and I22 to 1e-12; marked:
1e-5; velocity: 2e-4 of the largest psi_r), here held between the two
packages; the float32 transforms of two libraries (XLA's and torch's) and
KP's int64 sums against XLA's float32 scatter are what differ.  The
mode counts and the bins' cell counts are equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import randomfield_tpu as rf  # noqa: E402
from randomfield_tpu.models import zeldovich as jzel  # noqa: E402
from randomfield_tpu.validate import fkp as jfkp  # noqa: E402
from randomfield_tpu.validate import marked as jmarked  # noqa: E402
from randomfield_tpu.validate import velocity as jvel  # noqa: E402
from randomfield_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from randomfield_tpu_torch.validate import fkp, marked, velocity  # noqa: E402

FKP_SHAPE, FKP_SPACING = (16, 16, 16), 8.0
N, SPACING = 24, 6.0


def _rel(got, want):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isnan(g), np.isnan(w))
    ok = ~np.isnan(w)
    return float(np.abs(g[ok] - w[ok]).max() / np.abs(w[ok]).max())


@pytest.fixture(scope="module")
def fields():
    """A JAX render and its velocity (float32 numpy), shared by the tests."""
    g = rf.Generator(N, N, N, grid_spacing=SPACING)
    d = np.array(g.generate_delta_field(4, apply_lightcone=False))
    v = np.array(g.generate_velocity(4))
    return g, d, v


def _lattice():
    return np.asarray(jzel.lagrangian_positions(
        FKP_SHAPE, FKP_SPACING)).reshape(3, -1)


@pytest.mark.parametrize("window,interlaced", [("ngp", False), ("cic", True),
                                               ("tsc", False)])
def test_fkp_power_matches_jax(window, interlaced):
    rng = np.random.RandomState(0)
    data = rng.uniform(0.0, FKP_SHAPE[0] * FKP_SPACING, size=(3, 600))
    wd = rng.uniform(0.5, 1.5, 600)
    lat = _lattice()
    kw = dict(window=window, interlaced=interlaced, nbins=8,
              data_weights=wd, nbar_randoms=np.full(lat.shape[1], 3e-4),
              p0=2e3)
    got = fkp.fkp_power(data, lat, FKP_SPACING, FKP_SHAPE, device="cpu",
                        **kw)
    want = jfkp.fkp_power(data, lat, FKP_SPACING, FKP_SHAPE, **kw)
    np.testing.assert_array_equal(got.n_modes, want.n_modes)
    assert np.isclose(got.alpha, want.alpha, rtol=1e-12)
    assert np.isclose(got.i22, want.i22, rtol=1e-12)
    assert np.isclose(got.shot_noise, want.shot_noise, rtol=1e-12)
    assert _rel(got.p + got.shot_noise, want.p + want.shot_noise) < 2e-4


def test_fkp_multipoles_and_counts_match_jax():
    rng = np.random.RandomState(3)
    counts = rng.poisson(0.7, FKP_SHAPE).astype(np.float64).ravel()
    rcounts = rng.poisson(6.0, FKP_SHAPE).astype(np.float64).ravel()
    lat = _lattice()
    kw = dict(data_weights=counts, randoms_weights=rcounts,
              data_are_counts=True, randoms_are_counts=True, nbins=8,
              ells=(0, 2), window="tsc")
    got = fkp.fkp_power_multipoles(torch.as_tensor(lat, dtype=torch.float32),
                                   lat, FKP_SPACING, FKP_SHAPE, **kw)
    want = jfkp.fkp_power_multipoles(lat, lat, FKP_SPACING, FKP_SHAPE, **kw)
    assert np.isclose(got.shot_noise, want.shot_noise, rtol=1e-12)
    assert np.isclose(got.i22, want.i22, rtol=1e-12)
    raw = got.p[0] + got.shot_noise
    assert _rel(raw, want.p[0] + want.shot_noise) < 2e-4
    assert _rel(got.p[2], want.p[2]) < 2e-4 * np.abs(raw).max() / np.abs(
        want.p[2]).max() + 2e-4
    np.testing.assert_allclose(fkp.fkp_weights(np.array([1e-4, 3e-3]), 1e4),
                               jfkp.fkp_weights(np.array([1e-4, 3e-3]), 1e4),
                               rtol=1e-15)


def test_fkp_refusals_match_jax():
    rng = np.random.RandomState(1)
    data = rng.uniform(0.0, 128.0, size=(3, 100))
    lat = _lattice()
    for m, kw in ((fkp, {"device": "cpu"}), (jfkp, {})):
        with pytest.raises(ValueError):
            m.fkp_power(data[:2], lat, FKP_SPACING, FKP_SHAPE, **kw)
        with pytest.raises(ValueError):
            m.fkp_power(data, lat, FKP_SPACING, FKP_SHAPE, window="spline",
                        **kw)
        with pytest.raises(ValueError):
            m.fkp_power(data, lat, FKP_SPACING, FKP_SHAPE, data_weights=0.0,
                        **kw)
        with pytest.raises(ValueError):
            m.fkp_weights(np.array([-1e-4]), 1e4)
    # the slab mesh runs it (tests/test_torch_mesh_mocks.py); the pencil
    # mesh waits for item 5
    from randomfield_tpu_torch.parallel import mesh as pmesh

    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        fkp.fkp_power(data, lat, FKP_SPACING, FKP_SHAPE,
                      mesh=pmesh.make_pencil_mesh(1, 2, 2))


@pytest.mark.parametrize("window", ["gaussian", "tophat"])
def test_smoothing_and_marks_match_jax(fields, window):
    _, d, _ = fields
    got = marked.smooth_field(torch.as_tensor(d), SPACING, 9.0, window)
    want = np.asarray(jmarked.smooth_field(jnp.asarray(d), SPACING, 9.0,
                                           window))
    assert _rel(got, want) < 1e-5
    for p in (0.0, 2.0):
        a = marked.calculate_marked_power(torch.as_tensor(d), SPACING,
                                          nbins=10, R=9.0, p=p, window=window)
        b = jmarked.calculate_marked_power(jnp.asarray(d), SPACING, nbins=10,
                                           R=9.0, p=p, window=window)
        np.testing.assert_array_equal(a[2], b[2])
        assert _rel(a[1], b[1]) < 1e-5
    a = marked.linear_marked_field(torch.as_tensor(d), SPACING, 0.4, R=9.0)
    b = jmarked.linear_marked_field(jnp.asarray(d), SPACING, 0.4, R=9.0)
    assert _rel(a, np.asarray(b)) < 1e-5
    a = marked.white_mark(torch.as_tensor(d), 1.5, 0.3)
    assert _rel(a, np.asarray(jmarked.white_mark(jnp.asarray(d), 1.5,
                                                 0.3))) < 1e-6


@pytest.mark.parametrize("eps,window", [(0.0, "gaussian"), (0.6, "tophat")])
def test_predicted_linear_marked_power_matches_jax(fields, eps, window):
    g, _, _ = fields
    got = marked.predicted_linear_marked_power(
        g.power, (N, N, N), SPACING, eps, R=9.0, nbins=10, window=window,
        device="cpu")
    want = jmarked.predicted_linear_marked_power(
        g.power, (N, N, N), SPACING, eps, R=9.0, nbins=10, window=window)
    np.testing.assert_array_equal(got[2], want[2])
    assert _rel(got[1], want[1]) < 1e-5


def test_velocity_statistics_match_jax(fields):
    g, d, v = fields
    dt, vt = torch.as_tensor(d), torch.as_tensor(v)
    got = velocity.density_velocity_correlation(dt, vt, SPACING, nbins=12)
    want = jvel.density_velocity_correlation(jnp.asarray(d), jnp.asarray(v),
                                             SPACING, nbins=12)
    np.testing.assert_array_equal(got[2], want[2])
    assert _rel(got[0], want[0]) < 1e-6
    assert _rel(got[1], want[1]) < 2e-4
    got = velocity.pairwise_velocity(dt, vt, SPACING, nbins=12)
    want = jvel.pairwise_velocity(jnp.asarray(d), jnp.asarray(v), SPACING,
                                  nbins=12)
    assert _rel(got[1], want[1]) < 2e-4
    for smoothing in (0.0, 10.0):
        got = velocity.predicted_pairwise_velocity(
            g.power, (N, N, N), SPACING, "Planck13", nbins=12,
            smoothing_length=smoothing, device="cpu")
        want = jvel.predicted_pairwise_velocity(
            g.power, (N, N, N), SPACING, "Planck13", nbins=12,
            smoothing_length=smoothing)
        assert _rel(got[1], want[1]) < 2e-4
    r = np.array([20.0, 40.0, 70.0])
    for a, b in zip(velocity.continuum_pairwise_velocity(g.power, r,
                                                         "Planck15", 0.5),
                    jvel.continuum_pairwise_velocity(g.power, r,
                                                     "Planck15", 0.5)):
        np.testing.assert_allclose(a, b, rtol=1e-10)


def test_velocity_parity_on_the_realized_spectrum():
    # the JAX package's deterministic gate (tests/test_velocity.py:16): the
    # realized |c_k|^2 / V through the prediction reproduces the measured
    # psi_r on the port too
    from randomfield_tpu_torch.ops import derived, transform

    import randomfield_tpu_torch as rft

    shape, sp = (20, 24, 16), 6.0
    g = rft.Generator(*shape, grid_spacing=sp, power="eh98", device="cpu")
    d = g.generate_delta_field(seed=3, apply_lightcone=False)
    v = derived.delta_to_velocity(d, sp, g.cosmology, z=0.0)
    _, psi_m, c_m = velocity.density_velocity_correlation(d, v, sp, nbins=14)
    c = transform.field_to_spectrum(d, sp)
    pgrid = (c.real ** 2 + c.imag ** 2) / (np.prod(shape) * sp ** 3)
    pgrid[0, 0, 0] = 0.0
    _, psi_p, c_p = velocity.predicted_density_velocity_correlation(
        None, shape, sp, g.cosmology, nbins=14, pgrid=pgrid)
    np.testing.assert_array_equal(c_m, c_p)
    good = c_m > 0
    scale = np.max(np.abs(psi_m[good]))
    np.testing.assert_allclose(psi_m[good], psi_p[good], atol=2e-4 * scale,
                               rtol=2e-4)


def test_mesh_refusals_name_item_8(fields):
    _, d, v = fields
    mesh = pmesh.make_mesh(space=1, device="cpu")
    dt, vt = torch.as_tensor(d), torch.as_tensor(v)
    lat = _lattice()
    # FKP runs on the slab mesh (tests/test_torch_mesh_mocks.py); on the
    # pencil mesh it waits for item 5
    pencil = pmesh.make_pencil_mesh(1, 2, 2)
    for call in (
            lambda: fkp.fkp_power(lat, lat, FKP_SPACING, FKP_SHAPE,
                                  mesh=pencil),
            lambda: fkp.fkp_power_multipoles(lat, lat, FKP_SPACING, FKP_SHAPE,
                                             mesh=pencil)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            call()
    for call in (
            lambda: marked.smooth_field(dt, SPACING, 8.0, mesh=mesh),
            lambda: marked.marked_field(dt, SPACING, mesh=mesh),
            lambda: marked.linear_marked_field(dt, SPACING, 0.3, mesh=mesh),
            lambda: marked.calculate_marked_power(dt, SPACING, mesh=mesh),
            lambda: velocity.density_velocity_correlation(dt, vt, SPACING,
                                                          mesh=mesh),
            lambda: velocity.pairwise_velocity(dt, vt, SPACING, mesh=mesh)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
            call()
