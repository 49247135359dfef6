"""The port's void finder and void statistics (models/voids.py, KX's plain
versions in ops/extrema.py) vs the JAX package's models/voids.py, on the
same numpy fields, and the JAX package's own gates on the port.

Bars: the catalog (positions and radii) exactly equal, given the JAX
package's R_v grid (the same float64 keys and strict test, the same
greedy order and ties) and on its planted void; minima counts and totals
exactly; underdense_fraction within 1e-6 (an exact int64 count
here, a float32 mean there); _discrete_sigma_r and the predicted fraction
within 2e-3 (the sigma table's bar; float64 sums in both).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import randomfield_tpu as rf  # noqa: E402
from randomfield_tpu.models import voids as jvo  # noqa: E402
import randomfield_tpu_torch as rft  # noqa: E402
from randomfield_tpu_torch.models import voids  # noqa: E402
from randomfield_tpu_torch.ops import extrema  # noqa: E402
from randomfield_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from randomfield_tpu_torch.validate import peaks as pk  # noqa: E402

MOMENT_RTOL = 2e-3


def _field(shape, seed, sm, spacing=4.0):
    g = rft.Generator(*shape, grid_spacing=spacing, device="cpu")
    return g.generate_delta_field(seed, smoothing_length=sm,
                                  apply_lightcone=False).numpy()


def _planted_field(n, spacing, center, r0, amp, eps=1e-3):
    """The JAX test's periodic top-hat underdensity with a one-voxel deeper
    spike at its center."""
    ax = (np.arange(n) + 0.5) * spacing
    box = n * spacing
    dv = [np.abs(ax - c) for c in center]
    dv = [np.minimum(v, box - v) for v in dv]
    r = np.sqrt(dv[0][:, None, None] ** 2 + dv[1][None, :, None] ** 2
                + dv[2][None, None, :] ** 2)
    d = np.where(r < r0, -amp, 0.0).astype(np.float32)
    d[tuple(int(c / spacing - 0.5) for c in center)] -= eps
    return d


@pytest.mark.parametrize("shape,sm,threshold", [
    ((32, 32, 32), 6.0, -0.2), ((24, 32, 16), 4.0, -0.3)])
def test_catalog_matches_jax_on_its_radius_grid(shape, sm, threshold):
    d = _field(shape, 1, sm)
    radii = (4.0, 8.0, 12.0, 16.0)
    rv = np.array(jvo.void_radius_grid(jnp.asarray(d), 4.0, radii,
                                       threshold))
    want = jvo.find_voids(jnp.asarray(d), 4.0, radii, threshold=threshold)
    got = voids.voids_from_radius(torch.as_tensor(rv), torch.as_tensor(d),
                                  4.0)
    assert len(want[1]) > 3
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    got = voids.find_voids(torch.as_tensor(d), 4.0, radii,
                           threshold=threshold)
    assert len(got[1]) == len(want[1])


def test_void_candidates_match_a_bruteforce_key():
    """Plateaus of R_v (ties broken by delta) and thin axes: the plain
    candidates equal the JAX package's 26 rolled float64 keys."""
    rng = np.random.default_rng(2)
    for shape in ((10, 2, 12), (8, 9, 7)):
        rv = rng.choice([0.0, 4.0, 8.0], size=shape).astype(np.float32)
        d = np.round(rng.standard_normal(shape), 1).astype(np.float32)
        key = rv.astype(np.float64) - 1e-9 * d.astype(np.float64)
        neigh = np.full(shape, -np.inf)
        for sx in (-1, 0, 1):
            for sy in (-1, 0, 1):
                for sz in (-1, 0, 1):
                    if sx == sy == sz == 0:
                        continue
                    np.maximum(neigh, np.roll(key, (sx, sy, sz), (0, 1, 2)),
                               out=neigh)
        want = np.flatnonzero((key > neigh) & (rv > 0))
        got = extrema.void_candidates(torch.as_tensor(rv), torch.as_tensor(d))
        np.testing.assert_array_equal(got, want)


def test_planted_void_matches_jax():
    n, sp = 64, 1.0
    center = ((n // 2 + 0.5) * sp,) * 3
    d = _planted_field(n, sp, center, 6.0, 0.6)
    radii = tuple(np.arange(2.0, 13.0, 0.75))
    want = jvo.find_voids(jnp.asarray(d), sp, radii, threshold=-0.2)
    got = voids.find_voids(torch.as_tensor(d), sp, radii, threshold=-0.2)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    r_true = (0.6 / 0.2) ** (1.0 / 3.0) * 6.0
    np.testing.assert_allclose(got[0][0], center, atol=1e-6)
    assert abs(got[1][0] - r_true) <= radii[1] - radii[0] + 1e-9
    if got[0].shape[0] > 1:
        assert got[1][1:].max() < 0.6 * r_true


def test_underdense_fraction_and_sigma_match_jax():
    shape, sp = (32, 32, 32), 4.0
    d = _field(shape, 3, 4.0)
    for radius, t in ((8.0, -0.2), (12.0, -0.1)):
        assert voids.underdense_fraction(torch.as_tensor(d), sp, radius,
                                         t) == pytest.approx(
            jvo.underdense_fraction(jnp.asarray(d), sp, radius, t), abs=1e-6)
        for interp in ("log10k", "loglog"):
            want = jvo._discrete_sigma_r(rf.load_default_power(), shape, sp,
                                         radius, interp)
            got = voids._discrete_sigma_r(rft.load_default_power(), shape, sp,
                                          radius, interp, device="cpu")
            assert got == pytest.approx(want, rel=MOMENT_RTOL)
        assert voids.predicted_underdense_fraction(
            rft.load_default_power(), shape, sp, radius, t,
            device="cpu") == pytest.approx(jvo.predicted_underdense_fraction(
                rf.load_default_power(), shape, sp, radius, t),
                rel=MOMENT_RTOL)


def test_minima_match_jax():
    d = _field((32, 24, 32), 5, 6.0)
    for sigma0 in (None, 0.3):
        want = jvo.minima_statistics(jnp.asarray(d), 4.0, sigma0=sigma0)
        got = voids.minima_statistics(torch.as_tensor(d), 4.0,
                                      sigma0=sigma0)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


def test_generator_find_voids_matches_jax():
    shape, sp = (32, 32, 32), 4.0
    gj = rf.Generator(*shape, grid_spacing=sp)
    gt = rft.Generator(*shape, grid_spacing=sp, device="cpu")
    d = _planted_field(32, sp, (66.0, 66.0, 66.0), 16.0, 0.6)
    radii = (8.0, 12.0, 16.0, 20.0, 24.0)
    want = gj.find_voids(jnp.asarray(d), radii, threshold=-0.2)
    got = gt.find_voids(torch.as_tensor(d), radii, threshold=-0.2)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_void_radius_grid_validation():
    d = torch.zeros((8, 8, 8))
    with pytest.raises(ValueError):
        voids.void_radius_grid(d, 1.0, (3.0, 2.0), threshold=-0.4)
    with pytest.raises(ValueError):
        voids.void_radius_grid(d, 1.0, (), threshold=-0.4)
    with pytest.raises(ValueError):
        voids.void_radius_grid(d, 1.0, (2.0, 3.0), threshold=0.1)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        voids.find_voids(d, 1.0, (2.0,),
                         mesh=pmesh.make_mesh(space=1, device="cpu"))


def test_underdense_fraction_gate():
    """The JAX package's gate at its settings (3 seeds at 64^3)."""
    n, sp, R, t = 64, 4.0, 8.0, -0.4
    g = rft.Generator(n, n, n, grid_spacing=sp, device="cpu")
    pred = voids.predicted_underdense_fraction(g.power, (n, n, n), sp, R, t,
                                               device="cpu")
    assert 0.05 < pred < 0.95
    meas = np.mean([voids.underdense_fraction(
        g.generate_delta_field(s, apply_lightcone=False), sp, R, t)
        for s in range(3)])
    assert abs(meas - pred) < 0.02


def test_catalog_nonoverlapping():
    n, sp = 64, 4.0
    g = rft.Generator(n, n, n, grid_spacing=sp, device="cpu")
    d = g.generate_delta_field(7, apply_lightcone=False)
    pos, rv = voids.find_voids(d, sp, tuple(np.arange(6.0, 40.0, 4.0)),
                               threshold=-0.3)
    assert pos.shape[0] >= 3
    assert np.all(np.diff(rv) <= 1e-12)
    box = n * sp
    for i in range(pos.shape[0]):
        dv = np.abs(pos[i + 1:] - pos[i])
        dv = np.minimum(dv, box - dv)
        assert np.all(np.sqrt((dv**2).sum(axis=1)) >= rv[i] - 1e-9)


def test_void_size_function_counts():
    rv = np.array([3.0, 5.0, 5.5, 9.0])
    edges = np.array([2.0, 4.0, 8.0, 16.0])
    centers, dndlnr, counts = voids.void_size_function(rv, 1000.0, edges)
    np.testing.assert_array_equal(counts, [1, 2, 1])
    np.testing.assert_allclose(centers, np.sqrt(edges[:-1] * edges[1:]))
    np.testing.assert_allclose(dndlnr,
                               counts / (1000.0 * np.diff(np.log(edges))))


def test_minima_match_bruteforce_oracle():
    rng = np.random.default_rng(11)
    d = rng.standard_normal((24, 24, 24)).astype(np.float32)
    centers, counts, total = voids.minima_statistics(torch.as_tensor(d), 1.0,
                                                     sigma0=1.0)
    assert np.all(np.diff(centers) > 0)
    neigh_min = np.full(d.shape, np.inf)
    for sx in (-1, 0, 1):
        for sy in (-1, 0, 1):
            for sz in (-1, 0, 1):
                if sx == sy == sz == 0:
                    continue
                np.minimum(neigh_min, np.roll(d, (sx, sy, sz), (0, 1, 2)),
                           out=neigh_min)
    assert total == int(np.sum(d <= neigh_min))
    _, counts_pk, total_pk = pk.peak_statistics(torch.as_tensor(-d), 1.0,
                                                sigma0=1.0)
    assert total == total_pk
    np.testing.assert_array_equal(counts, counts_pk[::-1])
