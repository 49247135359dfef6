"""The port's kNN-CDFs (validate/knn.py) vs the JAX package's
validate/knn.py, on the same numpy catalogs, and the JAX package's own
gates on the port.

Bars: count_in_spheres, knn_cdf and knn_cdf_positions exactly equal (the
convolution rounds to integers; the grids here have 2^k cells, so the JAX
package's float32 fraction is exact too), lattice_ball_sizes exactly,
random_knn_cdf within 1e-12 (the same float64 numpy).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import randomfield_tpu as rf  # noqa: E402
from randomfield_tpu.validate import knn as jknn  # noqa: E402
import randomfield_tpu_torch as rft  # noqa: E402
from randomfield_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from randomfield_tpu_torch.validate import knn  # noqa: E402


def _counts(shape, n, seed):
    counts = np.zeros(shape, np.float32)
    idx = np.random.default_rng(seed).integers(0, shape, size=(n, 3)).T
    np.add.at(counts, tuple(idx), 1.0)
    return counts


@pytest.mark.parametrize("shape,spacing,radii", [
    ((32, 16, 32), 4.0, (4.0, 8.0, 12.0, 16.0)), ((16, 32, 8), 2.0, (2.0, 9.0))])
def test_knn_cdf_matches_jax(shape, spacing, radii):
    counts = _counts(shape, 900, 1)
    ks = (1, 2, 3, 5)
    want = jknn.knn_cdf(jnp.asarray(counts), spacing, radii, ks)
    got = knn.knn_cdf(torch.as_tensor(counts), spacing, radii, ks)
    np.testing.assert_array_equal(got, want)
    for r in radii[-2:]:
        np.testing.assert_array_equal(
            knn.count_in_spheres(torch.as_tensor(counts), spacing, r).numpy(),
            np.asarray(jknn.count_in_spheres(jnp.asarray(counts), spacing, r)))


def test_knn_cdf_positions_and_ball_sizes_match_jax():
    shape, spacing = (32, 32, 32), 4.0
    pos = np.random.default_rng(2).uniform(0, 128.0, size=(3, 700))
    radii = (6.0, 12.0)
    np.testing.assert_array_equal(
        knn.knn_cdf_positions(pos, shape, spacing, radii, ks=(1, 2)),
        jknn.knn_cdf_positions(pos, shape, spacing, radii, ks=(1, 2)))
    radii = (0.0, 2.0, 4.0, 5.657, 9.0, 40.0)
    np.testing.assert_array_equal(knn.lattice_ball_sizes(shape, spacing, radii),
                                  jknn.lattice_ball_sizes(shape, spacing,
                                                          radii))
    np.testing.assert_allclose(
        knn.random_knn_cdf(700, shape, spacing, radii, (1, 2, 4)),
        jknn.random_knn_cdf(700, shape, spacing, radii, (1, 2, 4)),
        rtol=1e-12, atol=1e-12)


def test_generator_method_matches_jax():
    shape, spacing = (32, 32, 32), 4.0
    counts = _counts(shape, 500, 3)
    want = rf.Generator(*shape, grid_spacing=spacing).calculate_knn_cdf(
        jnp.asarray(counts), (6.0, 10.0))
    got = rft.Generator(*shape, grid_spacing=spacing,
                        device="cpu").calculate_knn_cdf(
        torch.as_tensor(counts), (6.0, 10.0))
    np.testing.assert_array_equal(got, want)


def test_count_in_spheres_brute_force_parity():
    n, spacing = 16, 2.0
    pos = np.random.default_rng(3).random((3, 20)) * n * spacing
    idx = np.floor(pos / spacing).astype(int) % n
    counts = np.zeros((n, n, n))
    np.add.at(counts, tuple(idx), 1.0)
    ax = np.minimum(np.arange(n), n - np.arange(n)) * spacing
    r2 = (ax**2)[:, None, None] + (ax**2)[None, :, None] + (ax**2)[None, None, :]
    for radius in (2.0, 5.0, 9.0):
        got = knn.count_in_spheres(torch.as_tensor(counts), spacing,
                                   radius).numpy()
        ball = (r2 <= radius**2 + 1e-9 * spacing**2).astype(np.float64)
        expect = np.zeros_like(counts)
        for cx, cy, cz in zip(*np.nonzero(counts)):
            expect += counts[cx, cy, cz] * np.roll(ball, (cx, cy, cz),
                                                   axis=(0, 1, 2))
        np.testing.assert_array_equal(got, expect)


def test_random_catalog_matches_exact_binomial():
    n, spacing, ntr, ncat = 24, 2.0, 200, 10
    radii, ks = (2.0, 4.0, 6.0, 9.0, 12.0), (1, 2, 3)
    pred = knn.random_knn_cdf(ntr, (n, n, n), spacing, radii, ks)
    rng = np.random.default_rng(11)
    acc = [knn.knn_cdf_positions(rng.random((3, ntr)) * n * spacing,
                                 (n, n, n), spacing, radii, ks)
           for _ in range(ncat)]
    mean = np.mean(acc, axis=0)
    sd = np.std(acc, axis=0, ddof=1) / np.sqrt(ncat)
    assert (np.abs(mean - pred) < 5.0 * sd + 5e-3).all()
    assert (pred >= 0).all() and (pred <= 1).all()
    assert (np.diff(pred, axis=1) >= -1e-12).all()
    assert (np.diff(pred, axis=0) <= 1e-12).all()


def test_all_in_one_cell_is_ball_fraction():
    n, spacing = 16, 2.0
    counts = np.zeros((n, n, n), np.float32)
    counts[3, 7, 1] = 5.0
    radii = (2.0, 6.0, 10.0)
    cdf = knn.knn_cdf(torch.as_tensor(counts), spacing, radii, ks=(1, 2, 5))
    expect = knn.lattice_ball_sizes((n, n, n), spacing, radii) / n**3
    for i in range(3):
        np.testing.assert_allclose(cdf[i], expect, rtol=0, atol=1e-12)


def test_clustering_lowers_cdf1():
    n, spacing, ntr = 24, 2.0, 64
    rng = np.random.default_rng(5)
    cdf_rand = knn.knn_cdf_positions(rng.random((3, ntr)) * n * spacing,
                                     (n, n, n), spacing, (6.0,), ks=(1,))
    cdf_clump = knn.knn_cdf_positions(rng.random((3, ntr)) * 6.0, (n, n, n),
                                      spacing, (6.0,), ks=(1,))
    assert cdf_clump[0, 0] < cdf_rand[0, 0]


def test_knn_validation_errors():
    counts = torch.zeros((8, 8, 8))
    with pytest.raises(ValueError):
        knn.knn_cdf(counts, 2.0, (1.0,), ks=(0,))
    with pytest.raises(ValueError):
        knn.knn_cdf_positions(torch.zeros((2, 10)), (8, 8, 8), 2.0, (1.0,))
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        knn.knn_cdf(counts, 2.0, (1.0,),
                    mesh=pmesh.make_mesh(space=1, device="cpu"))
