"""The port's ensemble statistics and the Generator's measurement methods
vs the JAX package's validate/ensemble.py and engine/measure.py.

Bars: a batch's P(k) rows within 1e-5 of the JAX rows on the same fields
(counts exact); the sample covariance within 1e-10 (numpy on both sides);
the predicted covariances and the Kaiser and derived-field expectations
within 1e-5 (the same float32 per-mode grids, summed in float64 here and
float32 HIGHEST there; counts exact); sigma_r_from_field within 1e-5.  The
checkpointed ensemble is held to the uninterrupted run bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import randomfield_tpu as rf  # noqa: E402
from randomfield_tpu.validate import ensemble as jens  # noqa: E402
import randomfield_tpu_torch as rft  # noqa: E402
from randomfield_tpu_torch.validate import ensemble as ens  # noqa: E402

SPACING = 8.0
SHAPE = (16, 16, 16)
NBINS = 8
RTOL = 1e-5


@pytest.fixture(scope="module")
def generators():
    return (rf.Generator(*SHAPE, grid_spacing=SPACING),
            rft.Generator(*SHAPE, grid_spacing=SPACING, device="cpu"))


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol,
                               atol=rtol * np.abs(want[ok]).max())


def test_ensemble_power_and_covariance_match_jax():
    fields = np.random.default_rng(1).normal(size=(4,) + SHAPE).astype(
        np.float32)
    k, p, n = ens.ensemble_power(torch.as_tensor(fields), SPACING, NBINS)
    kw, pw, nw = jens.ensemble_power(jnp.asarray(fields), SPACING, NBINS)
    np.testing.assert_array_equal(n, nw)
    _close(k, kw)
    _close(p, pw)
    np.testing.assert_allclose(ens.power_covariance(p),
                               jens.power_covariance(p), rtol=1e-10)


def test_sigma_r_from_field_matches_jax():
    d = np.random.default_rng(2).normal(size=SHAPE).astype(np.float32)
    for r in (8.0, 20.0):
        np.testing.assert_allclose(
            ens.sigma_r_from_field(torch.as_tensor(d), SPACING, r),
            jens.sigma_r_from_field(jnp.asarray(d), SPACING, r), rtol=RTOL)


def test_predicted_covariances_match_jax(generators):
    gj, gt = generators
    power = rf.load_default_power()
    for s in (0.0, 6.0):
        _close(ens.predicted_power_covariance(power, SHAPE, SPACING, NBINS,
                                              smoothing_length=s,
                                              device="cpu"),
               jens.predicted_power_covariance(power, SHAPE, SPACING, NBINS,
                                               smoothing_length=s))
    _close(gt.predicted_kaiser_multipole_covariance(nbins=NBINS, los_axis=1),
           gj.predicted_kaiser_multipole_covariance(nbins=NBINS, los_axis=1))


@pytest.mark.parametrize("method,kw", [
    ("predicted_kaiser_multipoles", dict(bias=1.5, smoothing_length=5.0)),
    ("predicted_kaiser_multipoles", dict(f=0.3, los_axis=0, ells=(2,))),
    ("predicted_kaiser_wedges", dict(z=0.5, nmu=3)),
    ("predicted_derived_power", dict(kind="delta")),
    ("predicted_derived_power", dict(kind="potential", z=1.0)),
    ("predicted_derived_power", dict(kind="displacement", component=0)),
    ("predicted_derived_power", dict(kind="velocity", component=2)),
])
def test_measure_predictions_match_jax(generators, method, kw):
    gj, gt = generators
    got = getattr(gt, method)(nbins=NBINS, **kw)
    want = getattr(gj, method)(nbins=NBINS, **kw)
    np.testing.assert_array_equal(got[2], want[2])
    _close(got[1], want[1])
    _close(got[0], want[0])


@pytest.mark.parametrize("sampler", ["threefry", "pallas"])
def test_sample_power_ensemble_resumes_from_its_checkpoint(tmp_path, sampler):
    g = rft.Generator(*SHAPE, grid_spacing=SPACING, device="cpu",
                      sampler=sampler)
    seeds = [3, 5, 7, 9, 11]
    k0, p0, m0 = ens.sample_power_ensemble(g, seeds, nbins=NBINS)
    kb, pb, mb = g.sample_power_batch(seeds, nbins=NBINS)
    np.testing.assert_array_equal(p0, pb)
    ckpt = tmp_path / "ens.npz"
    ens.sample_power_ensemble(g, seeds[:2], nbins=NBINS,
                              checkpoint_path=ckpt, checkpoint_every=1)
    calls = []
    batch = g.sample_power_batch

    def counted(chunk, **kw):
        calls.extend(chunk)
        return batch(chunk, **kw)

    g.sample_power_batch = counted
    k1, p1, m1 = ens.sample_power_ensemble(g, seeds, nbins=NBINS,
                                           checkpoint_path=ckpt,
                                           checkpoint_every=2)
    assert sorted(calls) == [7, 9, 11]  # 3 and 5 came from the checkpoint
    for a, b in ((k1, k0), (p1, p0), (m1, m0)):
        np.testing.assert_array_equal(a, b)
    calls.clear()
    k2, p2, _ = ens.sample_power_ensemble(g, [11, 3], nbins=NBINS,
                                          checkpoint_path=ckpt)
    assert calls == []
    np.testing.assert_array_equal(p2, p0[[4, 0]])


def test_checkpoint_refuses_another_scene(tmp_path):
    g = rft.Generator(*SHAPE, grid_spacing=SPACING, device="cpu")
    ckpt = tmp_path / "ens.npz"
    ens.sample_power_ensemble(g, [1, 2], nbins=NBINS, checkpoint_path=ckpt)
    for other, nbins in (
            (rft.Generator(*SHAPE, grid_spacing=SPACING, device="cpu",
                           sampler="pallas"), NBINS),
            (rft.Generator(*SHAPE, grid_spacing=4.0, device="cpu"), NBINS),
            (g, 4)):
        with pytest.raises(ValueError, match="different scene"):
            ens.sample_power_ensemble(other, [1, 3], nbins=nbins,
                                      checkpoint_path=ckpt)
    ens.sample_power_ensemble(g, [1, 2, 3], nbins=NBINS, checkpoint_path=ckpt)


def _morphology_inputs():
    rng = np.random.default_rng(4)
    d = rft.Generator(*SHAPE, grid_spacing=SPACING, device="cpu") \
        .generate_delta_field(2, smoothing_length=16.0,
                              apply_lightcone=False).numpy()
    counts = np.zeros(SHAPE, np.float32)
    np.add.at(counts, tuple(rng.integers(0, 16, size=(3, 300))), 1.0)
    return d, (d > 0).astype(np.float32), counts


# each of the nine morphology methods with its arguments: (field, weight,
# counts) -> positional arguments
MORPHOLOGY = {
    "calculate_minkowski": lambda d, w, c: (d, 9, 2.0, 0.1),
    "predicted_minkowski": lambda d, w, c: (np.linspace(-2, 2, 9), 16.0),
    "calculate_peaks": lambda d, w, c: (d, 6, -1.0, 3.0, 0.1),
    "predicted_peaks": lambda d, w, c: (6, -1.0, 3.0, 16.0),
    "calculate_stacked_profile": lambda d, w, c: (d, w, 6),
    "calculate_peak_profile": lambda d, w, c: (d, 0.0, None, 6, 16.0),
    "predicted_peak_profile": lambda d, w, c: (1.2, 0.8, 6, 16.0),
    "find_voids": lambda d, w, c: (d, (8.0, 16.0, 24.0), -0.05),
    "calculate_knn_cdf": lambda d, w, c: (c, (8.0, 16.0)),
}


@pytest.mark.parametrize("name", sorted(MORPHOLOGY))
def test_unported_measure_methods_raise(generators, name):
    """Each of the Generator's nine morphology methods returns what the JAX
    package's returns on the same field: counts and catalogs exactly, the
    float results within 1e-4 of their largest value (2e-3 for the
    predictions' moment sums: the sigma table's bar)."""
    gj, gt = generators
    args = MORPHOLOGY[name](*_morphology_inputs())
    want = getattr(gj, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                               and a.ndim == 3 else a for a in args))
    got = getattr(gt, name)(*(torch.as_tensor(a) if isinstance(a, np.ndarray)
                              and a.ndim == 3 else a for a in args))
    tol = 2e-3 if name.startswith("predicted") else 1e-4
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape and np.array_equal(np.isnan(g), np.isnan(w))
        ok = ~np.isnan(w)
        if name in ("find_voids", "calculate_knn_cdf", "calculate_peaks") \
                or w.dtype.kind == "i":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g[ok], w[ok], rtol=tol,
                                       atol=tol * np.abs(w[ok]).max())
