"""The port's forecasting and multi-field models (models/fisher.py,
models/multitracer.py, models/reconstruction.py) vs the JAX package.

(a) fisher: the per-mode Kaiser model within 1e-6 of its peak (the same
    float32 operations; interpolation and exp of two libraries), its
    Fisher matrices (per mode, binned, multipoles) within 1e-5 relative
    (Jacobians by torch.func.jacfwd and jax.jacfwd, float64 sums), the
    binned covariance, forecast_errors, and the refusals;
(b) multitracer: both fields within 1e-4 of max|delta| (the same unit
    draws through the two packages' public renders: the JAX CPU path
    scales by its sigma grid, the port by K2's table amplitude, and float32
    FFTs of two libraries; 1.2e-5 measured at 16^3,
    tests/test_torch_generator.py holds such renders at 1e-3), tracer 1
    equal bit for bit to the port's own generate_delta_field, the r(k) grid
    within 1e-6 (one-ulp differences of the float32 |k| it is interpolated
    at) and the predicted cross power;
(c) reconstruction: psi_hat and delta_rec within 1e-5 of their peaks
    (KD's 'recon' kind, two paintings), displacement_at_positions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import jax  # noqa: E402,F401

from randomfield_tpu.models import fisher as jf  # noqa: E402
from randomfield_tpu.models import multitracer as jm  # noqa: E402
from randomfield_tpu.models import reconstruction as jr  # noqa: E402
from randomfield_tpu_torch.models import fisher as tf  # noqa: E402
from randomfield_tpu_torch.models import multitracer as tm  # noqa: E402
from randomfield_tpu_torch.models import reconstruction as tr  # noqa: E402
from randomfield_tpu_torch.ops import power as tpower  # noqa: E402

SHAPE, SPACING = (16, 16, 16), 16.0
POWER = tpower.load_default_power()
TABLE = (POWER.k, POWER.Pk)
MODEL, FISHER, FIELD, RENDER = 1e-6, 1e-5, 1e-5, 1e-4
PARAMS = {
    "amplitude": (("ln_amp", "bias", "f"), {"f": 0.5}),
    "shape": (("bias", "f", "alpha", "sigma_s", "sigma_fog"),
              {"f": 0.5, "sigma_s": 2.0, "sigma_fog": 3.0}),
}


def _peak_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.nanmax(np.abs(got - want)) / np.nanmax(np.abs(want)))


@pytest.fixture(scope="module", params=sorted(PARAMS))
def models(request):
    params, fixed = PARAMS[request.param]
    mj, thj = jf.make_kaiser_model(TABLE, SHAPE, SPACING, params=params,
                                   fixed=fixed)
    mt, tht = tf.make_kaiser_model(TABLE, SHAPE, SPACING, params=params,
                                   fixed=fixed, device="cpu")
    return mj, thj, mt, tht


def test_kaiser_model(models):
    mj, thj, mt, tht = models
    np.testing.assert_array_equal(tht.numpy(), np.asarray(thj))
    assert _peak_rel(mt(tht).numpy(), mj(thj)) <= MODEL


@pytest.mark.parametrize("which", ["per_mode", "binned", "multipoles"])
def test_fisher_matrices(models, which):
    mj, thj, mt, tht = models
    if which == "per_mode":
        a, b = tf.fisher_matrix(mt, tht, SHAPE), jf.fisher_matrix(mj, thj,
                                                                  SHAPE)
    elif which == "binned":
        a = tf.fisher_matrix_binned(mt, tht, SHAPE, SPACING, nbins=8)
        b = jf.fisher_matrix_binned(mj, thj, SHAPE, SPACING, nbins=8)
    else:
        a = tf.fisher_matrix_multipoles(mt, tht, SHAPE, SPACING, nbins=8,
                                        ells=(0, 2))
        b = jf.fisher_matrix_multipoles(mj, thj, SHAPE, SPACING, nbins=8,
                                        ells=(0, 2))
    assert a.shape == b.shape and _peak_rel(a, b) <= FISHER


def test_covariance_and_errors(models):
    mj, thj, mt, tht = models
    got = tf.binned_covariance_from_pgrid(mt(tht), SHAPE, SPACING, 8)
    want = jf.binned_covariance_from_pgrid(np.asarray(mj(thj)), SHAPE,
                                           SPACING, 8)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert _peak_rel(got[2], want[2]) <= MODEL
    fisher = tf.fisher_matrix(mt, tht, SHAPE)
    if len(tht) == 3:  # (ln_amp, bias, f) is exactly degenerate
        with pytest.raises(np.linalg.LinAlgError):
            tf.forecast_errors(fisher)
    else:
        assert tf.forecast_errors(fisher, list("abcde")) == \
            jf.forecast_errors(fisher, list("abcde"))


def test_fisher_refusals():
    with pytest.raises(ValueError):
        tf.make_kaiser_model(TABLE, SHAPE, SPACING, params=("w0",),
                             device="cpu")
    with pytest.raises(ValueError):
        tf.make_kaiser_model(TABLE, SHAPE, SPACING, interpolation="cubic",
                             device="cpu")
    mt, tht = tf.make_kaiser_model(TABLE, SHAPE, SPACING, device="cpu")
    with pytest.raises(ValueError):
        tf.fisher_matrix_multipoles(mt, tht, SHAPE, SPACING, ells=(0, 3))


@pytest.mark.parametrize("correlation", ["scalar", "table"])
def test_multitracer(correlation):
    r = 0.6 if correlation == "scalar" else (np.logspace(-2, 1, 10),
                                            np.linspace(0.9, -0.3, 10))
    j = jm.MultiTracerGenerator(*SHAPE, SPACING, correlation=r)
    t = tm.MultiTracerGenerator(*SHAPE, SPACING, correlation=r, device="cpu")
    assert _peak_rel(t.correlation_grid.numpy(), j.correlation_grid) <= MODEL
    kw = dict(smoothing_length=20.0) if correlation == "table" else {}
    want = j.generate_fields(3, **kw)
    got = t.generate_fields(3, **kw)
    for a, b in zip(got, want):
        assert _peak_rel(a.numpy(), b) <= RENDER
    assert torch.equal(got[0], t.g1.generate_delta_field(3, **kw))
    pw, pg = j.predicted_cross_power(8, **kw), t.predicted_cross_power(8,
                                                                        **kw)
    np.testing.assert_array_equal(pg[2], pw[2])
    assert _peak_rel(pg[1], pw[1]) <= MODEL
    with pytest.raises(ValueError):
        tm.MultiTracerGenerator(*SHAPE, SPACING, correlation=1.5,
                                device="cpu")


@pytest.mark.parametrize("kw", [{}, dict(smoothing=15.0, bias=2.0, f=0.6,
                                         los_axis=1, window="tsc")])
def test_reconstruction(kw):
    rng = np.random.default_rng(len(kw))
    delta = (0.3 * rng.normal(size=SHAPE)).astype(np.float32)
    est = {k: v for k, v in kw.items() if k != "window"}
    psi_j = jr.estimate_displacement(delta, SPACING, **est)
    psi_t = tr.estimate_displacement(torch.from_numpy(delta), SPACING, **est)
    assert _peak_rel(psi_t.numpy(), psi_j) <= FIELD
    rec_j, _ = jr.reconstruct_field(delta, SPACING, **kw)
    rec_t, psi = tr.reconstruct_field(torch.from_numpy(delta), SPACING, **kw)
    assert _peak_rel(rec_t.numpy(), rec_j) <= FIELD
    pos = rng.random((200, 3)) * SHAPE[0] * SPACING
    np.testing.assert_array_equal(
        tr.displacement_at_positions(psi, pos, SPACING),
        jr.displacement_at_positions(psi.numpy(), pos, SPACING))
