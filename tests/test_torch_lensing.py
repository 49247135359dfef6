"""The port's weak-lensing functions (models/lensing.py) vs the JAX
package: every public function, each output within 1e-5 of its peak (the
float32 plane sums and 2-D transforms of two libraries; the per-plane
weights and the predictions are the same host float64, the predictions'
only float32 step being the power interpolation); the E/B decomposition
on noisy, masked shear so that B is a signal; add_shape_noise equal to
JAX's draws on every pixel (threefry.normal_exact replays XLA's erf_inv,
its tail's correctly rounded square root included)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import jax  # noqa: E402,F401

from randomfield_tpu.models import lensing as jl  # noqa: E402
from randomfield_tpu_torch.models import lensing as tl  # noqa: E402
from randomfield_tpu_torch.ops import power as tpower  # noqa: E402

SHAPE, SPACING, Z_SOURCE = (32, 32, 16), 8.0, 1.0
BAR = 1e-5
POWER = tpower.load_default_power()
TABLE = (POWER.k, POWER.Pk)


@pytest.fixture(scope="module")
def maps():
    rng = np.random.default_rng(0)
    delta = rng.normal(size=SHAPE).astype(np.float32)
    kappa = np.asarray(jl.convergence_map(delta, "Planck13", SPACING,
                                          Z_SOURCE))
    g1, g2 = (np.asarray(x) for x in jl.convergence_to_shear(kappa, SPACING))
    g1, g2 = (np.asarray(x) for x in jl.add_shape_noise(g1, g2, 0.01, 4))
    mask = (rng.random(SHAPE[:2]) > 0.2).astype(np.float64)
    return delta, kappa, g1, g2, mask


def _peak_rel(got, want):
    got = [np.asarray(g, np.float64) for g in (got if isinstance(got, tuple)
                                              else (got,))]
    want = [np.asarray(w, np.float64) for w in (want if isinstance(
        want, tuple) else (want,))]
    return max(float(np.nanmax(np.abs(g - w)) / np.nanmax(np.abs(w)))
               for g, w in zip(got, want))


T = torch.from_numpy
CASES = {
    "lensing_efficiency": lambda m, d: m.lensing_efficiency(
        "Planck13", SHAPE[2], SPACING, Z_SOURCE, z0=0.2),
    "convergence_map": lambda m, d: m.convergence_map(
        d[0] if m is jl else T(d[0]), "Planck13", SPACING, Z_SOURCE),
    "tomographic_convergence": lambda m, d: m.tomographic_convergence(
        d[0] if m is jl else T(d[0]), "Planck13", SPACING, [0.5, 1.0, 2.0]),
    "convergence_to_shear": lambda m, d: tuple(m.convergence_to_shear(
        d[1] if m is jl else T(d[1]), SPACING)),
    "shear_to_eb": lambda m, d: tuple(m.shear_to_eb(
        *((d[2], d[3]) if m is jl else (T(d[2]), T(d[3]))), SPACING)),
    "shear_power_eb": lambda m, d: tuple(m.shear_power_eb(
        *((d[2], d[3]) if m is jl else (T(d[2]), T(d[3]))), SPACING)),
    "convergence_power": lambda m, d: tuple(m.convergence_power(
        d[1] if m is jl else T(d[1]), SPACING, nbins=10)),
    "convergence_cross_power": lambda m, d: tuple(m.convergence_cross_power(
        *((d[1], d[2]) if m is jl else (T(d[1]), T(d[2]))), SPACING)),
    "convergence_correlation": lambda m, d: tuple(m.convergence_correlation(
        d[1] if m is jl else T(d[1]), SPACING)),
    "masked_convergence_power": lambda m, d: tuple(
        m.masked_convergence_power(d[1] if m is jl else T(d[1]), d[4],
                                   SPACING)),
    "masked_shear_power_eb": lambda m, d: tuple(m.masked_shear_power_eb(
        *((d[2], d[3]) if m is jl else (T(d[2]), T(d[3]))), d[4], SPACING)),
    "shape_noise_power": lambda m, d: m.shape_noise_power(0.3, SPACING),
    "predicted_convergence_power": lambda m, d: tuple(
        m.predicted_convergence_power(TABLE, SHAPE, SPACING, _w())),
    "predicted_convergence_cross_power": lambda m, d: tuple(
        m.predicted_convergence_cross_power(TABLE, SHAPE, SPACING, _w(),
                                            0.5 * _w())),
    "predicted_convergence_correlation": lambda m, d: tuple(
        m.predicted_convergence_correlation(TABLE, SHAPE, SPACING, _w())),
    "predicted_masked_convergence_power": lambda m, d: tuple(
        m.predicted_masked_convergence_power(TABLE, d[4], SHAPE, SPACING,
                                             _w())),
    "predicted_masked_shear_power_eb": lambda m, d: tuple(
        m.predicted_masked_shear_power_eb(TABLE, d[4], SHAPE, SPACING,
                                          _w())),
}


def _w():
    return jl.lensing_efficiency("Planck13", SHAPE[2], SPACING, Z_SOURCE)


@pytest.mark.parametrize("name", sorted(CASES))
def test_public_function(maps, name):
    want = CASES[name](jl, maps)
    got = CASES[name](tl, maps)
    if isinstance(got, torch.Tensor) or (isinstance(got, tuple) and
                                         isinstance(got[0], torch.Tensor)):
        got = tuple(g.numpy() for g in got) if isinstance(got, tuple) \
            else got.numpy()
    assert _peak_rel(got, want) <= BAR


@pytest.mark.parametrize("seed", [0, 1])
def test_add_shape_noise(maps, seed):
    _, _, g1, g2, _ = maps
    want = [np.asarray(x) for x in jl.add_shape_noise(g1, g2, 0.3, seed)]
    got = [x.numpy() for x in tl.add_shape_noise(T(g1), T(g2), 0.3, seed)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert tl.add_shape_noise(T(g1), T(g2), 0.3, seed)[0].dtype == \
        torch.float32
