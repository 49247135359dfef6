"""The port's Minkowski functionals (validate/minkowski.py, KM's plain
version ops/minkowski.py) vs the JAX package's validate/minkowski.py, on
the same numpy fields, and the JAX package's own gates on the port.

Bars: v0 exactly equal (the same float32 u against the same float32 edges:
counts are integers); v1-v3 within 1e-4 of max|v_i| (the same float32
invariants of derivative fields from two float32 FFT libraries, summed in
float64 here and float32 there); spectral_moments within 2e-3 (float64
sums of a float64 interpolant here, float32 ones there: the sigma table's
bar); gaussian_minkowski within 1e-6 (float32 erfc there).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import randomfield_tpu as rf  # noqa: E402
from randomfield_tpu.validate import minkowski as jmk  # noqa: E402
import randomfield_tpu_torch as rft  # noqa: E402
from randomfield_tpu_torch.ops import minkowski as km  # noqa: E402
from randomfield_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from randomfield_tpu_torch.validate import minkowski as mk  # noqa: E402

V_TOL = 1e-4
MOMENT_RTOL = 2e-3


def smooth_field(shape, seed, cells=2.0):
    """A float32 Gaussian field: numpy white noise times exp(-k^2 s^2 / 2)
    (s in cells)."""
    x = np.random.default_rng(seed).standard_normal(shape)
    k2 = sum(np.meshgrid(*[(2 * np.pi * np.fft.fftfreq(n)) ** 2
                           for n in shape[:2]]
                         + [(2 * np.pi * np.fft.rfftfreq(shape[2])) ** 2],
                         indexing="ij"))
    c = np.fft.rfftn(x) * np.exp(-0.5 * k2 * cells * cells)
    return np.fft.irfftn(c, s=shape, axes=(0, 1, 2)).astype(np.float32)


@pytest.mark.parametrize("shape,spacing,nbins,nu_max", [
    ((32, 32, 32), 4.0, 24, 3.0), ((16, 24, 15), 8.0, 9, 2.0),
])
def test_minkowski_functionals_match_jax(shape, spacing, nbins, nu_max):
    d = smooth_field(shape, 3)
    s0 = float(np.std(d))
    want = jmk.minkowski_functionals(jnp.asarray(d), spacing, nbins=nbins,
                                     nu_max=nu_max, sigma0=s0)
    got = mk.minkowski_functionals(torch.as_tensor(d), spacing, nbins=nbins,
                                   nu_max=nu_max, sigma0=s0)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    for k in (2, 3, 4):
        w = np.asarray(want[k], np.float64)
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=V_TOL * np.abs(w).max())


def test_threshold_sums_plain_bins_like_searchsorted():
    """The plain version's counts are the edge search's, its sums those of
    invariants_plain over each bin's voxels (float64)."""
    rng = np.random.default_rng(5)
    u = torch.as_tensor(rng.standard_normal((20, 6, 7)).astype(np.float32))
    derivs = [torch.as_tensor(rng.standard_normal(u.shape).astype(
        np.float32)) for _ in range(9)]
    derivs[0][0, 0, :3] = 0.0  # |g| = 0 voxels
    derivs[1][0, 0, :3] = 0.0
    derivs[2][0, 0, :3] = 0.0
    edges = np.linspace(-2.0, 2.0, 8)
    counts, sums = km.threshold_sums(u, derivs, edges)
    w = km.invariants_plain(derivs[:3], derivs[3:])
    idx = np.searchsorted(edges.astype(np.float32), u.numpy(),
                          side="right") - 1
    assert counts[-1] == int((idx >= 7).sum())
    for b in range(7):
        sel = torch.as_tensor(idx == b)
        assert counts[b] == int(sel.sum())
        for q in range(3):
            np.testing.assert_allclose(
                float(sums[q, b]), float(w[q][sel].double().sum()),
                rtol=1e-12, atol=1e-12)
    assert all(float(t[0, 0, 0]) == 0.0 for t in w[1:])


@pytest.mark.parametrize("smoothing,interpolation", [
    (0.0, "log10k"), (6.0, "loglog")])
def test_spectral_moments_match_jax(smoothing, interpolation):
    shape, spacing = (32, 24, 20), 4.0
    power = rf.load_default_power()
    want = jmk.spectral_moments(power, shape, spacing, smoothing,
                                interpolation)
    got = mk.spectral_moments(rft.load_default_power(), shape, spacing,
                              smoothing, interpolation, device="cpu")
    np.testing.assert_allclose(got, want, rtol=MOMENT_RTOL)


def test_gaussian_minkowski_matches_jax():
    nu = np.linspace(-3.0, 3.0, 13)
    for g, w in zip(mk.gaussian_minkowski(nu, 0.4, 0.03),
                    jmk.gaussian_minkowski(nu, 0.4, 0.03)):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-6 * np.abs(w).max())


def test_generator_methods_match_jax():
    shape, spacing, sm = (32, 32, 32), 4.0, 8.0
    gj = rf.Generator(*shape, grid_spacing=spacing)
    gt = rft.Generator(*shape, grid_spacing=spacing, device="cpu")
    d = smooth_field(shape, 8)
    want = gj.calculate_minkowski(jnp.asarray(d), nbins=11, sigma0=0.3)
    got = gt.calculate_minkowski(torch.as_tensor(d), nbins=11, sigma0=0.3)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    for g, w in zip(gt.predicted_minkowski(got[0], smoothing_length=sm),
                    gj.predicted_minkowski(got[0], smoothing_length=sm)):
        np.testing.assert_allclose(g, w, rtol=MOMENT_RTOL,
                                   atol=MOMENT_RTOL * np.abs(w).max())


def _measure_avg(g, sm, seeds, s0, nbins=13, nu_max=3.0):
    accum = None
    for s in seeds:
        d = g.generate_delta_field(s, smoothing_length=sm,
                                   apply_lightcone=False)
        nu, v0, v1, v2, v3 = g.calculate_minkowski(d, nbins=nbins,
                                                   nu_max=nu_max, sigma0=s0)
        row = np.stack([v0, v1, v2, v3])
        accum = row if accum is None else accum + row
    return nu, accum / len(seeds)


def test_gaussian_minkowski_gate():
    """The JAX package's gate: measured v0..v3 of rendered fields against
    the Tomita forms with the band-limited moments (its tolerances)."""
    n, sp, sm = 64, 4.0, 12.0
    g = rft.Generator(n, n, n, grid_spacing=sp, device="cpu")
    s0sq, s1sq = mk.spectral_moments(g.power, (n, n, n), sp,
                                     smoothing_length=sm, device="cpu")
    np.testing.assert_allclose(s0sq, g.predicted_variance(smoothing_length=sm),
                               rtol=1e-4)
    nu, meas = _measure_avg(g, sm, range(4), np.sqrt(s0sq))
    theory = np.stack(g.predicted_minkowski(nu, smoothing_length=sm))
    for k, tol in ((0, 0.03), (1, 0.06), (2, 0.15), (3, 0.18)):
        scale = np.abs(theory[k]).max()
        assert np.abs(meas[k] - theory[k]).max() < tol * scale, k


def test_minkowski_qualitative_structure():
    n, sp, sm = 48, 4.0, 10.0
    g = rft.Generator(n, n, n, grid_spacing=sp, device="cpu")
    d = g.generate_delta_field(0, smoothing_length=sm, apply_lightcone=False)
    nu, v0, v1, v2, v3 = g.calculate_minkowski(d, nbins=13, nu_max=2.5)
    assert np.all(np.diff(v0) <= 1e-12)
    assert v0[0] > 0.95 and v0[-1] < 0.05
    assert np.all(v1 > 0)
    mid = len(nu) // 2
    assert abs(v2[mid]) < 0.3 * np.abs(v2).max()
    assert v2[-2] > 0 and v2[1] < 0
    assert v3[mid] < 0 and v3[0] > 0 and v3[-1] > 0


def test_minkowski_default_sigma0_and_units():
    n, sm = 32, 8.0
    g1 = rft.Generator(n, n, n, grid_spacing=8.0, device="cpu")
    s1 = mk.spectral_moments(g1.power, (n, n, n), 8.0, smoothing_length=sm,
                             device="cpu")
    s2 = mk.spectral_moments(g1.power, (n, n, n), 4.0,
                             smoothing_length=sm / 2, device="cpu")
    assert np.sqrt(s2[1] / s2[0]) > np.sqrt(s1[1] / s1[0])
    d = g1.generate_delta_field(3, smoothing_length=sm, apply_lightcone=False)
    nu, v0, _, _, _ = g1.calculate_minkowski(d, nbins=9, nu_max=2.0)
    assert abs(v0[len(nu) // 2] - 0.5) < 0.05


def test_mesh_and_bad_inputs_raise():
    d = torch.zeros((16, 16, 16))
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        mk.minkowski_functionals(d, 8.0, mesh=pmesh.make_mesh(
            space=1, device="cpu"))
    with pytest.raises(ValueError, match="nine"):
        km.threshold_sums(d, [d] * 8, np.linspace(-1, 1, 5))
