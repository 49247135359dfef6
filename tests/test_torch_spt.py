"""The port's SPT and IR-resummation models (models/spt.py,
models/irresum.py) and the powerspec functions they use, vs the JAX
package.

(a) host theory within 1e-12 relative: p13_kernel, sigma_v2,
    oneloop_terms, oneloop_power, sound_horizon, nowiggle_power,
    bao_damping_sigma2, ir_resummed_terms (both orders), ir_resummed_power,
    and powerspec's eh98_nowiggle_transfer / _power, power_law_power,
    load_camb_power, power_at_redshift (the same float64 numpy);
(b) second_order_density within 1e-5 of max|delta2| (one forward and 13
    inverse float32 transforms of two FFT libraries, KD's new 'deriv'
    kind among the factors);
(c) predicted_tree_bispectrum: the same triples, B within 1e-4 relative,
    and ntri equal to the port estimator's triangle counts exactly and to
    the JAX package's within 1e-4 (the JAX package sums the unit shells in
    float32: up to 0.5 off the integer triad counts at 16^3, the port in
    float64);
(d) KD's 'deriv' and 'recon' kinds against a float64 numpy evaluation of
    the JAX package's factors.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import jax  # noqa: E402,F401

from randomfield_tpu.models import irresum as ji  # noqa: E402
from randomfield_tpu.models import powerspec as jp  # noqa: E402
from randomfield_tpu.models import spt as js  # noqa: E402
from randomfield_tpu_torch.models import irresum as ti  # noqa: E402
from randomfield_tpu_torch.models import powerspec as tp  # noqa: E402
from randomfield_tpu_torch.models import spt as ts  # noqa: E402
from randomfield_tpu_torch.ops import derived, grid  # noqa: E402
from randomfield_tpu_torch.ops import power as tpower  # noqa: E402
from randomfield_tpu_torch.validate import bispectrum as tbisp  # noqa: E402

THEORY = 1e-12
FIELD = 1e-5
BISPECTRUM = 1e-4
POWER = tpower.load_default_power()
TABLE = (POWER.k, POWER.Pk)
KS = np.logspace(-2.0, -0.5, 12)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.where(want != 0, np.abs(want), 1.0)
    return float(np.max(np.abs(got - want) / scale))


THEORY_CASES = {
    "p13_kernel": lambda m: m.p13_kernel(np.array(
        [1e-4, 2e-3, 0.5, 1.0, 1.0 + 1e-13, 3.0, 19.9, 20.1, 400.0])),
    "sigma_v2": lambda m: m.sigma_v2(TABLE),
    "oneloop_terms": lambda m: tuple(m.oneloop_terms(
        TABLE, k=KS, nq=256, nx=16, z=0.5, cosmology="Planck13")),
    "oneloop_power": lambda m: tuple(m.oneloop_power(TABLE, k=KS, nq=256,
                                                     nx=16)),
}
IR_CASES = {
    "sound_horizon": lambda m: m.sound_horizon("Planck15"),
    "nowiggle_power": lambda m: tuple(m.nowiggle_power(TABLE)),
    "bao_damping_sigma2": lambda m: (m.bao_damping_sigma2(TABLE),
                                     m.bao_damping_sigma2(TABLE, ks=0.0)),
    "ir_lo": lambda m: tuple(np.asarray(v, np.float64) for v in
                             m.ir_resummed_terms(TABLE, k=KS, order="lo",
                                                 cs2=1.5)),
    "ir_oneloop": lambda m: tuple(np.asarray(v, np.float64) for v in
                                  m.ir_resummed_terms(
                                      TABLE, k=KS, nq=256, nx=16, z=1.0,
                                      cosmology="Planck13")),
    "ir_resummed_power": lambda m: tuple(m.ir_resummed_power(
        TABLE, k=KS, nq=256, nx=16)),
}


def _compare(got, want):
    for a, b in zip(np.atleast_1d(got) if not isinstance(got, tuple) else got,
                    np.atleast_1d(want) if not isinstance(want, tuple)
                    else want):
        assert _rel(a, b) <= THEORY


@pytest.mark.parametrize("name", sorted(THEORY_CASES))
def test_spt_theory(name):
    _compare(THEORY_CASES[name](ts), THEORY_CASES[name](js))


@pytest.mark.parametrize("name", sorted(IR_CASES))
def test_irresum_theory(name):
    _compare(IR_CASES[name](ti), IR_CASES[name](ji))


POWERSPEC_CASES = {
    "eh98_nowiggle_transfer": lambda m: m.eh98_nowiggle_transfer(
        _cosmology(m), np.logspace(-4, 1, 50)),
    "eh98_nowiggle_power": lambda m: m.eh98_nowiggle_power(
        "Planck18", np.logspace(-4, 1, 50)),
    "power_law_power": lambda m: m.power_law_power(np.logspace(-3, 1, 30),
                                                   ns=-1.5, sigma8=0.7),
    "power_at_redshift": lambda m: m.power_at_redshift(TABLE, "Planck13",
                                                       2.0),
}


def _cosmology(m):
    mod = __import__(m.__name__.replace("powerspec", "cosmology"),
                     fromlist=["create_cosmology"])
    return mod.create_cosmology("Planck15")


@pytest.mark.parametrize("name", sorted(POWERSPEC_CASES))
def test_powerspec_functions(name):
    got, want = POWERSPEC_CASES[name](tp), POWERSPEC_CASES[name](jp)
    _compare(tuple(np.atleast_2d(got)), tuple(np.atleast_2d(want)))


def test_load_camb_power(tmp_path):
    path = tmp_path / "matterpower.dat"
    np.savetxt(path, np.stack([POWER.k, POWER.Pk, POWER.Pk], 1),
               header="k P extra")
    for a, b in zip(tp.load_camb_power(path), jp.load_camb_power(path)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tp.load_camb_power(path, h_units=False)
    with pytest.raises(ValueError):
        tp.power_law_power(np.ones(3), ns=-3.0)


@pytest.mark.parametrize("shape", [(16, 16, 16), (15, 16, 18)])
def test_second_order_density(shape):
    rng = np.random.default_rng(sum(shape))
    delta = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(js.second_order_density(delta, 8.0))
    got = ts.second_order_density(torch.from_numpy(delta), 8.0)
    assert got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - want)) <= FIELD * np.max(np.abs(want))


@pytest.mark.parametrize("shape,smoothing", [((16, 16, 16), 0.0),
                                             ((15, 16, 17), 8.0)])
def test_predicted_tree_bispectrum(shape, smoothing):
    kw = dict(nbins=4, smoothing_length=smoothing)
    kc, tri, b, ntri = ts.predicted_tree_bispectrum(TABLE, shape, 16.0,
                                                    device="cpu", **kw)
    want = js.predicted_tree_bispectrum(TABLE, shape, 16.0, **kw)
    np.testing.assert_array_equal(kc, want[0])
    np.testing.assert_array_equal(tri, want[1])
    assert _rel(b, want[2]) <= BISPECTRUM
    assert _rel(ntri, want[3]) <= BISPECTRUM
    edges, all_tri = tbisp.bispectrum_bins(shape, 16.0, 4)
    den = tbisp.triangle_counts(shape, 16.0, edges, all_tri, "cpu")
    ncells = shape[0] * shape[1] * shape[2]
    np.testing.assert_array_equal(ntri, (den / ncells)[den / ncells > 0.5])


def _reference_factor(kind, shape, spacing, axis, los, pref):
    """The JAX package's spectral factor in float64: i k_a (deriv, the
    Nyquist entries zeroed) or i k_a / k^2 S / (b + f mu^2) (recon)."""
    full = [k.numpy().astype(np.float64) for k in
            grid.kvectors(shape, spacing)]
    zeroed = [k.numpy().astype(np.float64) for k in
              derived.grad_kvectors(shape, spacing)]
    view = [(slice(None), None, None), (None, slice(None), None),
            (None, None, slice(None))]
    ka = zeroed[axis][view[axis]]
    if kind == "deriv":
        return 1j * pref[0] * ka
    k2 = sum(full[a][view[a]] ** 2 for a in range(3))
    safe = np.where(k2 > 0, k2, 1.0)
    p, b, f, sig = pref
    mu2 = np.where(k2 > 0, full[los][view[los]] ** 2 / safe, 0.0)
    smooth = np.exp(-0.5 * k2 * sig * sig)
    return 1j * p * ka * np.where(k2 > 0, 1.0 / safe, 0.0) * smooth / (
        b + f * mu2)


@pytest.mark.parametrize("kind,axis,los,pref", [
    ("deriv", 0, 2, (0.5,)), ("deriv", 2, 2, (1.0,)),
    ("recon", 1, 2, (1e-3, 1.5, 0.7, 10.0)),
    ("recon", 0, 1, (2e-3, 2.0, 0.0, 15.0)),
])
def test_kd_new_kinds(kind, axis, los, pref):
    shape, spacing = (16, 12, 18), 8.0
    rng = np.random.default_rng(axis + 3 * los)
    c = (rng.normal(size=grid.half_shape(shape))
         + 1j * rng.normal(size=grid.half_shape(shape)))
    re = torch.as_tensor(c.real, dtype=torch.float32)
    im = torch.as_tensor(c.imag, dtype=torch.float32)
    before = derived.KD_LAUNCHES
    a, b = derived.apply_kernel(re, im, shape, spacing, kind, axis, pref,
                                los_axis=los)
    assert derived.KD_LAUNCHES == before  # the CPU path does not count
    want = c * _reference_factor(kind, shape, spacing, axis, los, pref)
    got = a.numpy() + 1j * b.numpy()
    assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want))
    with pytest.raises(ValueError):
        derived.apply_kernel(re, im, shape, spacing, kind, 3, pref)
