"""The port's FFTLog (ops/fftlog.py) and the streaming model's velocity
correlations (models/streaming.py) vs the JAX package's.

Both are host float64 numpy/scipy in both packages, so every output is held
to the reference at 1e-12 relative (of its largest value).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

from randomfield_tpu.models import streaming as jstreaming  # noqa: E402
from randomfield_tpu.ops import fftlog as jfftlog  # noqa: E402
from randomfield_tpu.ops import power as jpower  # noqa: E402
from randomfield_tpu_torch.models import streaming  # noqa: E402
from randomfield_tpu_torch.ops import fftlog  # noqa: E402

# the same float64 operations in the same order
EXACT = 1e-12


def _close(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= EXACT * max(np.abs(w).max(), 1e-300)


@pytest.fixture(scope="module")
def table():
    t = jpower.load_default_power()
    return np.asarray(t.k), np.asarray(t.Pk)


@pytest.mark.parametrize("ell,q", [(0, 1.0), (0, 1.5), (2, 0.5), (4, -0.5)])
@pytest.mark.parametrize("lowring", [True, False])
def test_fftlog_bessel_matches_jax(ell, q, lowring):
    k = np.geomspace(1e-4, 1e2, 256)
    f = k ** 1.2 * np.exp(-k)
    _close(fftlog.fftlog_bessel(k, f, ell=ell, q=q, kr=2.0, lowring=lowring),
           jfftlog.fftlog_bessel(k, f, ell=ell, q=q, kr=2.0, lowring=lowring))


@pytest.mark.parametrize("mu,q", [(0, 1.0), (2, 0.0)])
def test_fftlog_bessel_2d_matches_jax(mu, q):
    k = np.geomspace(1e-3, 1e3, 512)
    f = k ** 2 * np.exp(-k * k)
    _close(fftlog.fftlog_bessel_2d(k, f, mu=mu, q=q),
           jfftlog.fftlog_bessel_2d(k, f, mu=mu, q=q))


@pytest.mark.parametrize("ell", [0, 2, 4])
def test_xi_from_power_and_back_match_jax(table, ell):
    r, xi = fftlog.xi_from_power(table, ell=ell, n=1024)
    rj, xij = jfftlog.xi_from_power(table, ell=ell, n=1024)
    _close((r, xi), (rj, xij))
    rr = np.geomspace(1.0, 200.0, 512)
    xr = np.interp(rr, r, xi)
    _close(fftlog.power_from_xi(rr, xr, ell=ell),
           jfftlog.power_from_xi(rr, xr, ell=ell))


def test_angular_correlation_and_grids_match_jax():
    ells = np.geomspace(10.0, 1e4, 200)
    cl = 1e-9 * (ells / 100.0) ** -1.5
    _close(fftlog.angular_correlation(ells, cl, n=1024),
           jfftlog.angular_correlation(ells, cl, n=1024))
    _close([fftlog.log_grid(1e-3, 10.0, 100)],
           [jfftlog.log_grid(1e-3, 10.0, 100)])


@pytest.mark.parametrize("signed,taper", [(False, None), (False, 1.0),
                                          (True, None), (True, 0.5)])
def test_resample_loglog_matches_jax(signed, taper):
    x = np.geomspace(0.1, 10.0, 40)
    f = np.sin(x) if signed else x ** -1.3
    xn = np.geomspace(0.01, 100.0, 300)
    _close([fftlog.resample_loglog(x, f, xn, extrap_decades=taper)],
           [jfftlog.resample_loglog(x, f, xn, extrap_decades=taper)])


def test_prep_power_and_velocity_correlations_match_jax(table):
    _close(fftlog._prep_power(table, 1024, 2.0),
           jfftlog._prep_power(table, 1024, 2.0))
    r = np.linspace(1.0, 150.0, 64)
    got = streaming.velocity_correlations(table, r, f=0.7, n=1024)
    want = jstreaming.velocity_correlations(table, r, f=0.7, n=1024)
    _close(got[:2], want[:2])
    assert got[2] == pytest.approx(want[2], rel=EXACT)


@pytest.mark.parametrize("call,match", [
    (lambda m: m.fftlog_bessel(np.geomspace(1, 2, 8), np.ones(8), ell=0,
                               q=2.5), "Mellin strip"),
    (lambda m: m.fftlog_bessel_2d(np.geomspace(1, 2, 8), np.ones(8), q=1.6),
     "Mellin strip"),
    (lambda m: m.fftlog_bessel(np.linspace(1, 2, 8), np.ones(8)),
     "log-uniform"),
    (lambda m: m.xi_from_power((np.geomspace(1e-3, 1, 9), np.ones(9)),
                               ell=1), "even ell"),
    (lambda m: m.log_grid(2.0, 1.0), "0 < xmin < xmax"),
])
def test_refusals_match_jax(call, match):
    for m in (fftlog, jfftlog):
        with pytest.raises(ValueError, match=match):
            call(m)


def test_port_fftlog_imports_no_jax():
    import sys
    import subprocess

    code = ("import sys; import randomfield_tpu_torch.ops.fftlog, "
            "randomfield_tpu_torch.models.streaming; "
            "assert 'jax' not in sys.modules and "
            "'randomfield_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
