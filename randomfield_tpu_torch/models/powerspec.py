"""Linear matter power spectrum models and the power-spec resolver.

The subset of ``randomfield_tpu/models/powerspec.py`` that scene setup
needs: the Eisenstein & Hu (1998) and BBKS linear spectra,
:func:`make_power_table` (which generated the shipped default table), and
:func:`resolve_power`.
Host float64 numpy, the same expressions as the JAX package's module; k in
h/Mpc, P in (Mpc/h)^3, normalized to the cosmology's sigma8.
"""

from __future__ import annotations

import numpy as np

from randomfield_tpu_torch.models.cosmology import Cosmology, create_cosmology

__all__ = [
    "eh98_transfer",
    "eisenstein_hu_power",
    "bbks_transfer",
    "bbks_power",
    "make_power_table",
    "resolve_power",
]


def eh98_transfer(cosmology: Cosmology, k_mpc):
    """Full EH98 transfer function T(k); ``k_mpc`` in 1/Mpc (not h/Mpc)."""
    k = np.asarray(k_mpc, dtype=np.float64)
    omhh = cosmology.Om0 * cosmology.h**2
    obhh = cosmology.Ob0 * cosmology.h**2
    f_baryon = cosmology.Ob0 / cosmology.Om0
    theta = cosmology.Tcmb0 / 2.7

    z_eq = 2.50e4 * omhh / theta**4  # really 1 + z_eq
    k_eq = 0.0746 * omhh / theta**2  # [1/Mpc]

    b1 = 0.313 * omhh**-0.419 * (1.0 + 0.607 * omhh**0.674)
    b2 = 0.238 * omhh**0.223
    z_drag = (
        1291.0 * omhh**0.251 / (1.0 + 0.659 * omhh**0.828) * (1.0 + b1 * obhh**b2)
    )

    r_drag = 31.5 * obhh / theta**4 * (1000.0 / (1.0 + z_drag))
    r_eq = 31.5 * obhh / theta**4 * (1000.0 / z_eq)

    s = (
        2.0
        / (3.0 * k_eq)
        * np.sqrt(6.0 / r_eq)
        * np.log((np.sqrt(1.0 + r_drag) + np.sqrt(r_drag + r_eq)) / (1.0 + np.sqrt(r_eq)))
    )
    k_silk = 1.6 * obhh**0.52 * omhh**0.73 * (1.0 + (10.4 * omhh) ** -0.95)

    a1 = (46.9 * omhh) ** 0.670 * (1.0 + (32.1 * omhh) ** -0.532)
    a2 = (12.0 * omhh) ** 0.424 * (1.0 + (45.0 * omhh) ** -0.582)
    alpha_c = a1 ** (-f_baryon) * a2 ** (-(f_baryon**3))

    bc1 = 0.944 / (1.0 + (458.0 * omhh) ** -0.708)
    bc2 = (0.395 * omhh) ** -0.0266
    beta_c = 1.0 / (1.0 + bc1 * ((1.0 - f_baryon) ** bc2 - 1.0))

    q = k / (13.41 * k_eq)
    xx = k * s

    ln_beta = np.log(np.e + 1.8 * beta_c * q)
    ln_nobeta = np.log(np.e + 1.8 * q)
    c_alpha = 14.2 / alpha_c + 386.0 / (1.0 + 69.9 * q**1.08)
    c_noalpha = 14.2 + 386.0 / (1.0 + 69.9 * q**1.08)

    f = 1.0 / (1.0 + (xx / 5.4) ** 4)
    t_cdm = f * ln_beta / (ln_beta + c_noalpha * q**2) + (1.0 - f) * ln_beta / (
        ln_beta + c_alpha * q**2
    )

    y = z_eq / (1.0 + z_drag)
    sq = np.sqrt(1.0 + y)
    g_y = y * (-6.0 * sq + (2.0 + 3.0 * y) * np.log((sq + 1.0) / (sq - 1.0)))
    alpha_b = 2.07 * k_eq * s * (1.0 + r_drag) ** -0.75 * g_y
    beta_node = 8.41 * omhh**0.435
    beta_b = 0.5 + f_baryon + (3.0 - 2.0 * f_baryon) * np.sqrt((17.2 * omhh) ** 2 + 1.0)

    with np.errstate(divide="ignore", invalid="ignore"):
        s_tilde = s / (1.0 + (beta_node / xx) ** 3) ** (1.0 / 3.0)
        xxt = k * s_tilde
        sinc = np.where(xxt > 0, np.sin(xxt) / np.where(xxt > 0, xxt, 1.0), 1.0)
        t0_nob = ln_nobeta / (ln_nobeta + c_noalpha * q**2)
        t_baryon = sinc * (
            t0_nob / (1.0 + (xx / 5.2) ** 2)
            + np.where(
                xx > 0,
                alpha_b / (1.0 + (beta_b / np.where(xx > 0, xx, 1.0)) ** 3),
                0.0,
            )
            * np.exp(-((k / k_silk) ** 1.4))
        )

    t_full = f_baryon * t_baryon + (1.0 - f_baryon) * t_cdm
    return np.where(k > 0, t_full, 1.0)


def _sigma_r_unnormalized(k_h, pk, r=8.0):
    """Top-hat sigma(R) from a tabulated (k, P): trapezoid in ln k."""
    x = k_h * r
    w = np.where(x > 1e-4, 3.0 * (np.sin(x) - x * np.cos(x)) / x**3, 1.0 - x**2 / 10.0)
    integrand = k_h**3 * pk * w**2 / (2.0 * np.pi**2)
    return np.sqrt(np.trapezoid(integrand, np.log(k_h)))


def eisenstein_hu_power(cosmology=None, k_h=None):
    """Linear P(k) at z=0, normalized to sigma8; k in h/Mpc, P in (Mpc/h)^3."""
    cosmology = create_cosmology(cosmology)
    k_h = np.asarray(k_h, dtype=np.float64)
    k_mpc = k_h * cosmology.h
    t = eh98_transfer(cosmology, k_mpc)
    p_shape = k_h**cosmology.ns * t**2
    # normalize on a dense internal grid so sigma8 doesn't depend on the
    # caller's sampling of k
    k_ref = np.logspace(-4.5, 2.5, 4096)
    t_ref = eh98_transfer(cosmology, k_ref * cosmology.h)
    s8 = _sigma_r_unnormalized(k_ref, k_ref**cosmology.ns * t_ref**2, r=8.0)
    return p_shape * (cosmology.sigma8 / s8) ** 2


def bbks_transfer(cosmology: Cosmology, k_mpc):
    """BBKS CDM transfer function (Bardeen et al. 1986, eq. G3), with the
    Sugiyama (1995) baryon correction to the shape parameter."""
    k = np.asarray(k_mpc, dtype=np.float64)
    h = cosmology.h
    gamma = cosmology.Om0 * h * np.exp(
        -cosmology.Ob0 * (1.0 + np.sqrt(2.0 * h) / cosmology.Om0)
    )
    q = k / (gamma * h)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (
            np.log(1.0 + 2.34 * q) / (2.34 * q)
            * (
                1.0
                + 3.89 * q
                + (16.1 * q) ** 2
                + (5.46 * q) ** 3
                + (6.71 * q) ** 4
            ) ** -0.25
        )
    return np.where(q > 0, t, 1.0)


def bbks_power(cosmology=None, k_h=None):
    """BBKS linear P(k) at z=0, sigma8-normalized; k in h/Mpc."""
    cosmology = create_cosmology(cosmology)
    k_h = np.asarray(k_h, dtype=np.float64)
    p_shape = k_h**cosmology.ns * bbks_transfer(cosmology, k_h * cosmology.h) ** 2
    k_ref = np.logspace(-4.5, 2.5, 4096)
    p_ref = k_ref**cosmology.ns * bbks_transfer(cosmology, k_ref * cosmology.h) ** 2
    s8 = _sigma_r_unnormalized(k_ref, p_ref, r=8.0)
    return p_shape * (cosmology.sigma8 / s8) ** 2


def make_power_table(cosmology=None, kmin=1e-4, kmax=1e3, n=1024):
    """(k, Pk) table spanning [kmin, kmax] h/Mpc, log-spaced (EH98)."""
    k = np.logspace(np.log10(kmin), np.log10(kmax), n)
    return k, eisenstein_hu_power(cosmology, k)


def resolve_power(power, cosmology=None):
    """Resolve a power-spectrum spec to a concrete table.

    ``None`` or ``'default'`` -> the shipped default table; ``'eh98'`` /
    ``'eisenstein_hu'`` or ``'bbks'`` -> the analytic spectrum of
    ``cosmology``; ``'halofit'`` -> the Takahashi nonlinear spectrum of its
    EH98 table (:mod:`.halofit`); anything else is returned untouched for
    :func:`~randomfield_tpu_torch.ops.power.validate_power`.
    """
    from randomfield_tpu_torch.ops.power import load_default_power

    if power is None:
        return load_default_power()
    if isinstance(power, str):
        name = power.lower()
        if name == "default":
            return load_default_power()
        cosmology = create_cosmology(cosmology)
        if name in ("eh98", "eisenstein_hu"):
            return make_power_table(cosmology)
        if name == "bbks":
            k = np.logspace(-4, 3, 1024)
            return k, bbks_power(cosmology, k)
        if name == "halofit":
            # the Takahashi nonlinear spectrum of the cosmology's EH98 table
            from randomfield_tpu_torch.models.halofit import halofit_power

            return halofit_power(make_power_table(cosmology),
                                 cosmology=cosmology)
        raise ValueError(
            f"unknown power model {power!r}: expected 'default', "
            "'eh98'/'eisenstein_hu', 'bbks', 'halofit', or a tabulated "
            "(k, Pk) spectrum"
        )
    return power
