"""Background cosmology — no astropy dependency.

The scene-setup part of ``randomfield_tpu/models/cosmology.py``, copied
(host float64 numpy, no JAX): the port needs it without importing the JAX
package, whose ``__init__`` imports jax.  Keep the two in step; the
port's tests hold the plane redshifts and growth weights to the JAX
package's exactly.  Distances, growth, the growth rate (for the velocity
and Kaiser fields) and the presets only; transverse distances and
densities come with the models that use them.

Reference parity: ``randomfield/cosmotools.py`` (``create_cosmology``,
``get_redshifts``, ``get_growth_function``).  The reference leans on
astropy's ``FlatLambdaCDM`` (default Planck13) plus scipy quadrature; here
the two integrals it needs — comoving distance and the linear growth
factor — are ~100 lines of float64 numpy evaluated once at scene-setup
time (they are O(table), not O(N^3), so they stay on host in f64 and ship
to the device as f32 constants).  Beyond the reference's flat-LCDM
surface, curvature (``Ok0``) and CPL dark energy (``w0``/``wa``) are
supported: distances pick up the extra density terms and the growth
factor switches from the flat-LCDM closed form to an RK4 integration of
the growth ODE (identical results on flat LCDM, asserted in tests).

Simplification vs astropy: neutrinos are treated as massless (energy
density scaled by Neff); astropy's Planck13 includes one 0.06 eV species.
This shifts distances/growth at the <0.5% level and is self-consistent
between the engine and the float64 oracle, which is what the statistical
fidelity gate checks (SURVEY.md section 3.5).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

__all__ = [
    "Cosmology",
    "Planck13",
    "Planck15",
    "Planck18",
    "create_cosmology",
    "get_redshifts",
    "get_growth_function",
]

C_KM_S = 299792.458  # speed of light [km/s]


@dataclasses.dataclass(frozen=True)
class Cosmology:
    """Flat Lambda-CDM parameters (hashable; safe to embed in a frozen Scene).

    Parameters mirror astropy's ``FlatLambdaCDM`` plus the primordial tilt
    and normalization needed by the power-spectrum model.
    """

    H0: float = 67.77  # [km/s/Mpc]
    Om0: float = 0.30712  # total matter today
    Ob0: float = 0.048252  # baryons today
    Tcmb0: float = 2.7255  # [K]
    Neff: float = 3.046  # effective massless neutrino species
    ns: float = 0.9611  # scalar spectral index
    sigma8: float = 0.8288  # linear rms in 8 Mpc/h spheres at z=0
    Ok0: float = 0.0  # curvature today (0 = flat)
    w0: float = -1.0  # dark-energy equation of state today (CPL)
    wa: float = 0.0  # CPL evolution: w(a) = w0 + wa (1 - a)
    name: str = "Planck13"

    # ---- derived densities -------------------------------------------------
    @property
    def h(self) -> float:
        return self.H0 / 100.0

    @property
    def Ogamma0(self) -> float:
        # Omega_gamma h^2 = 2.47282e-5 at Tcmb = 2.7255 K, scaling as T^4.
        return 2.47282e-5 * (self.Tcmb0 / 2.7255) ** 4 / self.h**2

    @property
    def Onu0(self) -> float:
        # massless neutrinos: (7/8) (4/11)^(4/3) per species
        return self.Neff * 0.2271073 * self.Ogamma0

    @property
    def Or0(self) -> float:
        return self.Ogamma0 + self.Onu0

    @property
    def Ode0(self) -> float:
        return 1.0 - self.Om0 - self.Or0 - self.Ok0

    @property
    def hubble_distance(self) -> float:
        """c / H0 [Mpc]."""
        return C_KM_S / self.H0

    @property
    def critical_density0(self) -> float:
        """Critical density today, Msun / Mpc^3 (= 2.775e11 h^2)."""
        return 2.77536627e11 * self.h**2

    @property
    def _is_flat_lcdm(self) -> bool:
        """True for the flat cosmological-constant sector (closed-form
        growth applies; the general w0waCDM+curvature path uses the ODE)."""
        return self.Ok0 == 0.0 and self.w0 == -1.0 and self.wa == 0.0

    def _de_density(self, a):
        """rho_DE(a)/rho_DE0 for CPL w(a) = w0 + wa (1 - a).

        a^{-3 (1 + w0 + wa)} exp(-3 wa (1 - a)); == 1 for a cosmological
        constant.
        """
        a = np.asarray(a, dtype=np.float64)
        if self.w0 == -1.0 and self.wa == 0.0:
            return np.ones_like(a)
        return a ** (-3.0 * (1.0 + self.w0 + self.wa)) * np.exp(
            -3.0 * self.wa * (1.0 - a)
        )

    # ---- background --------------------------------------------------------
    def efunc(self, z):
        """E(z) = H(z)/H0 with radiation, matter, curvature and CPL DE."""
        zp1 = 1.0 + np.asarray(z, dtype=np.float64)
        return np.sqrt(
            self.Or0 * zp1**4
            + self.Om0 * zp1**3
            + self.Ok0 * zp1**2
            + self.Ode0 * self._de_density(1.0 / zp1)
        )

    def _efunc_matter_lambda(self, a):
        """E(a) excluding radiation (the sector that drives growth).

        The closed-form growth integral below is exact for flat
        matter+Lambda; the general case adds curvature and CPL dark
        energy and goes through the growth ODE instead.  Radiation is
        excluded by convention in both (documented above).
        """
        a = np.asarray(a, dtype=np.float64)
        # radiation is dropped from the budget too (Ode = 1 - Om - Ok
        # here, not 1 - Om - Or - Ok), matching the round-1 flat-LCDM
        # convention bit-for-bit and keeping the growth sector closed
        return np.sqrt(
            self.Om0 / a**3
            + self.Ok0 / a**2
            + (1.0 - self.Om0 - self.Ok0) * self._de_density(a)
        )

    @functools.cached_property
    def _distance_table(self):
        """Dense (z, Dc[Mpc]) table for interpolation, z in [0, 100]."""
        z = np.concatenate(
            [np.linspace(0.0, 20.0, 40001), np.linspace(20.0, 100.0, 8001)[1:]]
        )
        integrand = 1.0 / self.efunc(z)
        dc = np.zeros_like(z)
        dz = np.diff(z)
        dc[1:] = np.cumsum(0.5 * dz * (integrand[1:] + integrand[:-1]))
        return z, self.hubble_distance * dc

    def comoving_distance(self, z):
        """Line-of-sight comoving distance [Mpc] (flat: also transverse)."""
        zt, dt = self._distance_table
        return np.interp(np.asarray(z, dtype=np.float64), zt, dt)

    def redshift_at_comoving_distance(self, dc_mpc):
        """Inverse of :meth:`comoving_distance` by monotone interpolation."""
        zt, dt = self._distance_table
        dc = np.asarray(dc_mpc, dtype=np.float64)
        if np.any(dc > dt[-1]):
            raise ValueError(
                f"comoving distance {float(np.max(dc)):.1f} Mpc beyond tabulated "
                f"z <= {zt[-1]:.0f} (box too deep for the distance table)"
            )
        return np.interp(dc, dt, zt)

    def growth_function(self, z):
        """Linear growth factor D(z), normalized so D(0) = 1.

        Flat LCDM: D(a) proportional to
        E(a) * integral_0^a da' / (a' E(a'))^3 — the exact
        matter+Lambda solution (ref: cosmotools.get_growth_function,
        SURVEY.md section 3.4), evaluated by trapezoid on a log-a grid.
        With curvature or CPL dark energy that closed form does not
        hold; the growth ODE is integrated instead (:meth:`_growth_ode`).
        """
        z = np.asarray(z, dtype=np.float64)
        a_eval = 1.0 / (1.0 + z)
        lna, d_unnorm = self._growth_table
        d_of_a = lambda aq: np.interp(np.log(aq), lna, d_unnorm)
        return d_of_a(a_eval) / d_of_a(1.0)

    def growth_rate(self, z):
        """Logarithmic growth rate f = dlnD/dlna (central difference).

        In matter domination f -> 1; at z = 0 for Planck-like parameters
        f ~ Om(z)^0.55 ~ 0.52.
        """
        z = np.asarray(z, dtype=np.float64)
        a = 1.0 / (1.0 + z)
        eps = 1e-4
        d_hi = self.growth_function(1.0 / (a * np.exp(eps)) - 1.0)
        d_lo = self.growth_function(1.0 / (a * np.exp(-eps)) - 1.0)
        return (np.log(d_hi) - np.log(d_lo)) / (2 * eps)

    @functools.cached_property
    def _growth_table(self):
        """(ln a grid, unnormalized D) — closed form or ODE per model."""
        # fixed fine log-a grid; extends past a = 1 so growth-rate
        # finite differences at z = 0 stay two-sided
        lna = np.linspace(np.log(1e-8), 0.25, 20001)
        a = np.exp(lna)
        if self._is_flat_lcdm:
            f = 1.0 / (a * self._efunc_matter_lambda(a)) ** 3 * a  # dlna
            cum = np.zeros_like(a)
            dl = np.diff(lna)
            cum[1:] = np.cumsum(0.5 * dl * (f[1:] + f[:-1]))
            return lna, self._efunc_matter_lambda(a) * cum
        return lna, self._growth_ode(lna)

    def _growth_ode(self, lna):
        """Integrate D'' + (2 + dlnE/dx) D' = (3/2) Om(a) D in x = ln a.

        RK4 from deep matter domination (D proportional to a there — the
        curvature/DE terms are negligible at a = 1e-8 for any sane
        parameters), on the same log-a grid the closed form uses.
        Om(a) = Om0 a^-3 / E(a)^2 with the radiation-free E of
        :meth:`_efunc_matter_lambda`.  Matches the closed form to ~1e-5
        when evaluated on flat LCDM (asserted in tests).
        """
        ok0 = self.Ok0
        om0 = self.Om0
        ode0 = 1.0 - om0 - ok0

        def rhs(x, y):
            a = np.exp(x)
            fde = self._de_density(a)
            e2 = om0 / a**3 + ok0 / a**2 + ode0 * fde
            # dlnE/dx = dE^2/dx / (2 E^2)
            dfde = fde * (-3.0 * (1.0 + self.w0 + self.wa)
                          + 3.0 * self.wa * a)
            de2 = -3.0 * om0 / a**3 - 2.0 * ok0 / a**2 + ode0 * dfde
            dlne = 0.5 * de2 / e2
            om_a = om0 / a**3 / e2
            d, dp = y
            return np.array([dp, 1.5 * om_a * d - (2.0 + dlne) * dp])

        out = np.empty_like(lna)
        a0 = np.exp(lna[0])
        y = np.array([a0, a0])  # D ~ a, dD/dx ~ a in matter domination
        out[0] = y[0]
        for i in range(1, lna.size):
            x, h = lna[i - 1], lna[i] - lna[i - 1]
            k1 = rhs(x, y)
            k2 = rhs(x + 0.5 * h, y + 0.5 * h * k1)
            k3 = rhs(x + 0.5 * h, y + 0.5 * h * k2)
            k4 = rhs(x + h, y + h * k3)
            y = y + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
            out[i] = y[0]
        return out

Planck13 = Cosmology()
Planck15 = Cosmology(
    H0=67.74, Om0=0.3089, Ob0=0.0486, ns=0.9667, sigma8=0.8159, name="Planck15"
)
Planck18 = Cosmology(
    H0=67.66, Om0=0.30966, Ob0=0.04897, ns=0.9665, sigma8=0.8102, name="Planck18"
)

_NAMED = {"planck13": Planck13, "planck15": Planck15, "planck18": Planck18}


def create_cosmology(name_or_cosmology="Planck13") -> Cosmology:
    """Cosmology factory (ref: cosmotools.create_cosmology).

    Accepts a :class:`Cosmology`, a preset name, or None (default Planck13).
    """
    if name_or_cosmology is None:
        return Planck13
    if isinstance(name_or_cosmology, Cosmology):
        return name_or_cosmology
    if isinstance(name_or_cosmology, dict):
        # parameter overrides on the default, e.g.
        # {"H0": 70, "Om0": 0.3, "w0": -0.9, "Ok0": 0.01}
        return Cosmology(**{"name": "custom", **name_or_cosmology})
    try:
        return _NAMED[str(name_or_cosmology).lower()]
    except KeyError:
        raise ValueError(
            f"unknown cosmology {name_or_cosmology!r}; expected one of "
            f"{sorted(_NAMED)}, a Cosmology instance, or a dict of "
            "parameter overrides"
        ) from None


def get_redshifts(cosmology, nz, spacing, scaled_by_h=True, z0=0.0):
    """Redshift of each grid plane along the line of sight.

    Plane ``i`` sits at comoving distance ``offset + i * spacing`` from the
    observer, where ``offset = comoving_distance(z0)``; its redshift comes
    from inverting the comoving-distance relation (ref:
    cosmotools.get_redshifts).  ``spacing`` is in Mpc/h when
    ``scaled_by_h`` (the reference's convention), else Mpc.
    """
    cosmology = create_cosmology(cosmology)
    d = np.arange(nz, dtype=np.float64) * spacing
    if scaled_by_h:
        d = d / cosmology.h
    d = d + cosmology.comoving_distance(z0)
    return cosmology.redshift_at_comoving_distance(d)


def get_growth_function(cosmology, redshifts):
    """D(z)/D(0) at the given redshifts (ref: cosmotools.get_growth_function)."""
    cosmology = create_cosmology(cosmology)
    return cosmology.growth_function(np.asarray(redshifts, dtype=np.float64))
