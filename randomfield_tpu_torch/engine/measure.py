"""Measurement and exact-prediction methods of the Generator (a mixin).

Port of ``randomfield_tpu/engine/measure.py``'s ``MeasurementMixin``: thin
delegations to the estimators of :mod:`..validate` and
:mod:`..models.nongaussian` with the scene's spacing, table,
interpolation and device, so the Generator stays the one user-facing
object.  The predictions build their per-mode grids on the scene's device:
the Kaiser expectation (b + f mu^2)^2 P(k) (:meth:`_kaiser_pgrid`) binned
with the estimator's multipole or wedge bins, its Gaussian covariance, a
derived field's expected spectrum and the local-f_NL bispectrum.  The
mixin's Minkowski, peak, profile, void and kNN methods belong to estimator
modules that are not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

import torch

from randomfield_tpu_torch.ops import derived as _derived
from randomfield_tpu_torch.ops import grid as _grid
from randomfield_tpu_torch.ops import power as _power
from randomfield_tpu_torch.validate import stats as _stats

__all__ = ["MeasurementMixin"]

_ITEM9 = ("are not ported to randomfield_tpu_torch yet: {} comes with the "
          "other estimators (ROADMAP.md, Queue 1 item 9)")


def _item9(method, module):
    def refuse(self, *args, **kwargs):
        raise NotImplementedError(f"Generator.{method} and its estimators "
                                  + _ITEM9.format(module))
    refuse.__name__ = method
    refuse.__doc__ = (f"Not ported yet (``{module}``, ROADMAP.md Queue 1 "
                      f"item 9): raises NotImplementedError.")
    return refuse


class MeasurementMixin:
    """calculate_* / predicted_* statistics of rendered fields."""

    def calculate_power(self, delta, nbins=32):
        """Realized binned P(k) of a rendered field: host float64
        ``(k_mean, p_hat, n_modes)`` (:func:`..validate.stats.calculate_power`;
        on a mesh ``delta`` is this rank's x slab, and every rank gets the
        whole field's result)."""
        return _stats.calculate_power(delta, self.grid_spacing, nbins,
                                      mesh=self.mesh)

    def calculate_bispectrum(self, delta, nbins=8, kmin=None, kmax=None):
        """Binned bispectrum of a rendered field (the third-order gate): 0
        in expectation for the Gaussian fields this Generator renders
        (:func:`..validate.bispectrum.calculate_bispectrum`)."""
        from randomfield_tpu_torch.validate import bispectrum

        return bispectrum.calculate_bispectrum(
            delta, self.grid_spacing, nbins, kmin=kmin, kmax=kmax,
            mesh=self.mesh)

    def predicted_ng_bispectrum(self, fnl, kind="field", smoothing_length=0.0,
                                nbins=8, kmin=None, kmax=None):
        """The exact binned tree-level bispectrum of a local-f_NL render,
        with the bins and triads of :meth:`calculate_bispectrum`; returns
        ``(k_centers, triples, B_pred, ntri)``."""
        from randomfield_tpu_torch.models import nongaussian as _ng

        return _ng.predicted_ng_bispectrum(
            self.power, self.shape, self.grid_spacing, fnl, kind=kind,
            cosmology=self.cosmology, smoothing_length=smoothing_length,
            nbins=nbins, kmin=kmin, kmax=kmax,
            interpolation=self.scene.interpolation, device=self.device)

    def _kaiser_bf(self, z, bias, f):
        b = float(bias)
        if b == 0.0:
            raise ValueError("bias must be nonzero for a Kaiser field")
        if f is None:
            f = self.cosmology.growth_rate(float(z))
        return b, float(f)

    def _table_pgrid(self, smoothing_length):
        """(|k|, P(|k|) with the render's interpolation and smoothing, 0 at
        DC), float32 on the scene's device."""
        return _power.grid_power(self.power, self.shape, self.grid_spacing,
                                 self.scene.interpolation, self.device,
                                 smoothing_length)

    def _kaiser_pgrid(self, z, bias, f, los_axis, smoothing_length):
        """The per-mode (b + f mu^2)^2 P(k) expectation half-grid, with the
        render's interpolation and smoothing."""
        b, fv = self._kaiser_bf(z, bias, f)
        kmag, pgrid = self._table_pgrid(smoothing_length)
        k_los = _grid.kvectors(self.shape, self.grid_spacing, torch.float32,
                               self.device)[int(los_axis)]
        bcast = [1, 1, 1]
        bcast[int(los_axis)] = -1
        k2 = kmag * kmag
        inv = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)
        mu2 = (k_los * k_los).reshape(bcast) * inv
        g = b + fv * mu2
        return pgrid * (g * g)

    def predicted_kaiser_multipoles(self, z=0.0, bias=1.0, f=None, los_axis=2,
                                    nbins=32, ells=(0, 2, 4),
                                    smoothing_length=0.0):
        """The exact per-bin expectation of a Kaiser render's P_ell(k): the
        per-mode (b + f mu^2)^2 P(k) binned with the Legendre weights,
        bins and masks of ``calculate_power_multipoles``.  Returns
        ``(k_mean, p_ell, n_modes)``."""
        pgrid = self._kaiser_pgrid(z, bias, f, los_axis, smoothing_length)
        return _stats.bin_power_multipoles_grid(
            pgrid, self.shape, self.grid_spacing, nbins=nbins, ells=ells,
            los_axis=int(los_axis))

    def predicted_kaiser_multipole_covariance(self, z=0.0, bias=1.0, f=None,
                                              los_axis=2, nbins=32,
                                              ells=(0, 2, 4),
                                              smoothing_length=0.0):
        """The exact Gaussian (nbins, nells, nells) within-bin covariance of
        a Kaiser render's P_ell estimates
        (:func:`..validate.ensemble.predicted_multipole_covariance` of
        :meth:`_kaiser_pgrid`)."""
        from randomfield_tpu_torch.validate import ensemble as _ensemble

        pgrid = self._kaiser_pgrid(z, bias, f, los_axis, smoothing_length)
        return _ensemble.predicted_multipole_covariance(
            pgrid, self.shape, self.grid_spacing, nbins=nbins, ells=ells,
            los_axis=int(los_axis))

    def predicted_kaiser_wedges(self, z=0.0, bias=1.0, f=None, los_axis=2,
                                nbins=32, nmu=4, smoothing_length=0.0):
        """The exact per-bin expectation of a Kaiser render's P(k, mu)
        wedges, binned as ``calculate_power_wedges`` bins.  Returns
        ``(k_mean, p, n_modes)`` shaped ``(nbins, nmu)``."""
        pgrid = self._kaiser_pgrid(z, bias, f, los_axis, smoothing_length)
        return _stats.bin_power_wedges_grid(
            pgrid, self.shape, self.grid_spacing, nbins=nbins, nmu=nmu,
            los_axis=int(los_axis))

    def predicted_derived_power(self, kind="delta", component=2, z=0.0,
                                nbins=32, smoothing_length=0.0):
        """The exact per-bin expectation of a derived field's auto-spectrum:
        'delta' (P on the grid's modes), 'potential' (pref^2 / k^4 P, the
        Poisson prefactor of ``generate_potential``), 'displacement' (k_i^2
        / k^4 P for ``component`` i, Nyquist-zeroed gradient vectors) or
        'velocity' (that times (a H f / h)^2), binned with the estimator's
        bins.  Returns ``(k_mean, p, n_modes)``."""
        kinds = ("delta", "potential", "displacement", "velocity")
        if kind not in kinds:
            raise ValueError(f"kind must be one of {kinds}, got {kind!r}")
        kmag, pgrid = self._table_pgrid(smoothing_length)
        if kind != "delta":
            k2 = kmag * kmag
            inv = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)
            if kind == "potential":
                t = _derived.potential_prefactor(self.cosmology, z) * inv
            else:
                kvec = _derived.grad_kvectors(self.shape, self.grid_spacing,
                                              torch.float32,
                                              self.device)[int(component)]
                bcast = [1, 1, 1]
                bcast[int(component)] = -1
                pref = (1.0 if kind == "displacement"
                        else _derived.velocity_prefactor(self.cosmology, z))
                t = pref * kvec.reshape(bcast) * inv
            pgrid = pgrid * (t * t)
        return _stats.bin_power_grid(pgrid, self.shape, self.grid_spacing,
                                     nbins=nbins)

    calculate_minkowski = _item9("calculate_minkowski", "validate/minkowski.py")
    predicted_minkowski = _item9("predicted_minkowski", "validate/minkowski.py")
    calculate_peaks = _item9("calculate_peaks", "validate/peaks.py")
    predicted_peaks = _item9("predicted_peaks", "validate/peaks.py")
    calculate_stacked_profile = _item9("calculate_stacked_profile",
                                       "validate/profiles.py")
    calculate_peak_profile = _item9("calculate_peak_profile", "validate/profiles.py")
    predicted_peak_profile = _item9("predicted_peak_profile", "validate/profiles.py")
    find_voids = _item9("find_voids", "models/voids.py")
    calculate_knn_cdf = _item9("calculate_knn_cdf", "validate/knn.py")
