"""Correlated multi-tracer Gaussian fields with exact cross-spectra.

Port of ``randomfield_tpu/models/multitracer.py`` with its names,
arguments and returns.  Two tracers of one volume are rendered with
prescribed auto-spectra P_1, P_2 and cross-spectrum r(k) sqrt(P_1 P_2),
|r| <= 1, by mixing unit noise streams per mode (the 2x2 Cholesky factor):

    u_1 = n_1
    u_2 = r(k) n_1 + sqrt(1 - r(k)^2) n_2

with n_1, n_2 the unit Hermitian draws of two seeds (``generate_noise``:
K2F's unit mode), then each u_i rendered through its own scene's noise path
(``generate_from_noise``: symmetrize, K2's sigma scale, K3, K3, K4).  The
mix is one elementwise float32 expression on the card, as the JAX package
leaves it to XLA; tracer 1 is untouched by it, so it equals
``g1.generate_delta_field(seed)`` bit for bit.  Single-device threefry or
nested scenes (the noise-interchange contract).
"""

from __future__ import annotations

import numpy as np
import torch

from randomfield_tpu_torch.ops import grid as _grid

__all__ = ["MultiTracerGenerator"]

# the tag folded into the second tracer's seed (ASCII "MTRG")
TRACER2_TAG = 0x4D545247


class MultiTracerGenerator:
    """Render correlated tracer pairs with exact P_1, P_2 and r(k).

    ``power1`` / ``power2``: each tracer's target spectrum (any form the
    port's ``validate_power`` accepts, or a model-zoo name);
    ``correlation``: a scalar in [-1, 1] or a tabulated ``(k, r)`` pair,
    interpolated in log10(k).  Engine kwargs (``cosmology=``,
    ``interpolation=``, ``device=``...) pass to both Generators.
    """

    def __init__(self, nx, ny, nz, grid_spacing, power1=None, power2=None,
                 correlation=0.5, cosmology=None, **kwargs):
        from randomfield_tpu_torch.engine.generator import Generator

        self.g1 = Generator(nx, ny, nz, grid_spacing, cosmology=cosmology,
                            power=power1, **kwargs)
        self.g2 = Generator(nx, ny, nz, grid_spacing, cosmology=cosmology,
                            power=power2, **kwargs)
        shape = self.g1.scene.shape
        kmag = _grid.kmag(shape, float(grid_spacing), torch.float32)
        kmag = kmag.numpy().astype(np.float64)
        if np.isscalar(correlation) or np.ndim(correlation) == 0:
            r = float(correlation)
            if not -1.0 <= r <= 1.0:
                raise ValueError(f"correlation {r} outside [-1, 1]")
            rgrid = np.full(kmag.shape, r)
        else:
            from randomfield_tpu_torch.ops.power import validate_power

            k_t, _ = validate_power(
                (np.asarray(correlation[0], np.float64),
                 np.abs(np.asarray(correlation[1], np.float64))))
            r_t = np.asarray(correlation[1], np.float64)
            if np.any(np.abs(r_t) > 1.0):
                raise ValueError("tabulated |r(k)| must be <= 1")
            lk = np.log10(np.maximum(kmag, k_t[0] * 1e-10))
            rgrid = np.interp(lk, np.log10(k_t), r_t)
        rgrid[kmag == 0] = 0.0
        self._r = torch.as_tensor(rgrid.astype(np.float32),
                                  device=self.g1.device)

    @property
    def correlation_grid(self):
        """The per-mode r(k) actually applied (DC forced to 0)."""
        return self._r

    def generate_fields(self, seed=0, smoothing_length=0.0,
                        apply_lightcone=True):
        """One correlated pair ``(delta_1, delta_2)`` for a seed: the
        seed's unit draws for tracer 1, those of ``seed ^ 'MTRG'`` mixed
        in for tracer 2."""
        n1 = self.g1.generate_noise(seed)
        n2 = self.g2.generate_noise((int(seed) ^ TRACER2_TAG) & 0xFFFFFFFF)
        r = self._r[None]
        u2 = r * n1 + torch.sqrt(1.0 - r ** 2) * n2
        del n2
        d1 = self.g1.generate_from_noise(
            n1, smoothing_length=smoothing_length,
            apply_lightcone=apply_lightcone)
        del n1
        d2 = self.g2.generate_from_noise(
            u2, smoothing_length=smoothing_length,
            apply_lightcone=apply_lightcone)
        return d1, d2

    def predicted_cross_power(self, nbins=32, smoothing_length=0.0):
        """Exact per-bin expectation of the measured cross-spectrum: the
        per-mode r(k) sigma_1 sigma_2 equivalent, binned with the
        estimator's own bins (KB 'grid')."""
        from randomfield_tpu_torch.ops import power as _power
        from randomfield_tpu_torch.validate import stats as _stats

        shape = self.g1.scene.shape
        spacing = self.g1.scene.grid_spacing
        kmag = _grid.kmag(shape, spacing, torch.float32, self.g1.device)
        p1 = _power.interpolate_power(self.g1.power, kmag,
                                      self.g1.scene.interpolation)
        p2 = _power.interpolate_power(self.g2.power, kmag,
                                      self.g2.scene.interpolation)
        pc = self._r * torch.sqrt(torch.clamp_min(p1 * p2, 0.0))
        if smoothing_length:
            pc = pc * torch.exp(-((kmag * float(smoothing_length)) ** 2))
        pc = torch.where(kmag > 0, pc, 0.0)
        return _stats.bin_power_grid(pc, shape, spacing, nbins=nbins)
