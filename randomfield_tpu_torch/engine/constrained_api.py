"""Constrained / data-conditioned sampling methods of the Generator.

Port of ``randomfield_tpu/engine/constrained_api.py`` (``ConstrainedMixin``):
Hoffman-Ribak constrained realizations, the conditional mean, Wiener
filtering and posterior sampling; the math lives in
:mod:`..models.constrained`.  Every method reads the scene's per-mode sigma
grid (``Generator.sigmas``), as the JAX package reads ``state.sigmas``, so
the draw's scale, the Gram matrix and the correction share one
sigma_eff^2.  ``sampler='pallas'`` and ``pipeline='staged'`` scenes raise
the reference's ValueError.  On a slab mesh every method runs (the
reference's ``make_sharded_*`` programs, ``allow_mesh=True``): fields in
and out are the rank's x slabs (a whole grid passed in is cut to them),
the sigma grid its ky slab, the numbers the whole grid's on every rank; a
pallas mesh scene refuses all but ``measure_constraints`` with the
reference's ``_mesh_sigmas`` ValueError.
"""

from __future__ import annotations

import numpy as np
import torch

from randomfield_tpu_torch.ops import threefry as _threefry


class ConstrainedMixin:
    """Constraint packing, Hoffman-Ribak renders, Wiener/posterior."""

    def _require_constrainable(self, what, sigmas=True):
        """The reference's check (``allow_mesh=True``): a mesh scene passes,
        but one with ``sampler='pallas'`` refuses the programs that read
        its sigma grid (``sigmas``), as the reference's ``_mesh_sigmas``
        does."""
        if self.mesh is not None:
            if sigmas and self.sampler == "pallas":
                raise ValueError(
                    "mesh scenes with sampler='pallas' support plain renders "
                    "only (the hardware stream is its own realization "
                    "family); build the Generator with sampler='threefry' "
                    "for derived fields, estimators and constrained renders")
            return
        if self.sampler == "pallas" or self.pipeline == "staged":
            raise ValueError(
                f"{what} needs a single-device fused scene with a "
                "materialized sigma grid (sampler='threefry' or 'nested', "
                "pipeline='fused', mesh=None)"
            )

    def _packed_constraints(self, constraints):
        from randomfield_tpu_torch.models import constrained as _con

        return _con.pack_constraints(constraints, self.scene.shape,
                                     self.scene.grid_spacing)

    def constraint_matrix(self, constraints, smoothing_length=0.0):
        """The M x M covariance matrix of the constraint functionals, xi_ij
        = <Gamma_i Gamma_j> under this scene's P(k) (and optional render
        smoothing): host float64."""
        self._require_constrainable("constraint_matrix")
        pos, scales, _ = self._packed_constraints(constraints)
        gram = self._constraint_gram_cached(pos, scales,
                                            float(smoothing_length))
        return gram.cpu().numpy().astype(np.float64)

    def generate_constrained_field(self, seed, constraints,
                                   smoothing_length=0.0,
                                   apply_lightcone=False):
        """Hoffman-Ribak constrained realization of this scene (snapshot).

        Each constraint pins the Gaussian-smoothed field value at a comoving
        position EXACTLY per realization while the rest of the field keeps
        the conditional ensemble statistics: ``constraints`` is an iterable
        of ``(position, value, scale)`` tuples or dicts
        (:func:`..models.constrained.pack_constraints`).  On CUDA: K2F (KN
        for a nested scene), KC MEASURE, the solve, KC CORRECT, K3 x2, K4.
        """
        from randomfield_tpu_torch.models import constrained as _con

        self._require_constrainable("generate_constrained_field")
        pos, scales, values = self._packed_constraints(constraints)
        gram = self._constraint_gram_cached(pos, scales,
                                            float(smoothing_length))
        return _con.constrained_render(
            _threefry.as_key(seed), self.sigmas,
            self._weights(apply_lightcone), gram, pos, scales, values,
            smoothing_length, self.scene.shape, self.scene.grid_spacing,
            nested=self.sampler == "nested", mesh=self.mesh,
        )

    def constrained_mean_field(self, constraints, smoothing_length=0.0,
                               apply_lightcone=False):
        """The conditional MEAN field given the constraints (no seed): the
        ensemble average of :meth:`generate_constrained_field`."""
        from randomfield_tpu_torch.models import constrained as _con

        self._require_constrainable("constrained_mean_field")
        pos, scales, values = self._packed_constraints(constraints)
        gram = self._constraint_gram_cached(pos, scales,
                                            float(smoothing_length))
        return _con.constrained_mean(
            self.sigmas, self._weights(apply_lightcone), gram, pos, scales,
            values, smoothing_length, self.scene.shape,
            self.scene.grid_spacing, mesh=self.mesh,
        )

    def _constraint_gram_cached(self, pos, scales, smoothing_length):
        """Gram matrices are seed-independent: cached per constraint set."""
        from randomfield_tpu_torch.models import constrained as _con

        key = (
            np.asarray(pos, np.float64).tobytes(),
            np.asarray(scales, np.float64).tobytes(),
            float(smoothing_length),
        )
        cache = getattr(self, "_gram_cache", None)
        if cache is None:
            cache = self._gram_cache = {}
        if key not in cache:
            cache[key] = _con.constraint_gram(
                self.sigmas, pos, scales, smoothing_length,
                self.scene.shape, self.scene.grid_spacing, mesh=self.mesh,
            )
        return cache[key]

    def _rank_field(self, field):
        """A field as a float32 tensor on the scene's device: on a mesh the
        rank's x slab (a whole grid is cut to it)."""
        if isinstance(field, np.ndarray):
            field = np.array(field, np.float32)
        field = torch.as_tensor(field, dtype=torch.float32,
                                device=self.device)
        nx = self.scene.shape[0]
        if self.mesh is not None and self.mesh.size > 1 and (
                field.shape[0] == nx):
            x0, nx_loc = self.mesh.rows(nx)
            field = field[x0:x0 + nx_loc]
        return field

    def measure_constraints(self, delta, constraints):
        """Evaluate constraint functionals on a rendered field (host
        float64): the forward transform and KC MEASURE, independent of the
        constrained render's own measurement."""
        from randomfield_tpu_torch.models import constrained as _con

        self._require_constrainable("measure_constraints", sigmas=False)
        pos, scales, _ = self._packed_constraints(constraints)
        out = _con.measure_constraints(self._rank_field(delta), pos, scales,
                                       self.scene.shape,
                                       self.scene.grid_spacing, self.mesh)
        return out.cpu().numpy()

    def wiener_filter(self, data, noise_power):
        """Minimum-variance reconstruction of a noisy observation of one
        realization: per-mode filter sigma^2 / (sigma^2 + P_n/V).
        ``noise_power``: physical noise power ((Mpc/h)^3) — scalar white
        noise (per-voxel std s <=> s^2 spacing^3) or a (k, P_n) table."""
        from randomfield_tpu_torch.models import constrained as _con

        self._require_constrainable("wiener_filter")
        return _con.wiener_filter(self._rank_field(data), self.sigmas,
                                  noise_power, self.scene.shape,
                                  self.scene.grid_spacing, self.mesh)

    def generate_posterior_field(self, seed, data, noise_power):
        """One exact sample of P(field | data) for full-grid noisy data:
        ``delta_r + WF(data - delta_r - n_r)``; the mean over seeds is
        :meth:`wiener_filter`'s reconstruction."""
        from randomfield_tpu_torch.models import constrained as _con

        self._require_constrainable("generate_posterior_field")
        return _con.posterior_render(
            _threefry.as_key(seed), self._rank_field(data), self.sigmas,
            noise_power, self.scene.shape, self.scene.grid_spacing,
            self.mesh,
        )

    def predicted_posterior_mse(self, noise_power):
        """Exact expected mean-square error of :meth:`wiener_filter`."""
        from randomfield_tpu_torch.models import constrained as _con

        self._require_constrainable("predicted_posterior_mse")
        return _con.predicted_posterior_mse(
            self.sigmas, noise_power, self.scene.shape,
            self.scene.grid_spacing, mesh=self.mesh,
        )
