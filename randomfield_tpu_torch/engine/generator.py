"""The Generator scene/state API — render seeded Gaussian random fields.

Port of the core of ``randomfield_tpu/engine/generator.py``.  The
constructor does the scene setup once (power table, uniform sigma(k)
table, lightcone weights); each ``generate_delta_field(seed)`` then runs,
on the scene's device, one of three samplers:

* ``sampler='threefry'`` (default): K2 fused with its draws
  (:func:`.ops.sampler.draw_scale`), one pass: the canonical Threefry unit
  draws (:mod:`.ops.sample`), bit for bit the JAX package's stream at the
  same seed, with the kz = 0 and Nyquist planes made Hermitian, times
  sigma(|k|) * exp(-k^2 s^2 / 2) / sqrt(2), the last factor the draws'
  complex normalization;
* ``sampler='pallas'``: K1 draws and scales every mode in one pass from
  its own counter-based stream (:func:`.ops.sampler.sample_modes`,
  :mod:`.ops.modestream`), the two planes made Hermitian in the same pass.
  On one device this is the staged render (:func:`.staged.render_v3`), whose
  ``RF_STAGED_PIPELINE=v4`` and ``=v6`` variants run the transforms below
  through K9, or draw through K10 (a realization family of its own);
* ``sampler='nested'``: KN, a hand kernel on the resolution-nested stream
  (:func:`.ops.sampler.sample_nested`): each mode drawn from its signed
  lattice indices, so grids of different size over one box share their
  common modes (zoom matching), with K2's amplitude; the JAX package's
  nested stream bit for bit;

and then, for all three:

1. K3, in place: inverse FFT along x, then along y (:func:`.ops.fft.ifft_axis`);
2. K4: c2r along kz times the plane weights D(z)/D(0), which writes the
   field (:func:`.ops.fft.c2r_tail`).

``generate_fixed_field(seed)`` renders the fixed field (|c_k| pinned to
sigma(k), the seed's phases; ``flip=True`` the paired one) through K2F's
fixed mode (KN's for a nested scene).  The derived fields
(``generate_potential``, ``generate_displacement``, ``generate_velocity``,
``generate_tidal_field``, ``classify_web``, ``generate_kaiser_field``) draw
the seed's spectrum (K2F, K1 or KN), apply KD
(:func:`.ops.derived.apply_kernel`) and run K3, K3 and K4 with unit
weights: no forward transform (2LPT adds the field-first second order).

``sample_power(seed)`` bins the realized power of a seed's spectrum with no
FFT: for ``sampler='pallas'`` through K5, which regenerates K1's draws and
writes no spectrum (:func:`.ops.sampler.sample_power_bins_batch`);
``sample_power_batch(seeds)``, the config-4 covariance-ensemble path, runs
it for every seed into one device block and moves the block to the host
once; ``calculate_power(delta)`` is the FFT estimator.

On CUDA the spectrum is two float32 lattices updated in place up to K4;
a render's peak is those two lattices and the field.  On the CPU every
step runs its plain PyTorch version.  ``generate_noise`` is the fused
kernel's unit mode; ``generate_from_noise`` runs the Hermitian fix and K2
(:func:`.ops.sampler.scale_sigma`) on the caller's draws.

With ``mesh`` (a :class:`..parallel.mesh.SlabMesh`) every rank builds the
same Generator and calls the same methods; each rank draws its ky slab of
the spectrum (K7, K8 or KN on the shard in place of the fused K2, K1 or
KN; K2F's or KN's fixed mode on the shard for the fixed fields; KD at the
shard's ky offset for the derived fields), and the distributed inverse
(:mod:`..parallel.dfft`) returns its x slab of the field, equal to the
same rows of the single-device render (:mod:`..parallel.render`).
``sigmas`` is the rank's ky slab of the grid; ``generate_noise`` returns
the whole grid's draws on every rank, as the JAX package returns its
global array; ``generate_from_noise`` refuses a mesh, as there.
"""

from __future__ import annotations

import numpy as np
import torch

from randomfield_tpu_torch.engine import scene as _scene
from randomfield_tpu_torch.engine import staged as _staged
from randomfield_tpu_torch.engine.constrained_api import ConstrainedMixin
from randomfield_tpu_torch.engine.measure import MeasurementMixin
from randomfield_tpu_torch.models import cosmology as _cosmo
from randomfield_tpu_torch.models import web as _web
from randomfield_tpu_torch.models.powerspec import resolve_power
from randomfield_tpu_torch.ops import derived as _derived
from randomfield_tpu_torch.ops import fft as _fft
from randomfield_tpu_torch.ops import grid as _grid
from randomfield_tpu_torch.ops import power as _power
from randomfield_tpu_torch.ops import sample as _sample
from randomfield_tpu_torch.ops import sampler as _sampler
from randomfield_tpu_torch.parallel import dfft as _dfft
from randomfield_tpu_torch.parallel import mesh as _mesh
from randomfield_tpu_torch.parallel import render as _render
from randomfield_tpu_torch.validate import stats as _stats

__all__ = ["Generator"]

class Generator(MeasurementMixin, ConstrainedMixin):
    """Generate 3-D Gaussian random density fields with a given P(k).

    The measurement and prediction methods (``calculate_power``,
    ``calculate_bispectrum``, ``predicted_kaiser_multipoles``...) come from
    :class:`.measure.MeasurementMixin`; the constrained, Wiener and
    posterior methods from :class:`.constrained_api.ConstrainedMixin`.

    Parameters follow ``randomfield_tpu.Generator``:

    nx, ny, nz : grid dimensions; the z axis is the line of sight.
    grid_spacing : comoving grid spacing in Mpc/h.
    cosmology : a :class:`~randomfield_tpu_torch.models.cosmology.Cosmology`,
        a preset name ('Planck13'...), a dict of overrides, or None.
    power : tabulated P(k) — (k, Pk) in h/Mpc, (Mpc/h)^3 — a model name
        ('default', 'eh98', 'bbks'), or None for the default table.
    interpolation : 'log10k' (P linear in log10 k) or 'loglog'.
    z0 : redshift of the nearest lightcone plane.
    sampler : 'threefry' (the JAX package's stream, bit for bit), 'pallas'
        (the fused sampler K1: its own counter-based stream,
        :mod:`~randomfield_tpu_torch.ops.modestream`) or 'nested' (the
        resolution-nested stream, the JAX package's bit for bit; every axis
        at most 1024, not with ``pipeline='staged'``).
    mesh : None for one device, or this rank's slab mesh
        (:func:`randomfield_tpu_torch.parallel.mesh.make_mesh`): nx and ny
        must divide by its size; renders return the rank's (nx/P, ny, nz)
        x slab.  A pencil mesh raises NotImplementedError.  As in the JAX
        package, a mesh scene with ``sampler='pallas'`` renders plain
        fields only.
    pipeline : 'auto', 'fused' or 'staged'.  ``sampler='pallas'`` ignores it,
        as the JAX package does (its single-device render is always the
        staged one).  With ``sampler='threefry'``, 'staged' renders through
        :func:`.staged.render_v3_threefry`, the same field as 'auto' (one
        canonical stream); with a mesh 'staged' raises ValueError (the
        sharded render is a pipeline of its own).
    device : where renders run: the mesh's device with a mesh, else "cuda"
        by default.  On CUDA every axis the kernels transform must be a
        power of two: nx, ny and nz/2 in [16, 2048]; other shapes raise
        ValueError here.
    """

    def __init__(self, nx, ny, nz, grid_spacing, cosmology=None, power=None,
                 interpolation="log10k", z0=0.0, mesh=None, pipeline="auto",
                 sampler="threefry", device=None):
        if sampler not in ("threefry", "pallas", "nested"):
            raise ValueError(f"unknown sampler {sampler!r}")
        if pipeline not in ("auto", "fused", "staged"):
            raise ValueError(f"unknown pipeline {pipeline!r}")
        if pipeline == "staged" and mesh is not None:
            raise ValueError(
                "pipeline='staged' is incompatible with mesh mode (the "
                "sharded render is its own pipeline); use pipeline='auto' "
                "or 'fused'")
        shape = (int(nx), int(ny), int(nz))
        if sampler == "nested":
            if pipeline == "staged":
                raise ValueError(
                    "sampler='nested' needs the fused pipeline (the staged "
                    "pipeline draws in a different, positional order); use "
                    "pipeline='auto' or 'fused'")
            if max(shape) > _sample.NESTED_MAX_DIM:
                raise ValueError(
                    f"sampler='nested' packs signed mode indices into 10 "
                    f"bits per axis (max dim {_sample.NESTED_MAX_DIM}); got "
                    f"{shape}")
        if mesh is not None:
            mesh = _mesh.require_slab(mesh)
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's device "
                                 f"{mesh.device}")
            device = mesh.device
            _mesh.check_divisible(shape, mesh.size)
        self.mesh = mesh
        self.sampler = sampler
        self.pipeline = pipeline
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda":
            _check_kernel_shape(shape)
        self.cosmology = _cosmo.create_cosmology(cosmology)
        self.scene = _scene.Scene(
            nx=shape[0], ny=shape[1], nz=shape[2],
            grid_spacing=float(grid_spacing), cosmology=self.cosmology,
            interpolation=interpolation, z0=float(z0),
        )
        self.state, self._aux = _scene.build_state(
            self.scene, resolve_power(power, self.cosmology), self.device,
            box_table=sampler == "nested",
        )
        self._bin_plans = {}  # K5's bins by nbins
        self._sigmas = None  # the per-mode sigma grid, built on first read

    # ---- introspection ------------------------------------------------------
    @property
    def shape(self):
        return self.scene.shape

    @property
    def grid_spacing(self):
        return self.scene.grid_spacing

    @property
    def power(self):
        """The validated power table in use."""
        return self.state.power

    @property
    def redshifts(self):
        """Redshift of each z plane (host float64)."""
        return self._aux["redshifts"]

    @property
    def growth_function(self):
        """D(z)/D(0) of each z plane (host float64)."""
        return self._aux["growth"]

    @property
    def k_min(self):
        return self.scene.k_bounds[0]

    @property
    def k_max(self):
        return self.scene.k_bounds[1]

    @property
    def sigmas(self):
        """The per-mode sigma(k) grid, float32 (nx, ny, nz//2+1) on the
        scene's device (on a mesh, this rank's (nx, ny/P, nz//2+1) ky slab
        of it): ``ops.power.tabulate_sigmas`` of the scene's power table
        (its own interpolant, evaluated in float64), built on the first
        read and cached.  The renders read the uniform table instead; this
        is the grid the JAX package's fused scenes hold."""
        if self._sigmas is None:
            y_off, ny_loc = self._ky_rows()
            self._sigmas = _power.tabulate_sigmas(
                self.shape, self.grid_spacing, self.power,
                self.scene.interpolation, self.device, y_off, ny_loc)
        return self._sigmas

    def _ky_rows(self):
        """(offset, count) of this rank's ky rows: the whole axis on one
        device."""
        ny = self.shape[1]
        return (0, ny) if self.mesh is None else self.mesh.rows(ny)

    def predicted_variance(self, smoothing_length=0.0, apply_lightcone=False):
        """Expected variance of a rendered field, from the table sigma.

        The sum over packed modes of multiplicity * (sigma * filter)^2, with
        the float32 per-mode amplitudes the render applies, accumulated in
        float64 on the scene's device (on a mesh, each rank over its ky rows,
        then summed over the ranks).  ``apply_lightcone=True`` predicts the
        default lightcone-weighted render: the plane mean of D^2 times the
        unweighted variance.
        """
        nx, ny, nz = self.shape
        y_off, ny_loc = self._ky_rows()
        mult = _grid.kz_multiplicity(nz, self.device)
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        step = 64  # x planes per pass: bounds the temporaries at any size
        for x0 in range(0, nx, step):
            amp = _sampler.sigma_amplitude(
                self.state.table, self.shape, self.grid_spacing,
                smoothing_length, x0, min(step, nx - x0), y_off, ny_loc,
            ).to(torch.float64)
            total += (amp * amp * mult).sum()
        if self.mesh is not None:
            self.mesh.all_reduce_sum(total)
        out = float(total)
        if apply_lightcone:
            w = np.asarray(self.growth_function, np.float64)
            out *= float(np.mean(w * w))
        return out

    # ---- rendering -----------------------------------------------------------
    def _weights(self, apply_lightcone):
        w = self.state.lightcone_weights
        return w if apply_lightcone else torch.ones_like(w)

    def _sampled_spectrum(self, seed, smoothing_length):
        """The seed's packed 'xyz' spectrum as (re, im) float32 lattices
        (on a mesh, this rank's ky slab)."""
        if self.mesh is not None:
            spectrum = {"pallas": _render.pallas_spectrum,
                        "nested": _render.nested_spectrum,
                        "threefry": _render.threefry_spectrum}[self.sampler]
            return spectrum(seed, self.state.table, self.shape,
                            self.grid_spacing, smoothing_length, self.mesh)
        if self.sampler == "pallas":
            return _sampler.sample_spectrum(
                seed, self.state.table, self.shape, self.grid_spacing,
                smoothing_length)
        draw = (_sampler.sample_nested if self.sampler == "nested"
                else _sampler.draw_scale)
        re, im = draw(seed, self.state.table, self.shape, self.grid_spacing,
                      smoothing_length)
        return re, im

    def _spectrum_to_field(self, re, im, apply_lightcone):
        """Spectrum (consumed in place) -> field: K3 x, K3 y, K4."""
        if self.mesh is not None:
            return _dfft.irfftn_slab_reim(re, im, self.shape, self.mesh,
                                          self._weights(apply_lightcone))
        return _staged.finish_staged_reim(
            re, im, self._weights(apply_lightcone), self.shape)

    def generate_delta_field(self, seed=0, smoothing_length=0.0,
                             apply_lightcone=True):
        """Render one realization: an (nx, ny, nz) float32 tensor on the
        scene's device (on a mesh, this rank's (nx/P, ny, nz) x slab).  A
        fixed seed gives a bit-identical field; with ``sampler='threefry'``
        the stream is the JAX package's at the same seed.  A single-device
        ``sampler='pallas'`` render is the staged one, in the variant
        ``RF_STAGED_PIPELINE`` selects (:mod:`.staged`)."""
        if self.mesh is None and self.sampler == "pallas":
            return _staged.render_v3(
                seed, self.state.table, self.shape, self.grid_spacing,
                self._weights(apply_lightcone), smoothing_length)
        if self.mesh is None and self.pipeline == "staged":
            return _staged.render_v3_threefry(
                seed, self.state.table, self.shape, self.grid_spacing,
                self._weights(apply_lightcone), smoothing_length)
        re, im = self._sampled_spectrum(seed, smoothing_length)
        return self._spectrum_to_field(re, im, apply_lightcone)

    def generate_delta_fields(self, seeds, smoothing_length=0.0,
                              apply_lightcone=True):
        """A batch of seeds (leading axis = seed), each row the render of
        its seed.  A single-device ``sampler='pallas'`` scene renders the
        batch into one stack with no copy and no host round trip per seed
        (:func:`.staged.render_v3_batch`) when the stack fits
        (:func:`.staged.can_batch_staged`); else one render per seed."""
        seeds = np.asarray(seeds).ravel()
        if (self.mesh is None and self.sampler == "pallas"
                and _staged.can_batch_staged(self.shape, len(seeds),
                                             self.device)):
            return _staged.render_v3_batch(
                seeds, self.state.table, self.shape, self.grid_spacing,
                self._weights(apply_lightcone), smoothing_length)
        return torch.stack([
            self.generate_delta_field(s, smoothing_length, apply_lightcone)
            for s in seeds
        ])

    def _require_threefry(self, what):
        if self.sampler == "pallas":
            raise ValueError(
                f"sampler='pallas' draws inside the fused kernel; {what}")

    def generate_noise(self, seed=0):
        """A seed's raw unit normal draws, shape (2, nx, ny, nz//2+1): the
        state before symmetrization and scaling.  ``generate_from_noise``
        of it equals ``generate_delta_field(seed)`` exactly.  On CUDA the
        fused K2 kernel writes them (its unit mode), or for a nested scene
        KN (its unit mode).  On a mesh every rank gets the whole grid's
        draws on its device, the single-device result (the JAX package's
        global array)."""
        self._require_threefry("there is no exportable pre-kernel noise state")
        if self.sampler == "nested":
            return _sampler.sample_nested(seed, self.state.table, self.shape,
                                          self.grid_spacing, mode="unit")
        return _sampler.draw_scale(seed, self.state.table, self.shape,
                                   self.grid_spacing, unit=True)

    def generate_from_noise(self, draws, smoothing_length=0.0,
                            apply_lightcone=True):
        """Render from external unit normal draws (2, nx, ny, nz//2+1).

        The same algebra as a seeded render: symmetrize, sigma(k) and the
        filter, c2r, lightcone.  ``draws`` is copied, not consumed.  One
        device: a mesh raises ValueError, as in the JAX package.
        """
        self._require_threefry("generate_from_noise needs a scene with "
                               "sampler='threefry' or 'nested'")
        if self.mesh is not None:
            raise ValueError(
                "generate_from_noise needs a single-device fused scene with "
                "a materialized sigma grid (sampler='threefry' or 'nested', "
                "pipeline='fused', mesh=None)")
        nx, ny, nz = self.shape
        want = (2, nx, ny, nz // 2 + 1)
        draws = torch.as_tensor(draws, dtype=torch.float32, device=self.device)
        if tuple(draws.shape) != want:
            raise ValueError(
                f"draws must have shape {want} (2 = re/im unit normals "
                f"over the packed half-spectrum), got {tuple(draws.shape)}"
            )
        re = draws[0].clone(memory_format=torch.contiguous_format)
        im = draws[1].clone(memory_format=torch.contiguous_format)
        re, im = _staged.scaled_draws(re, im, self.state.table, self.shape,
                                      self.grid_spacing, smoothing_length)
        return self._spectrum_to_field(re, im, apply_lightcone)

    def _require_fixed(self):
        if self.sampler == "pallas" or self.pipeline == "staged":
            raise ValueError(
                "fixed fields need the Threefry or nested fused path (the "
                "Pallas/staged pipelines stream the spectrum); build the "
                "Generator with sampler='threefry', pipeline='auto' or "
                "'fused'")

    def generate_fixed_field(self, seed=0, smoothing_length=0.0,
                             apply_lightcone=True, flip=False):
        """Variance-suppressed 'fixed' realization (Angulo & Pontzen 2016).

        Every mode's amplitude is pinned to sigma(k) times the filter
        exactly and only its phase, the seed's Hermitian draw's, is random,
        so the field variance equals ``predicted_variance()`` to rounding.
        ``flip=True`` renders the paired realization (every phase shifted by
        pi: for the Gaussian field the exact negation).  On CUDA the draw is
        K2F's fixed mode (KN's for a nested scene), then K3, K3, K4; on a
        mesh the same modes on the rank's ky rows, then the distributed
        inverse.  ``sampler='pallas'`` and ``pipeline='staged'`` raise
        ValueError, as in the JAX package.
        """
        re, im = self._fixed_spectrum(seed, smoothing_length, flip)
        return self._spectrum_to_field(re, im, apply_lightcone)

    def _fixed_spectrum(self, seed, smoothing_length, flip):
        """The seed's fixed spectrum (re, im): K2F's fixed mode, or KN's (on
        a mesh, this rank's ky slab)."""
        self._require_fixed()
        if self.mesh is not None:
            return _render.fixed_spectrum(
                seed, self.state.table, self.shape, self.grid_spacing,
                smoothing_length, flip, self.mesh,
                nested=self.sampler == "nested")
        if self.sampler == "nested":
            spec = _sampler.sample_nested(
                seed, self.state.table, self.shape, self.grid_spacing,
                smoothing_length, mode="fixed", flip=flip)
        else:
            spec = _sampler.draw_fixed(seed, self.state.table, self.shape,
                                       self.grid_spacing, smoothing_length,
                                       flip)
        return spec[0], spec[1]

    def generate_fixed_fields(self, seeds, smoothing_length=0.0,
                              apply_lightcone=True, flip=False):
        """A batch of fixed fields (leading axis = seed), row i
        ``generate_fixed_field(seeds[i], ...)``; for 'fixed & paired'
        ensembles render the batch with ``flip=False`` and ``flip=True``."""
        self._require_fixed()
        seeds = np.asarray(seeds).ravel()
        return torch.stack([
            self.generate_fixed_field(s, smoothing_length, apply_lightcone,
                                      flip)
            for s in seeds
        ])

    # ---- derived fields (seed-direct: no forward transform) --------------------
    def _derived(self, seed, kind, components, prefactor, smoothing_length):
        """Snapshot fields (no lightcone weights) of one kind: the seed's
        spectrum drawn once (K2F, K1 or KN; a pallas scene's draw is K1
        whatever ``RF_STAGED_PIPELINE`` says), each component KD on a
        copy of it (the last on the spectrum itself), then K3, K3 and K4.
        Returns a list of float32 (nx, ny, nz) fields.  On a mesh (not with
        ``sampler='pallas'``, as in the JAX package) the rank's ky slab of
        the spectrum, KD at its ky offset and the distributed inverse: a
        list of the rank's (nx/P, ny, nz) x slabs."""
        re, im = self._mesh_spectrum(seed, smoothing_length)
        return _derived.fields_from_spectrum(re, im, self.shape,
                                             self.grid_spacing, kind,
                                             components, prefactor,
                                             mesh=self.mesh)

    def _mesh_spectrum(self, seed, smoothing_length):
        """:meth:`_sampled_spectrum` for the mesh programs that read more
        than a plain render: ValueError for a pallas mesh scene, whose
        mesh renders are plain fields only (the JAX package's
        ``_mesh_sigmas``)."""
        if self.mesh is not None and self.sampler == "pallas":
            raise ValueError(
                "mesh scenes with sampler='pallas' support plain renders only "
                "(the hardware stream is its own realization family); build "
                "the Generator with sampler='threefry' for derived fields, "
                "estimators and constrained renders")
        return self._sampled_spectrum(seed, smoothing_length)

    def _components(self, seed, kind, count, component, prefactor,
                    smoothing_length):
        """One component, or all ``count`` stacked on a leading axis."""
        comps = range(count) if component is None else [int(component)]
        out = self._derived(seed, kind, comps, prefactor, smoothing_length)
        return out[0] if component is not None else torch.stack(out)

    def generate_potential(self, seed=0, z=0.0, smoothing_length=0.0):
        """Dimensionless peculiar potential Phi/c^2 of a seed (snapshot): the
        realization of ``generate_delta_field(seed)`` through the comoving
        Poisson equation, computed on the spectrum."""
        pref = _derived.potential_prefactor(self.cosmology, z)
        return self._derived(seed, "scalar", [0], pref, smoothing_length)[0]

    def generate_displacement(self, seed=0, component=None,
                              smoothing_length=0.0, order=1):
        """Lagrangian displacement psi [Mpc/h] of a seed (snapshot).

        ``order=1``: Zel'dovich, psi_k = i k delta_k / k^2.  ``order=2``:
        adds the 2LPT correction of the same realization
        (:func:`..ops.derived.delta_to_displacement_2lpt` of its unweighted
        field; on a mesh :func:`..parallel.render.displacement_2lpt` of its
        sampled spectrum, the JAX package's mesh program, equal to it up to
        the transforms' rounding).  ``component`` 0/1/2 returns one (nx, ny,
        nz) component; None stacks all three.
        """
        if order not in (1, 2):
            raise ValueError(f"order must be 1 or 2, got {order!r}")
        psi = self._components(seed, "grad", 3, component, 1.0,
                               smoothing_length)
        if order == 2 and self.mesh is not None:
            comps = (0, 1, 2) if component is None else (int(component),)
            re, im = self._mesh_spectrum(seed, smoothing_length)
            psi2 = _render.displacement_2lpt(re, im, self.shape,
                                             self.grid_spacing, self.mesh,
                                             comps)
            return psi + (torch.stack(psi2) if component is None else psi2[0])
        if order == 2:
            delta = self.generate_delta_field(
                seed, smoothing_length=smoothing_length, apply_lightcone=False)
            psi2 = _derived.delta_to_displacement_2lpt(delta,
                                                       self.grid_spacing)
            psi = psi + (psi2 if component is None else psi2[int(component)])
        return psi

    def generate_velocity(self, seed=0, z=0.0, component=None,
                          smoothing_length=0.0):
        """Linear peculiar velocity [km/s] of a seed (snapshot): v = a H(a)
        f(a) psi."""
        pref = _derived.velocity_prefactor(self.cosmology, z)
        return self._components(seed, "grad", 3, component, pref,
                                smoothing_length)

    def generate_tidal_field(self, seed=0, component=None,
                             smoothing_length=0.0):
        """Tidal (T-web) tensor T_ij = d_i d_j phi, grad^2 phi = delta, of a
        seed: ``component`` indexes ``ops.derived.TIDAL_PAIRS`` (xx, yy, zz,
        xy, xz, yz); None stacks all six (6, nx, ny, nz).  The diagonal sums
        to the seed's unweighted density field."""
        return self._components(seed, "tidal", 6, component, 1.0,
                                smoothing_length)

    def classify_web(self, seed=0, smoothing_length=0.0, threshold=0.0):
        """Per-voxel T-web class of a realization, int8 0..3 = void / sheet
        / filament / knot (the count of tidal eigenvalues above
        ``threshold``; :mod:`..models.web`)."""
        t = self.generate_tidal_field(seed, smoothing_length=smoothing_length)
        return _web.classify_web(t, threshold)

    def generate_kaiser_field(self, seed=0, z=0.0, bias=1.0, f=None,
                              los_axis=2, smoothing_length=0.0):
        """Linear redshift-space density (b + f mu^2) delta_k of a seed,
        mu = k_los / |k| along ``los_axis``, ``f`` the growth rate
        (default ``cosmology.growth_rate(z)``); snapshot, no lightcone
        weights."""
        b, fv = self._kaiser_bf(z, bias, f)
        return self._derived(seed, "kaiser", [int(los_axis)], (b, fv),
                             smoothing_length)[0]

    def generate_nongaussian_field(self, seed, fnl, kind="field",
                                   smoothing_length=0.0):
        """Local-f_NL non-Gaussian realization (:mod:`..models.nongaussian`):
        ``kind='field'`` is delta = g + f_NL (g^2 - <g^2>) on this scene's
        Gaussian render g (no lightcone weights), ``kind='potential'`` f_NL on
        the Bardeen-sign linear potential.  f_NL = 0 returns
        ``generate_delta_field(seed, apply_lightcone=False)`` exactly.  Gate
        with :meth:`calculate_bispectrum` against
        :meth:`predicted_ng_bispectrum`."""
        from randomfield_tpu_torch.models import nongaussian as _ng

        return _ng.generate_local_ng_field(self, seed, fnl, kind=kind,
                                           smoothing_length=smoothing_length)

    # ---- power spectra ---------------------------------------------------------

    def sample_power(self, seed=0, smoothing_length=0.0, nbins=32):
        """Realized binned P(k) of a seed's spectrum, with no FFT.

        P_hat = |c_k|^2 V of the sampled packed spectrum, binned as
        :meth:`calculate_power` bins a field, so it equals
        ``calculate_power(generate_delta_field(seed, apply_lightcone=False))``
        up to transform rounding.  With ``sampler='pallas'`` and ``nbins`` <=
        128 this runs K5, which bins the draws as it makes them and writes
        no spectrum (BASELINE config 4); otherwise the spectrum is sampled
        and binned (:func:`.validate.stats.spectrum_power`).  Returns host
        float64 ``(k_mean, p_hat, n_modes)``.  On a mesh (``sampler='threefry'``
        only, as in the JAX package) each rank bins its ky rows and every
        rank gets the sums over all of them.
        """
        if self.mesh is not None:
            if self.sampler == "pallas":
                raise ValueError(
                    "mesh scenes with sampler='pallas' support plain renders "
                    "only, as in the JAX package; build the Generator with "
                    "sampler='threefry' for sample_power on a mesh")
            spectrum = self._sampled_spectrum(seed, smoothing_length)
            return _stats.bins_to_host(_render.spectrum_bins(
                spectrum, self.shape, self.grid_spacing, int(nbins),
                self.mesh), int(nbins))
        if self._kernel_binned(nbins):
            ks, ps, ms = self._kernel_power([seed], smoothing_length,
                                            int(nbins))
            return ks, ps[0], ms
        re, im = self._sampled_spectrum(seed, smoothing_length)
        return _stats.spectrum_power((re, im), self.shape, self.grid_spacing,
                                     nbins)

    def sample_power_batch(self, seeds, smoothing_length=0.0, nbins=32):
        """:meth:`sample_power` for a seed batch: host float64 ``(k_mean,
        p_hat[nseeds, nbins], n_modes)`` in ``seeds`` order (k_mean and
        n_modes do not depend on the seed).  Through K5 the batch's sums
        stay in one device block and come to the host in one transfer."""
        seeds = [int(s) for s in np.asarray(seeds).ravel()]
        if seeds and self._kernel_binned(nbins):
            return self._kernel_power(seeds, smoothing_length, int(nbins))
        ks = ms = None
        rows = []
        for s in seeds:
            ks, p, ms = self.sample_power(s, smoothing_length, nbins)
            rows.append(p)
        return ks, np.asarray(rows), ms

    def _kernel_binned(self, nbins):
        return (self.mesh is None and self.sampler == "pallas"
                and nbins <= _sampler.MAX_KERNEL_BINS)

    def _kernel_power(self, seeds, smoothing_length, nbins):
        """(k_mean, p_hat[nseeds, nbins], n_modes) of the seeds' spectra
        through K5, which bins the interior and the Hermitian planes as it
        draws them, each seed into its row of one device block; the bins
        (edges, k vectors) are made once per scene and nbins."""
        plan = self._bin_plans.get(nbins)
        if plan is None:
            edges, _ = _stats.bin_setup(self.shape, self.grid_spacing, nbins)
            plan = _sampler.bin_plan(self.shape, self.grid_spacing, edges,
                                     self.device)
            self._bin_plans[nbins] = plan
        acc = _sampler.sample_power_bins_batch(
            seeds, self.state.table, self.shape, self.grid_spacing,
            smoothing_length, plan)
        counts, psum, ksum = acc.cpu().numpy().transpose(1, 0, 2)
        with np.errstate(invalid="ignore", divide="ignore"):
            return ksum[0] / counts[0], psum / counts, counts[0]


def _check_kernel_shape(shape):
    """Raise ValueError unless the CUDA kernels take this grid."""
    if not _staged.can_v5(shape):
        raise ValueError(
            f"grid {shape} is not supported on CUDA: nx, ny and nz/2 must be "
            f"powers of two in [{_fft.MIN_LENGTH}, {_fft.MAX_LENGTH}] (a "
            f"mixed-radix FFT is on the roadmap); use device='cpu'"
        )
