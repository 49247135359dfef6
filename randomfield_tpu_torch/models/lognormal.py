"""Lognormal random fields with a prescribed power spectrum.

Port of ``randomfield_tpu/models/lognormal.py`` (Coles & Jones 1991):
render a Gaussian field g with a *transformed* spectrum P_G, then map

    delta_LN = exp(g - sigma_G^2 / 2) - 1,

mean-zero, bounded below by -1, with the target two-point function.  The
transformation runs in the engine's grid conventions:

    xi(r)   = (1/V) sum_k P(k) e^{ik.r}          (grid-exact target xi)
    xi_G    = ln(1 + xi)                          (Gaussianized)
    P_G(k)  = V * (1/N^3) sum_r xi_G(r) e^{-ik.r} (clipped at 0)

and P_G is shell-averaged into a fine :class:`PowerTable` that a port
:class:`..engine.generator.Generator` renders.  Where the JAX package brings
xi, xi_G and P_G to host float64 arrays of the whole grid,
:func:`transformed_power` stays on the scene's device: xi by the hand
inverse transform (K3 x2, K4), log1p in place, P_G by the forward one (K6,
K3 x2), the clipped fraction as float64 reductions, and the shell average
by KB's ``'grid'`` kind on the reference's 256 log edges (searched in
float32, where the reference searches in float64).

On one device the renders end in K4L (:func:`..ops.fft.c2r_tail_exp`): the
draw (K2F, K1 or KN), K3 along x and y, then K4's kernel writing
``expm1(a_z x - c_z)`` with a_z = b w_z and c_z = b^2 w_z^2 sigma_G^2 / 2, so
the exp map costs no pass of its own.  The standalone
:func:`gaussian_to_lognormal` on a given field is a plain elementwise
expression, as the reference leaves it to XLA.  On a slab mesh
(``mesh=``) each rank draws its ky rows of the Gaussian spectrum and runs
the distributed inverse, whose last step is K4L on its x slab
(:func:`..parallel.dfft.irfftn_slab_reim` with offsets); the transformed
table is every rank's whole-grid one, as the JAX package builds it on
each host.

Lightcone: with ``apply_lightcone=True`` each z-plane's Gaussian amplitude
is D(z)/D(0), so the map subtracts the per-plane variance D^2 sigma_G^2 / 2.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from randomfield_tpu_torch.ops import binning as _binning
from randomfield_tpu_torch.ops import grid as _grid
from randomfield_tpu_torch.ops import power as _power
from randomfield_tpu_torch.ops import transform as _transform
from randomfield_tpu_torch.parallel import dfft as _dfft

__all__ = ["transformed_power", "gaussian_to_lognormal", "LognormalGenerator"]

# x planes a step of the grid passes (bounds their temporaries)
_X_CHUNK = 64


def _power_grid(table, shape, spacing, interpolation, device):
    """(float32 P(|k|) half-grid with P(0) = 0, sum of mult P in float64),
    built x-slab by x-slab."""
    nx, ny, nz = shape
    out = torch.empty((nx, ny, nz // 2 + 1), dtype=torch.float32,
                      device=device)
    mult = _grid.kz_multiplicity(nz, device)
    total = torch.zeros((), dtype=torch.float64, device=device)
    for x0 in range(0, nx, _X_CHUNK):
        n = min(_X_CHUNK, nx - x0)
        km = _grid.kmag(shape, spacing, torch.float32, device, x0, n)
        p = _power.interpolate_power(table, km, interpolation)
        p = torch.where(km > 0, p, 0.0)
        out[x0:x0 + n] = p
        total += (p.to(torch.float64) * mult).sum()
    return out, float(total)


def transformed_power(power, shape, spacing, nbins=256,
                      interpolation="log10k", device=None):
    """Gaussianized power table P_G for a target ``power`` on this grid.

    Returns ``(table, info)``: a :class:`PowerTable` covering the grid's
    full [k_min, k_max] band (edge bins clamp-extended), and an info dict
    with the Gaussian grid variance ``sigma_g2`` (xi_G at the origin), the
    target grid variance ``sigma2``, and ``clipped_fraction`` — the fraction
    of |P_G| mass removed by the non-negativity clip.  Runs on ``device``
    (CUDA by default): the grids never leave it.
    """
    shape = tuple(int(s) for s in shape)
    spacing = float(spacing)
    device = torch.device("cuda" if device is None else device)
    table = _power.validate_power(power)
    _power.require_coverage(table, shape, spacing)
    nx, ny, nz = shape
    cells = nx * ny * nz
    volume = cells * spacing**3

    pgrid, psum = _power_grid(table, shape, spacing, interpolation, device)
    re = pgrid.div_(float(np.float32(volume)))
    xi = _transform.irfftn_reim(re, torch.zeros_like(re), shape)
    del re, pgrid
    xi_min = float(xi.min())
    if xi_min <= -1.0:
        raise ValueError(
            f"target xi reaches {xi_min:.4f} <= -1 on this grid; the "
            "field has no lognormal representation (reduce the power "
            "amplitude or refine the grid)"
        )
    sigma_g2 = math.log1p(float(xi[0, 0, 0]))
    pg_re, pg_im = _transform.rfftn(torch.log1p_(xi))
    del xi, pg_im
    neg = torch.zeros((), dtype=torch.float64, device=device)
    total = torch.zeros((), dtype=torch.float64, device=device)
    for x0 in range(0, nx, _X_CHUNK):
        r = pg_re[x0:x0 + _X_CHUNK].to(torch.float64)
        neg -= r.clamp(max=0.0).sum()
        total += r.abs().sum()
    neg, total = float(neg), float(total)
    # P_G = V rfftn(xi_G, norm='forward'), clipped at 0, as float32
    pg = pg_re.mul_(float(np.float32(1.0 / cells))).clamp_(min=0.0)
    pg.mul_(float(np.float32(volume)))

    kmin, kmax = _grid.get_k_bounds(shape, spacing)
    edges = np.logspace(np.log10(kmin * 0.999), np.log10(kmax * 1.001),
                        int(nbins) + 1)
    sums = _binning.bin_spectrum("grid", (pg,), shape, spacing, edges)
    cnt, psums, ksum = sums[0, :, :int(nbins)].cpu().numpy()
    occ = cnt > 0
    k_tab = ksum[occ] / cnt[occ]
    p_tab = psums[occ] / cnt[occ]
    k_tab = np.concatenate([[kmin * 0.99], k_tab, [kmax * 1.01]])
    p_tab = np.concatenate([[p_tab[0]], p_tab, [p_tab[-1]]])
    info = {
        "sigma2": psum / volume,
        "sigma_g2": sigma_g2,
        "clipped_fraction": neg / total if total > 0 else 0.0,
    }
    return _power.PowerTable(k_tab, p_tab), info


def _plane_terms(sigma_g2, weights, nz, bias, device):
    """float32 (a, c): a = b w, c = 0.5 f32(b^2 w^2 sigma_g2) per plane."""
    w = np.ones(nz) if weights is None else np.asarray(weights, np.float64)
    b = float(bias)
    var = np.asarray(b * b * w**2 * float(sigma_g2), np.float32)
    a = np.asarray(b * w, np.float32)
    return (torch.as_tensor(a, device=device),
            torch.as_tensor(np.float32(0.5) * var, device=device))


def gaussian_to_lognormal(g, sigma_g2, lightcone_weights=None, bias=1.0):
    """exp-map a Gaussian field: ``exp(b g - b^2 var/2) - 1``.

    ``sigma_g2`` is the Gaussian field's variance; with
    ``lightcone_weights`` (the per-plane D(z)/D(0) already multiplied into
    ``g``) the subtracted variance is per-plane ``D^2 sigma_g2``.  ``bias``
    scales the Gaussian field first (deterministic lognormal bias: the
    result stays mean-zero, its two-point function ``exp(b^2 xi_G) - 1``).
    A plain elementwise expression in float32 on ``g``'s device.
    """
    g = torch.as_tensor(g)
    nz = g.shape[-1]
    w = np.ones(nz) if lightcone_weights is None else np.asarray(
        lightcone_weights, np.float64)
    b = float(bias)
    var = torch.as_tensor(np.asarray(b * b * w**2 * float(sigma_g2),
                                     np.float32), device=g.device)
    return torch.expm1(float(np.float32(b)) * g - 0.5 * var)


class LognormalGenerator:
    """Generate lognormal density fields with a target P(k).

    A composition: a port :class:`Generator` renders Gaussian fields with
    the transformed spectrum (``**kwargs`` go to it: ``sampler``,
    ``device``, ``interpolation``...), and on one device each render ends
    in K4L, the exp map fused into the c2r tail.  The draw is the sampler's
    own kernel (K2F, K1 or KN) whatever ``RF_STAGED_PIPELINE`` says, as the
    derived fields draw.  ``generate_delta_field(seed)`` returns a
    mean-zero field bounded below by -1 whose measured P(k) matches
    ``power``.  With ``mesh=`` (a slab mesh) the renders return this rank's
    x slab, the draw on its ky rows (K7, K8 or KN's shard) and K4L on its x
    slab; a pencil mesh raises NotImplementedError (Queue 1 item 5).
    """

    def __init__(self, nx, ny, nz, grid_spacing, cosmology=None, power=None,
                 table_bins=256, **kwargs):
        from randomfield_tpu_torch.engine.generator import Generator
        from randomfield_tpu_torch.models.cosmology import create_cosmology
        from randomfield_tpu_torch.models.powerspec import resolve_power

        from randomfield_tpu_torch.parallel import mesh as _mesh

        mesh = kwargs.get("mesh")
        if mesh is not None:
            mesh = _mesh.require_slab(mesh)
        cosmology = create_cosmology(cosmology)
        self.power = _power.validate_power(resolve_power(power, cosmology))
        shape = (int(nx), int(ny), int(nz))
        self.interpolation = kwargs.get("interpolation", "log10k")
        device = kwargs.get("device", None if mesh is None else mesh.device)
        self.gaussian_power, self.transform_info = transformed_power(
            self.power, shape, float(grid_spacing), nbins=table_bins,
            interpolation=self.interpolation, device=device,
        )
        self.gaussian = Generator(
            nx, ny, nz, grid_spacing, cosmology=cosmology,
            power=self.gaussian_power, **kwargs,
        )
        self._variances = {}
        # the variance actually rendered (table-interpolated, grid-exact)
        self.sigma_g2 = self._variance(0.0)

    def _variance(self, smoothing_length):
        """The Gaussian render's predicted variance, kept per smoothing
        length and scene state (a 1024^3 sum costs tens of ms a call)."""
        state, cache = self._variances.get("state"), self._variances
        if state is not self.gaussian.state:
            cache.clear()
            cache["state"] = self.gaussian.state
        key = float(smoothing_length)
        if key not in cache:
            cache[key] = float(self.gaussian.predicted_variance(
                smoothing_length=key))
        return cache[key]

    @property
    def scene(self):
        return self.gaussian.scene

    @property
    def cosmology(self):
        return self.gaussian.cosmology

    @property
    def growth_function(self):
        return self.gaussian.growth_function

    @property
    def redshifts(self):
        return self.gaussian.redshifts

    @property
    def pipeline(self):
        return self.gaussian.pipeline

    @property
    def sampler(self):
        return self.gaussian.sampler

    @property
    def device(self):
        return self.gaussian.device

    def _render(self, spectrum, smoothing_length, apply_lightcone, bias):
        """Spectrum (consumed) -> lognormal field: K3 x, K3 y, K4L."""
        var = self._variance(smoothing_length)
        w = self.growth_function if apply_lightcone else None
        a, c = _plane_terms(var, w, self.scene.shape[2], bias, self.device)
        re, im = spectrum
        if self.gaussian.mesh is not None:
            return _dfft.irfftn_slab_reim(re, im, self.scene.shape,
                                          self.gaussian.mesh, a, c)
        return _transform.irfftn_reim_exp(re, im, self.scene.shape, a, c)

    def generate_delta_field(self, seed=0, smoothing_length=0.0,
                             apply_lightcone=True):
        """One lognormal realization (cf. Generator.generate_delta_field).

        ``smoothing_length`` smooths the underlying GAUSSIAN field (its
        variance correction follows exactly).
        """
        return self.generate_biased_field(seed, 1.0, smoothing_length,
                                          apply_lightcone)

    def generate_fixed_field(self, seed=0, smoothing_length=0.0,
                             apply_lightcone=True, flip=False):
        """Variance-suppressed lognormal mock ('fixed & paired'): the
        Gaussian field's |c_k| pinned to sigma(k) (K2F's or KN's fixed
        mode), ``flip=True`` the paired realization."""
        spec = self.gaussian._fixed_spectrum(seed, smoothing_length, flip)
        return self._render(spec, smoothing_length, apply_lightcone, 1.0)

    def generate_delta_fields(self, seeds, smoothing_length=0.0,
                              apply_lightcone=True):
        """Batch of lognormal realizations (leading axis = seeds)."""
        seeds = np.asarray(seeds).ravel()
        return torch.stack([
            self.generate_delta_field(s, smoothing_length, apply_lightcone)
            for s in seeds
        ])

    def generate_biased_field(self, seed=0, bias=1.0, smoothing_length=0.0,
                              apply_lightcone=True):
        """A biased lognormal tracer field from the SAME realization:
        ``delta_b = exp(b g - b^2 sigma_G^2 / 2) - 1`` with the seed's
        Gaussian field g (Coles & Jones 1991 sec. 5); ``bias=1.0`` is
        :meth:`generate_delta_field` exactly."""
        spec = self.gaussian._sampled_spectrum(seed, smoothing_length)
        return self._render(spec, smoothing_length, apply_lightcone, bias)

    def _xi_gaussian_grid(self, smoothing_length=0.0):
        """Exact grid correlation of the rendered Gaussian field: float64
        ``torch.fft`` on the scene's device (a prediction)."""
        shape = self.scene.shape
        spacing = self.scene.grid_spacing
        volume = shape[0] * shape[1] * shape[2] * spacing**3
        km32 = _grid.kmag(shape, spacing, torch.float32, self.device)
        pgrid = _power.interpolate_power(self.gaussian_power, km32,
                                         self.interpolation).to(torch.float64)
        kmag = km32.to(torch.float64)
        pgrid = torch.where(kmag > 0, pgrid, 0.0)
        if smoothing_length:
            pgrid = pgrid * torch.exp(-(kmag * float(smoothing_length)) ** 2)
        return torch.fft.irfftn(pgrid, s=shape, norm="forward") / volume

    def predicted_biased_power(self, bias=1.0, bias2=None, nbins=32,
                               smoothing_length=0.0):
        """Exact per-bin expectation of the biased tracer spectrum (auto,
        or with ``bias2`` the cross-spectrum of two tracers of one seed),
        snapshot statistics, binned with the estimator's own bins."""
        xi_g = self._xi_gaussian_grid(smoothing_length)
        b2 = float(bias) if bias2 is None else float(bias2)
        return self._xi_to_binned_power(
            torch.expm1(float(bias) * b2 * xi_g), nbins)

    def _xi_to_binned_power(self, xi_t, nbins):
        """Bin the exact spectrum of a target grid correlation xi_t with the
        estimator's own bins (KB 'grid')."""
        from randomfield_tpu_torch.validate import stats as _stats

        shape = self.scene.shape
        spacing = self.scene.grid_spacing
        volume = shape[0] * shape[1] * shape[2] * spacing**3
        pt = torch.fft.rfftn(xi_t, norm="forward").real * volume
        pt[0, 0, 0] = 0.0  # the estimator masks the DC mode
        return _stats.bin_power_grid(pt.to(torch.float32), shape, spacing,
                                     nbins=nbins)

    def predicted_variance(self, smoothing_length=0.0, bias=1.0):
        """Expected variance of the (snapshot, possibly biased) field:
        ``exp(b^2 sigma_G^2) - 1``."""
        var = self._variance(smoothing_length)
        return float(np.expm1(float(bias) ** 2 * var))

    def calculate_power(self, delta, nbins=32):
        return self.gaussian.calculate_power(delta, nbins=nbins)
