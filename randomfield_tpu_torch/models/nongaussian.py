"""Local primordial non-Gaussianity: f_NL fields with exact tree gates.

Port of ``randomfield_tpu/models/nongaussian.py`` (``_alpha_grid :52``,
``_quadratic_ng :69``, ``generate_local_ng_field :84``,
``_weighted_triple_sums :115``, ``predicted_ng_bispectrum :145``), its two
flavors of the local quadratic model:

* ``kind='field'``: delta = g + f_NL (g^2 - <g^2>) on the rendered
  Gaussian field g; tree bispectrum B = 2 f_NL [P(k1) P(k2) + 2 perms];
* ``kind='potential'``: f_NL on the linear z = 0 potential of the Bardeen
  sign, delta_k = alpha(k) Phi_k with alpha = (k D_H)^2 / (1.5 Om), so
  B = 2 f_NL alpha1 alpha2 alpha3 [P_Phi(k1) P_Phi(k2) + 2 perms] with
  P_Phi = P / alpha^2.

The render is the scene's Gaussian render (``generate_delta_field`` with
no lightcone weights: K2F, K3, K3, K4 for the default sampler); the
potential flavor adds :func:`..ops.transform.rfftn` (K6, forward K3 twice)
and :func:`..ops.transform.irfftn_reim` (K3, K3, K4) twice each, the JAX
package's ``norm='forward'`` r2c being the port's unnormalized one over N.
f_NL = 0 returns the Gaussian render bit for bit (g + 0 x, x finite).  On a
slab mesh the Gaussian render is the rank's x slab and the quadratic part
is the whole field's, as the JAX package computes it on its sharded array:
<g^2> summed in float64 on each rank and all-reduced, the potential's
transforms the distributed ones (:mod:`..parallel.dfft`) with alpha on the
rank's ky rows.  The
prediction evaluates the estimator's shell identity sum_x F_i F_j F_l =
N sum_{closed triads} f(k1) f(k2) f(k3) with weighted shells through the
same bins and triad geometry as
:func:`..validate.bispectrum.calculate_bispectrum`, so the gate has a
non-zero expectation and no binning systematics.
"""

from __future__ import annotations

import numpy as np
import torch

from randomfield_tpu_torch.models import cosmology as _cosmo
from randomfield_tpu_torch.ops import derived as _derived
from randomfield_tpu_torch.ops import grid as _grid
from randomfield_tpu_torch.ops import power as _power
from randomfield_tpu_torch.parallel import dfft as _dfft
from randomfield_tpu_torch.validate import bispectrum as _bisp

__all__ = ["generate_local_ng_field", "predicted_ng_bispectrum"]

_KINDS = ("field", "potential")


def _check_kind(kind):
    if kind not in _KINDS:
        raise ValueError(f"kind must be 'field' or 'potential', got {kind!r}")


def _alpha_grid(shape, spacing, cosmology, dtype=torch.float32, device="cpu",
                y_off=0, ny_loc=None):
    """delta_k / Phi_k at z = 0 with the Bardeen (CMB) sign, 0 at DC: the
    negative of the Newtonian Poisson kernel of :mod:`..ops.derived`, so
    f_NL > 0 gives a positive squeezed bispectrum.  On the ky rows [y_off,
    y_off + ny_loc), all by default."""
    c = _cosmo.create_cosmology(cosmology)
    k2 = _grid.ksq(shape, spacing, dtype, device, y_off=y_off, ny_loc=ny_loc)
    return (k2 * _derived.D_H_MPC_H ** 2) / (1.5 * c.Om0)


def _inverse_alpha(alpha):
    return torch.where(alpha != 0, 1.0 / torch.where(alpha != 0, alpha, 1.0),
                       0.0)


def _mean(x, shape, mesh=None):
    """float32 mean of a field (on a mesh, of the whole field from this
    rank's x slab), summed in float64 x-slab by x-slab (and over the
    ranks)."""
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for chunk in x.split(16):
        total += chunk.sum(dtype=torch.float64)
    if mesh is not None:
        mesh.all_reduce_sum(total)
    return float(np.float32(float(total) / (shape[0] * shape[1] * shape[2])))


def _quadratic_ng(g, fnl, shape, spacing, kind, alpha, mesh=None):
    """delta_NG from the Gaussian render g (float32 f_NL ``fnl``); on a
    mesh g is this rank's x slab and ``alpha`` its ky slab."""
    if kind == "field":
        q = g * g
        return g + fnl * (q - _mean(q, shape, mesh))
    n = shape[0] * shape[1] * shape[2]
    inv_n = float(np.float32(1.0 / n))
    re, im = _dfft.forward(g, mesh)
    scale = _inverse_alpha(alpha).mul_(inv_n)
    re.mul_(scale)
    im.mul_(scale)
    del scale
    phi = _dfft.inverse(re, im, shape, mesh)
    q = phi * phi
    del phi
    q -= _mean(q, shape, mesh)
    re, im = _dfft.forward(q, mesh)
    del q
    scale = alpha * inv_n
    re.mul_(scale)
    im.mul_(scale)
    del scale
    dq = _dfft.inverse(re, im, shape, mesh)
    return g + fnl * dq


def generate_local_ng_field(generator, seed, fnl, kind="field",
                            smoothing_length=0.0):
    """A local-f_NL non-Gaussian field from a Generator scene.

    The Gaussian part is the scene's realization of ``seed`` with no
    lightcone weights (f_NL = 0 returns it bit for bit), the quadratic part
    added on its device (module docstring for ``kind``); a mesh scene
    returns this rank's x slab of the whole field's result.  Validate with
    ``calculate_bispectrum`` against :func:`predicted_ng_bispectrum`.
    """
    _check_kind(kind)
    g = generator.generate_delta_field(seed, smoothing_length=smoothing_length,
                                       apply_lightcone=False)
    shape = tuple(int(s) for s in generator.shape)
    spacing = float(generator.grid_spacing)
    mesh = getattr(generator, "mesh", None)
    y_off, ny_loc = (0, shape[1]) if mesh is None else mesh.rows(shape[1])
    alpha = (_alpha_grid(shape, spacing, generator.cosmology, g.dtype,
                         g.device, y_off, ny_loc)
             if kind == "potential" else None)
    return _quadratic_ng(g, float(np.float32(fnl)), shape, spacing, kind,
                         alpha, mesh)


def _weighted_triple_sums(wa, wb, shape, spacing, edges, triples):
    """sum_x [A_i A_j B_l + A_j A_l B_i + A_l A_i B_j] per triple, float64:
    A and B the unnormalized shells of the real, Hermitian-even mode
    weights ``wa`` and ``wb`` (2 nbins fields held at once)."""
    kmag = _grid.kmag(shape, spacing, torch.float32, wa.device)
    sa = _bisp.shells(wa, None, shape, edges, kmag)
    sb = _bisp.shells(wb, None, shape, edges, kmag)
    del kmag
    out = np.empty(len(triples))
    for t, (i, j, l) in enumerate(np.asarray(triples).tolist()):
        total = 0.0
        for x0 in range(0, shape[0], 16):
            s = slice(x0, x0 + 16)
            tot = (sa[i][s] * sa[j][s] * sb[l][s]
                   + sa[j][s] * sa[l][s] * sb[i][s]
                   + sa[l][s] * sa[i][s] * sb[j][s])
            total += float(tot.sum(dtype=torch.float64))
        out[t] = total
    return out


def predicted_ng_bispectrum(power, shape, spacing, fnl, kind="field",
                            cosmology="Planck13", smoothing_length=0.0,
                            nbins=8, kmin=None, kmax=None,
                            interpolation="log10k", device="cuda"):
    """The exact binned tree-level bispectrum of a local-f_NL field:
    2 f_NL sum_triads [w(k1) w(k2) b(k3) + perms] / N_tri per bin triple
    through the estimator's shells, bins and triad geometry, with (w, b) =
    (P_eff, 1) for ``kind='field'`` and (P_eff / alpha, alpha) for
    ``kind='potential'`` (P_eff with the render's Gaussian smoothing).
    Returns ``(k_centers, triples, B_pred, ntri)`` aligned with
    ``calculate_bispectrum``; runs on ``device``."""
    _check_kind(kind)
    shape = tuple(int(s) for s in shape)
    spacing = float(spacing)
    _, peff = _power.grid_power(power, shape, spacing, interpolation, device,
                                smoothing_length)
    if kind == "field":
        wa, wb = peff, torch.ones_like(peff)
    else:
        alpha = _alpha_grid(shape, spacing, cosmology, torch.float32, device)
        wa, wb = peff * _inverse_alpha(alpha), alpha
    edges, triples = _bisp.bispectrum_bins(shape, spacing, nbins, kmin, kmax)
    num = _weighted_triple_sums(wa, wb, shape, spacing, edges, triples)
    den = _bisp.triangle_counts(shape, spacing, edges, triples, device)
    ncells = shape[0] * shape[1] * shape[2]
    ntri = den / ncells
    keep = ntri > 0.5
    with np.errstate(invalid="ignore", divide="ignore"):
        pred = 2.0 * float(fnl) * num / den
    centers = 0.5 * (edges[:-1] + edges[1:])
    return centers, triples[keep], pred[keep], ntri[keep]
