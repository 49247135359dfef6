"""FKP survey power spectra: data and randoms catalogs on the grid.

Port of ``randomfield_tpu/validate/fkp.py`` with its names, arguments and
returns.  The Feldman-Kaiser-Peacock (1994) estimator paints the weighted
data catalog and a randoms catalog and measures the fluctuation field

    F(x) = [n_d(x) - alpha n_r(x)] w(x) / sqrt(I22),
    alpha = sum_d w_i / sum_r w_i,
    I22   = alpha sum_r nbar_i w_i^2,

P(k) = <|F_hat(k)|^2> - P_shot with P_shot = (sum_d w_i^2 + alpha^2 sum_r
w_i^2) / I22; optimal weights are 1 / (1 + nbar P0).

Both catalogs stay on their device: the weights and their sums are
float64 there (the JAX package copies every weight to the host), each
catalog is painted by KP (:func:`..ops.paint.deposit`, int64 fixed point,
the interlacing shift a kernel argument) and F is formed from the two
exact int64 grids in float64, a slab of x planes at a time, and rounded
once to float32.  The estimator is the port's ``calculate_power`` (and
its multipoles) with the window deconvolved: K6 and K3 for the transform,
KB for the bins.  Positions are (3, N); numpy catalogs go to ``device``
("cuda" by default), tensors stay on theirs.

With ``mesh=`` (a slab mesh) every rank takes both whole catalogs, forms
alpha, I22, the shot sums and the fixed-point exponents from them as one
device does, deposits the particles it owns onto its x window
(:func:`..parallel.paint.deposit_sharded`: KP, the margins folded through
the ring, int64) and runs the same float64 combination on its rows, so
its x slab of F equals the single-device field's rows bit for bit; the
mesh ``calculate_power`` estimates it.  (The JAX package's mesh path
rebuilds each mass grid in float32 from its painted contrast.)  A pencil
mesh raises NotImplementedError (ROADMAP.md, Queue 1 item 5).
"""

from __future__ import annotations

import math
import typing

import numpy as np
import torch

from randomfield_tpu_torch.ops import paint as _paint
from randomfield_tpu_torch.validate import fourier as _fourier
from randomfield_tpu_torch.validate.stats import device_of, slab_mesh

__all__ = ["FKPPower", "fkp_weights", "fkp_power", "fkp_power_multipoles"]

# x planes a step of the field's float64 combination (bounds temporaries)
_X_CHUNK = 32


class FKPPower(typing.NamedTuple):
    """FKP estimate: ``p`` is shot-subtracted (the monopole only, for
    multipoles); ``p + shot_noise`` recovers the raw spectrum."""

    k: np.ndarray
    p: typing.Any            # array, or {ell: array} for multipoles
    n_modes: np.ndarray
    shot_noise: float
    alpha: float
    i22: float


def fkp_weights(nbar, p0):
    """Optimal FKP weights 1 / (1 + nbar P0): float64 numpy for numpy (or
    scalar) ``nbar``, a float64 tensor on its device for a tensor."""
    if isinstance(nbar, torch.Tensor):
        nbar = nbar.to(torch.float64)
        if bool((nbar < 0).any()):
            raise ValueError("nbar must be non-negative")
        return 1.0 / (1.0 + nbar * float(p0))
    nbar = np.asarray(nbar, np.float64)
    if np.any(nbar < 0):
        raise ValueError("nbar must be non-negative")
    return 1.0 / (1.0 + nbar * float(p0))


def _per_object(values, n, device):
    """float64 (n,) on ``device`` of a scalar or per-object array."""
    t = torch.as_tensor(values if isinstance(values, torch.Tensor)
                        else np.asarray(values, np.float64))
    t = t.to(device=device, dtype=torch.float64)
    if t.ndim > 1 and t.numel() == n:
        t = t.reshape(-1)
    return torch.broadcast_to(t, (n,))


def _prep_catalog(positions, weights, nbar, p0, name, device, counts=False):
    """(float32 (3, N) positions, painted float64 weights, sum_w, sum_w2,
    sum_nbar_w2) with the sums taken PER OBJECT in float64 on the
    catalog's device.  ``counts=True`` reads ``weights`` as per-cell
    multiplicities of unit-weight objects at lattice positions
    (:func:`..models.zeldovich.poisson_sample`): a cell holding c objects
    of FKP weight m adds c m to sum_w but c m^2 (not (c m)^2) to sum_w2 and
    to the I22 integrand."""
    positions = torch.as_tensor(positions if isinstance(
        positions, torch.Tensor) else np.asarray(positions))
    if positions.ndim != 2 or positions.shape[0] != 3:
        raise ValueError(f"{name} positions must be (3, N), "
                         f"got {tuple(positions.shape)}")
    positions = positions.to(device=device, dtype=torch.float32)
    dev = positions.device
    n = positions.shape[1]
    base = _per_object(weights, n, dev)
    mult = torch.ones((), dtype=torch.float64, device=dev)
    if nbar is not None and p0:
        mult = fkp_weights(_per_object(nbar, n, dev), p0)
    painted = base * mult
    sum_w = float(painted.sum())
    nw2 = base * mult * mult if counts else painted * painted
    sum_w2 = float(nw2.sum())
    sum_nw2 = (float((_per_object(nbar, n, dev) * nw2).sum())
               if nbar is not None else None)
    return positions, painted, sum_w, sum_w2, sum_nw2


class _Catalogs(typing.NamedTuple):
    """Both catalogs made ready to paint: ((float32 (3, N) positions,
    float32 painted weights, fixed-point exponent) for the data and the
    randoms), alpha, I22, the data's and the randoms' shot sums, and the
    factor that turns the painted difference into the normalized field."""

    paint: tuple
    alpha: float
    i22: float
    shot_d: float
    shot_r: float
    scale: float


def _order(window):
    if window not in _paint.ORDERS:
        raise ValueError(f"window must be 'ngp', 'cic' or 'tsc', "
                         f"got {window!r}")
    return _paint.ORDERS[window]


def _prepare(data, randoms, spacing, shape, data_weights, randoms_weights,
             nbar_data, nbar_randoms, p0, device, data_are_counts=False,
             randoms_are_counts=False):
    """:class:`_Catalogs` of the two catalogs.  A ``*_are_counts`` catalog
    holds per-cell Poisson counts at lattice positions: its shot term is
    sum(w) rather than sum(w^2)."""
    pos_d, w_d, sw_d, sw2_d, snw2_d = _prep_catalog(
        data, data_weights, nbar_data, p0, "data", device,
        counts=data_are_counts)
    pos_r, w_r, sw_r, sw2_r, snw2_r = _prep_catalog(
        randoms, randoms_weights, nbar_randoms, p0, "randoms",
        device, counts=randoms_are_counts)
    if sw_d <= 0 or sw_r <= 0:
        raise ValueError("catalog weights must sum to a positive total")
    alpha = sw_d / sw_r
    volume = shape[0] * shape[1] * shape[2] * spacing**3
    if snw2_r is not None:
        i22 = alpha * snw2_r
    elif snw2_d is not None:
        i22 = snw2_d
    else:
        # uniform selection: nbar = alpha sum_r w / V everywhere
        i22 = alpha * (alpha * sw_r / volume) * sw2_r
    if i22 <= 0:
        raise ValueError("FKP normalization I22 is non-positive")
    paint = []
    for pos, w in ((pos_d, w_d), (pos_r, w_r)):
        w32 = w.to(torch.float32).contiguous()
        paint.append((pos, w32, _paint.fixed_point_exponent(
            _paint.total_abs_weight(pos, w32))))
    # calculate_power measures |V_cell DFT(f)|^2 / V; the FKP spectrum is
    # |DFT(D - alpha R)|^2 / I22: scale by sqrt(V) / (V_cell sqrt(I22))
    scale = math.sqrt(volume) / (spacing**3 * math.sqrt(i22))
    return _Catalogs(tuple(paint), alpha, i22, sw2_d, sw2_r, scale)


def _painted_field(cats, spacing, shape, order, shift=0.0, mesh=None):
    """The normalized FKP field (float32 on the catalogs' device) of
    :class:`_Catalogs` ``cats``, painted with ``shift``: the whole grid, or
    on a slab mesh this rank's x slab."""
    if mesh is None:
        accs = [_paint.deposit(pos, shape, spacing, w32, order, shift, s)
                for pos, w32, s in cats.paint]
    else:
        from randomfield_tpu_torch.parallel.paint import deposit_sharded

        accs = [deposit_sharded(pos, shape, spacing, mesh, w32, order, shift,
                                s)[0] for pos, w32, s in cats.paint]
    (acc_d, acc_r), (u_d, u_r) = accs, [math.ldexp(1.0, -s)
                                        for _, _, s in cats.paint]
    scale, alpha = cats.scale, cats.alpha
    f = torch.empty(acc_d.shape, dtype=torch.float32, device=acc_d.device)
    for x0 in range(0, acc_d.shape[0], _X_CHUNK):
        sl = slice(x0, x0 + _X_CHUNK)
        mass = acc_d[sl].to(torch.float64).mul_(u_d * scale)
        f[sl] = mass.sub_(acc_r[sl].to(torch.float64),
                          alpha=alpha * u_r * scale)
    return f


def _shot(i22, shot_d, shot_r, alpha, randoms_are_poisson):
    return (shot_d + (alpha * alpha * shot_r if randoms_are_poisson
                      else 0.0)) / i22


def _fields(data, randoms, spacing, shape, data_weights, randoms_weights,
            nbar_data, nbar_randoms, p0, window, interlaced, device, mesh,
            what, **kw):
    mesh = slab_mesh(what, mesh)
    order = _order(window)
    shape = tuple(int(s) for s in shape)
    spacing = float(spacing)
    if mesh is not None:
        device = mesh.device
    cats = _prepare(data, randoms, spacing, shape, data_weights,
                    randoms_weights, nbar_data, nbar_randoms, p0,
                    device_of(data, device), **kw)
    f = _painted_field(cats, spacing, shape, order, mesh=mesh)
    f2 = (_painted_field(cats, spacing, shape, order, spacing / 2.0, mesh)
          if interlaced else None)
    return f, f2, cats.alpha, cats.i22, cats.shot_d, cats.shot_r


def fkp_power(data, randoms, spacing, shape, data_weights=1.0,
              randoms_weights=1.0, nbar_data=None, nbar_randoms=None,
              p0=0.0, nbins=32, window="cic", interlaced=False,
              randoms_are_poisson=True, data_are_counts=False,
              randoms_are_counts=False, mesh=None, device=None):
    """FKP P(k) of a survey catalog against a randoms catalog.

    ``data``/``randoms``: (3, N) positions [Mpc/h] on the periodic box
    ``shape`` x ``spacing``.  ``*_weights`` are completeness weights; with
    ``p0 > 0`` and per-object ``nbar_*`` the optimal FKP weight
    1/(1 + nbar P0) multiplies them.  ``nbar_randoms`` (or ``nbar_data``)
    feeds the I22 normalization; omitted, the selection is uniform at alpha
    sum(w_r) / V.  ``randoms_are_poisson=False`` drops the alpha^2 randoms
    term from the shot noise; ``*_are_counts=True`` declares a
    per-cell-counts catalog.  ``window`` and ``interlaced`` follow
    ``catalog_power``.  Returns :class:`FKPPower`; runs on the catalogs'
    device (``device`` for numpy ones, CUDA by default), or with ``mesh``
    (a slab mesh, every rank passing both whole catalogs) on its device,
    every rank returning the whole estimate.
    """
    f, f2, alpha, i22, shot_d, shot_r = _fields(
        data, randoms, spacing, shape, data_weights, randoms_weights,
        nbar_data, nbar_randoms, p0, window, interlaced, device, mesh,
        "fkp_power", data_are_counts=data_are_counts,
        randoms_are_counts=randoms_are_counts)
    k, p, n = _fourier.calculate_power(f, float(spacing), nbins=int(nbins),
                                       window=window, interlaced_with=f2,
                                       mesh=mesh)
    shot = _shot(i22, shot_d, shot_r, alpha, randoms_are_poisson)
    return FKPPower(k, p - shot, n, shot, alpha, i22)


def fkp_power_multipoles(data, randoms, spacing, shape, data_weights=1.0,
                         randoms_weights=1.0, nbar_data=None,
                         nbar_randoms=None, p0=0.0, nbins=32,
                         ells=(0, 2, 4), los_axis=2, window="cic",
                         interlaced=False, randoms_are_poisson=True,
                         data_are_counts=False, randoms_are_counts=False,
                         mesh=None, device=None):
    """FKP P_ell(k) along a box axis (the periodic-box analog of the
    Yamamoto estimator; the shot noise comes off the monopole only).
    Returns :class:`FKPPower` with ``p = {ell: array}``."""
    f, f2, alpha, i22, shot_d, shot_r = _fields(
        data, randoms, spacing, shape, data_weights, randoms_weights,
        nbar_data, nbar_randoms, p0, window, interlaced, device, mesh,
        "fkp_power_multipoles", data_are_counts=data_are_counts,
        randoms_are_counts=randoms_are_counts)
    ells = tuple(int(e) for e in ells)
    k, p_ell, n = _fourier.calculate_power_multipoles(
        f, float(spacing), nbins=int(nbins), ells=ells,
        los_axis=int(los_axis), window=window, interlaced_with=f2, mesh=mesh)
    shot = _shot(i22, shot_d, shot_r, alpha, randoms_are_poisson)
    p_out = {ell: (row - shot if ell == 0 else row)
             for ell, row in zip(ells, np.asarray(p_ell))}
    return FKPPower(k, p_out, n, shot, alpha, i22)
