"""Ensemble statistics: P(k) covariance and sigma(R) across seed batches.

Port of ``randomfield_tpu/validate/ensemble.py``: ``sample_power_ensemble
:56`` (with its scene fingerprint :32 and atomic ``.npz`` checkpoints),
``ensemble_power :148``, ``power_covariance :165``,
``predicted_power_covariance :180``, ``predicted_multipole_covariance
:244`` and ``sigma_r_from_field :313-345``.  The streaming ensemble rides
``Generator.sample_power_batch`` (K5 for a pallas scene: one launch a chunk
into one device block; K2F and KB for a threefry scene), so no field and no
FFT exists; the fingerprint names the sampler too, because the port's
pallas stream is not the TPU's.  The predictions build their grids on
``device`` ("cuda" by default) and sum in float64.
"""

from __future__ import annotations

import hashlib
import json
import pathlib

import numpy as np
import torch

from randomfield_tpu_torch.ops import binning as _binning
from randomfield_tpu_torch.ops import grid as _grid
from randomfield_tpu_torch.ops import power as _power
from randomfield_tpu_torch.ops import transform as _transform
from randomfield_tpu_torch.validate import stats as _stats

__all__ = ["ensemble_power", "sample_power_ensemble", "power_covariance",
           "predicted_power_covariance", "predicted_multipole_covariance",
           "sigma_r_from_field"]


def _scene_fingerprint(generator, smoothing_length, nbins):
    """What gives a binned spectrum row its meaning: grid shape, spacing,
    the power table (hashed), interpolation, smoothing, binning and the
    sampler; a checkpoint written for another refuses to resume."""
    t = generator.power
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(t.k).tobytes())
    h.update(np.ascontiguousarray(t.Pk).tobytes())
    return json.dumps({
        "shape": list(generator.shape),
        "grid_spacing": float(generator.grid_spacing),
        "power_sha256": h.hexdigest()[:16],
        "interpolation": generator.scene.interpolation,
        "smoothing_length": float(smoothing_length),
        "nbins": int(nbins),
        "sampler": generator.sampler,
    }, sort_keys=True)


def sample_power_ensemble(generator, seeds, smoothing_length=0.0, nbins=32,
                          checkpoint_path=None, checkpoint_every=16):
    """Streaming P(k) ensemble: ``Generator.sample_power_batch`` over chunks
    of seeds, no fields and no FFTs.  Returns host float64 ``(k_mean,
    p_hat[nseeds, nbins], n_modes)`` in ``seeds`` order.

    ``checkpoint_path`` makes a long run restartable: the rows are written
    atomically (a temporary file, then a rename) to that ``.npz`` every
    ``checkpoint_every`` new seeds and at the end; calling again skips the
    seeds already recorded and returns the union in ``seeds`` order (seeds
    not asked for stay in the file).  The file records the scene
    fingerprint and refuses a Generator that does not match it.
    """
    seeds_list = [int(s) for s in np.asarray(seeds).ravel()]
    fingerprint = _scene_fingerprint(generator, smoothing_length, nbins)
    done = {}
    ks = ms = None
    if checkpoint_path is not None:
        checkpoint_path = pathlib.Path(checkpoint_path)
        if checkpoint_path.exists():
            with np.load(checkpoint_path, allow_pickle=False) as f:
                ck_fp = (bytes(f["fingerprint"]).decode()
                         if "fingerprint" in f else "")
                if ck_fp != fingerprint:
                    raise ValueError(
                        f"checkpoint {checkpoint_path} was written for a "
                        f"different scene/binning ({ck_fp}); this call uses "
                        f"{fingerprint}: resuming would mix incompatible "
                        f"spectra. Use a different checkpoint path.")
                ks, ms = f["k_mean"], f["n_modes"]
                for s, row in zip(f["seeds"].tolist(), f["p_hat"]):
                    done[int(s)] = row

    def _write():
        order = sorted(done)
        tmp = checkpoint_path.with_suffix(".tmp.npz")
        np.savez(tmp, seeds=np.asarray(order, np.int64),
                 p_hat=np.asarray([done[s] for s in order]),
                 k_mean=ks, n_modes=ms,
                 smoothing_length=float(smoothing_length), nbins=int(nbins),
                 fingerprint=np.frombuffer(fingerprint.encode(),
                                           dtype=np.uint8))
        tmp.replace(checkpoint_path)

    todo = [s for s in seeds_list if s not in done]
    batch = max(1, min(int(checkpoint_every), 16))
    pending = 0
    for i in range(0, len(todo), batch):
        chunk = todo[i:i + batch]
        k, p_rows, m = generator.sample_power_batch(
            chunk, smoothing_length=smoothing_length, nbins=nbins)
        ks, ms = k, m
        for s, row in zip(chunk, np.asarray(p_rows)):
            done[s] = row
        pending += len(chunk)
        if checkpoint_path is not None and pending >= int(checkpoint_every):
            _write()
            pending = 0
    if checkpoint_path is not None and pending:
        _write()
    return ks, np.asarray([done[s] for s in seeds_list]), ms


def ensemble_power(fields, spacing, nbins=32, mesh=None):
    """Per-seed binned P(k) of a (nseeds, nx, ny, nz) batch, one
    ``calculate_power`` a row: host float64 ``(k_mean, p_hat[nseeds,
    nbins], n_modes)``."""
    ks = ms = None
    ps = []
    for i in range(fields.shape[0]):
        k, p, m = _stats.calculate_power(fields[i], spacing, nbins, mesh=mesh)
        ks, ms = k, m
        ps.append(p)
    return ks, np.asarray(ps), ms


def power_covariance(p_hat):
    """(nbins, nbins) float64 sample covariance of binned P(k) rows across
    seeds; bins with a NaN anywhere get NaN."""
    p = np.asarray(p_hat, np.float64)
    valid = np.all(np.isfinite(p), axis=0)
    cov = np.full((p.shape[1], p.shape[1]), np.nan)
    cov[np.ix_(valid, valid)] = np.cov(p[:, valid], rowvar=False)
    return cov


def _bin_index(km, shape, spacing, nbins):
    """(bin index, valid, multiplicity) of each mode, the estimator's edge
    search on the float32 |k|."""
    edges, mult = _stats.bin_setup(shape, spacing, nbins)
    edges_t = torch.as_tensor(edges, dtype=torch.float32, device=km.device)
    idx = torch.searchsorted(edges_t, km.contiguous()) - 1
    valid = (idx >= 0) & (idx < nbins) & (km > 0)
    mult3 = torch.broadcast_to(torch.as_tensor(mult, dtype=torch.float64,
                                               device=km.device), km.shape)
    return torch.where(valid, idx, nbins), valid, mult3


def _bin_sum(idx, valid, weights, nbins):
    return _binning.line_sums(idx, torch.where(valid, weights, 0.0),
                              nbins + 1)[:nbins]


def predicted_power_covariance(power, shape, spacing, nbins=32,
                               smoothing_length=0.0, interpolation="log10k",
                               device="cuda"):
    """The exact Gaussian covariance of the binned P(k) estimator: diagonal,
    Var[P_bin] = [sum_paired 4 P_k^2 + sum_selfconj 2 P_k^2] / (sum_k
    mult_k)^2 over the grid's modes; empty bins NaN.  float64 on
    ``device``; returns a host (nbins, nbins) array."""
    shape = tuple(int(s) for s in shape)
    spacing = float(spacing)
    nbins = int(nbins)
    km, pg = _power.grid_power(power, shape, spacing, interpolation, device)
    pg = pg.to(torch.float64)
    if smoothing_length:  # in float64, as the JAX package applies it here
        pg = pg * torch.exp(-((km.to(torch.float64)
                               * float(smoothing_length)) ** 2))
    idx, valid, mult3 = _bin_index(km, shape, spacing, nbins)
    var_k = torch.where(mult3 == 2.0, 4.0 * pg ** 2, 2.0 * pg ** 2)
    counts = _bin_sum(idx, valid, mult3, nbins)
    vsum = _bin_sum(idx, valid, var_k, nbins)
    var = torch.where(counts > 0, vsum / counts ** 2, float("nan"))
    return np.diag(var.cpu().numpy())


def predicted_multipole_covariance(pgrid, shape, spacing, nbins=32,
                                   ells=(0, 2, 4), los_axis=2):
    """The exact Gaussian covariance blocks of binned P_ell(k): for a field
    whose per-mode expectation is ``pgrid``, Cov[P_l(a), P_l'(a)] =
    sum_{k in a} w_l w_l' v_k / N_a^2 with w_l = (2l + 1) L_l(mu), v_k =
    4 P_k^2 (paired) or 2 P_k^2 (self-conjugate); bins do not covary.
    float64 on the grid's device; returns a host (nbins, nells, nells)
    array, empty bins NaN."""
    shape = tuple(int(s) for s in shape)
    spacing = float(spacing)
    nbins = int(nbins)
    ells = _stats.check_ells(ells, "under Hermitian symmetry")
    p = torch.as_tensor(pgrid).to(torch.float64)
    dev = p.device
    km32 = _grid.kmag(shape, spacing, torch.float32, dev)
    km = km32.to(torch.float64)
    k_los = _grid.kvectors(shape, spacing, torch.float32, dev)[int(los_axis)]
    bcast = [1, 1, 1]
    bcast[int(los_axis)] = -1
    k_los = k_los.to(torch.float64).reshape(bcast)
    mu2 = torch.where(km > 0, (k_los / torch.where(km > 0, km, 1.0)) ** 2, 0.0)
    mu2 = torch.broadcast_to(mu2, p.shape).to(torch.float32)
    idx, valid, mult3 = _bin_index(km32, shape, spacing, nbins)
    var_k = torch.where(mult3 == 2.0, 4.0 * p ** 2, 2.0 * p ** 2)
    counts = _bin_sum(idx, valid, mult3, nbins)
    one = torch.ones_like(mu2)
    w = [_binning.legendre_weighted(e, mu2, one).to(torch.float64)
         for e in ells]
    ne = len(ells)
    cov = np.full((nbins, ne, ne), np.nan)
    good = counts > 0
    for i in range(ne):
        for j in range(i, ne):
            s = _bin_sum(idx, valid, w[i] * w[j] * var_k, nbins)
            cij = torch.where(good, s / counts ** 2, float("nan")).cpu().numpy()
            cov[:, i, j] = cij
            cov[:, j, i] = cij
    return cov


def sigma_r_from_field(delta, spacing, r=8.0):
    """Realized sigma(R) of a field: the rms of the field top-hat smoothed
    on scale R, sum |c_k W(kR)|^2 mult / V^2 over its spectrum
    (:func:`..ops.transform.rfftn` on its device); a host float."""
    delta = torch.as_tensor(delta)
    shape = tuple(int(s) for s in delta.shape[-3:])
    spacing = float(spacing)
    r = float(r)
    re, im = _transform.rfftn(delta)
    a3 = float(np.float32(spacing ** 3))
    volume = shape[0] * shape[1] * shape[2] * spacing ** 3
    _, mult = _stats.bin_setup(shape, spacing, 1)
    mult_t = torch.as_tensor(mult, device=delta.device)
    total = torch.zeros((), dtype=torch.float64, device=delta.device)
    for x0 in range(0, shape[0], 16):
        x1 = min(shape[0], x0 + 16)
        km = _grid.kmag(shape, spacing, torch.float32, delta.device, x0,
                        x1 - x0)
        x = km * r
        w = torch.where(x > 1e-4, 3.0 * (torch.sin(x) - x * torch.cos(x))
                        / torch.where(x > 0, x, 1.0) ** 3,
                        1.0 - x * x / 10.0)
        cre, cim = re[x0:x1] * a3, im[x0:x1] * a3
        p = (cre * cre + cim * cim) * w * w * mult_t
        total += p.sum(dtype=torch.float64)
    return float(torch.sqrt(total / volume ** 2))
