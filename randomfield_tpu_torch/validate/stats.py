"""Binned isotropic power spectra: the estimator, and the binning it shares.

Port of the single-device subset of ``randomfield_tpu/validate/stats.py``:
``_bin_setup``, ``_masked_bins``, ``_binned_spectrum_reim`` ('xyz' layout),
``spectrum_power``, ``bin_power_grid`` and ``calculate_power``, with the JAX
package's bins, masks and multiplicities.  Every binning here places a mode
by the same float32 |k| (:func:`.ops.grid.kmag`, the |k| of the JAX
estimator's ``calculate_power``) against the same float32 edges, and so
does the binned sampler K5: a seed's ``sample_power``, ``spectrum_power``
of its spectrum and ``calculate_power`` of its field count the same modes
in every bin.  (The JAX package builds |k| three ways, squaring kx before
or after rounding it to float32; the ways differ by an ulp, which moves
whole lattice shells of one |k|^2 that lie on an edge.)  The sums differ
from the JAX package's on purpose: it contracts float32 values against a
one-hot matrix, the port adds them in float64 (``index_add_``) on the
tensor's device.

The JAX package bins in XLA outside any Pallas kernel, so this is plain
PyTorch; the forward transform of :func:`calculate_power` is
``torch.fft.rfftn`` on one device and, on a slab mesh, the distributed
transform of the hand kernels (K6, then forward K3;
:func:`..parallel.dfft.rfftn_slab`), binned shard by shard and summed with
one all-reduce (``validate/stats.py:_make_sharded_binned``).  Results come
back as host float64 numpy arrays, the same on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from randomfield_tpu_torch.ops import grid as _grid
from randomfield_tpu_torch.ops import transform as _transform

__all__ = ["calculate_power", "spectrum_power", "spectrum_sums",
           "bin_power_grid", "bin_setup", "plane_bins", "masked_bins",
           "bins_to_host", "field_moments"]

# x planes binned per step: bounds the |k| / index temporaries at any size
_X_CHUNK = 16


def bin_setup(shape, spacing, nbins):
    """(edges, mult): nbins + 1 log-spaced float64 |k| edges over the grid's
    [0.999 k_min, 1.001 k_max], and the float32 Hermitian multiplicity of
    each kz column (1 on the kz = 0 and Nyquist planes, 2 elsewhere)."""
    kmin, kmax = _grid.get_k_bounds(shape, spacing)
    edges = np.logspace(np.log10(kmin * 0.999), np.log10(kmax * 1.001),
                        nbins + 1)
    nz = shape[2]
    mult = np.full(nz // 2 + 1, 2.0, np.float32)
    mult[0] = 1.0
    if nz % 2 == 0:
        mult[-1] = 1.0
    return edges, mult


def masked_bins(km, w, p, edges, nbins, out):
    """Add per-bin (sum w, sum w p, sum w |k|) of a block to ``out``.

    ``km``/``p``: float32 blocks; ``w`` broadcasts to them; ``edges``:
    float32 on the block's device; ``out``: float64 (3, nbins + 1), whose
    last column takes the masked modes.  The bin is the edge search of the
    JAX package (``searchsorted`` on the left); out-of-range |k|, DC and
    zero weights are masked.
    """
    idx = torch.searchsorted(edges, km.contiguous()) - 1
    wb = torch.broadcast_to(w, km.shape)
    valid = (idx >= 0) & (idx < nbins) & (km > 0) & (wb > 0)
    idx = torch.where(valid, idx, nbins).flatten()
    wv = torch.where(valid, wb, 0.0).flatten().to(torch.float64)
    out[0].index_add_(0, idx, wv)
    out[1].index_add_(0, idx, wv * p.flatten().to(torch.float64))
    out[2].index_add_(0, idx, wv * km.flatten().to(torch.float64))
    return out


def bins_to_host(acc, nbins):
    """(k_mean, p_hat, n_modes) host float64 from a (3, >= nbins) sum block;
    empty bins give NaN."""
    counts, psum, ksum = acc[:, :nbins].to(torch.float64).cpu().numpy()
    with np.errstate(invalid="ignore", divide="ignore"):
        return ksum / counts, psum / counts, counts


def spectrum_sums(cre, cim, shape, spacing, nbins, y_off=0):
    """float64 (3, nbins + 1) sums of |c|^2 V over a packed 'xyz' spectrum
    or its ky rows [y_off, y_off + ny_loc) (a slab mesh's shard),
    x-slab by x-slab."""
    return _binned_sums(cre, cim, shape, spacing, nbins, y_off,
                        float(np.float32(shape[0] * shape[1] * shape[2]
                                         * float(spacing) ** 3)))


def _binned_sums(cre, cim, shape, spacing, nbins, y_off, factor):
    """float64 (3, nbins + 1) sums of |c|^2 factor over the ky rows
    [y_off, y_off + ny_loc) of a packed 'xyz' spectrum."""
    nx = shape[0]
    ny_loc = cre.shape[1]
    dev = cre.device
    edges, mult = bin_setup(shape, spacing, nbins)
    edges_t = torch.as_tensor(edges, dtype=torch.float32, device=dev)
    mult_t = torch.as_tensor(mult, device=dev)
    out = torch.zeros((3, nbins + 1), dtype=torch.float64, device=dev)
    for x0 in range(0, nx, _X_CHUNK):
        x1 = min(nx, x0 + _X_CHUNK)
        km = _grid.kmag(shape, spacing, torch.float32, dev, x0, x1 - x0,
                        y_off, ny_loc)
        re, im = cre[x0:x1], cim[x0:x1]
        p = (re * re + im * im) * factor
        masked_bins(km, mult_t[None, None, :], p, edges_t, nbins, out)
    return out


def plane_bins(plane_re, plane_im, shape, spacing, nbins, edges=None):
    """float64 (3, nbins) sums of the self-conjugate kz planes' power.

    ``plane_re``/``plane_im``: float32 (nx, n_planes, ny) raw draws of the
    kz = 0 (and, for even nz, Nyquist) planes, as the plain binned sampler
    (:func:`..ops.sampler.power_bins_plain`) returns them.  Each plane is
    made Hermitian (self-conjugate modes times sqrt(2)) and binned with
    multiplicity 1, as ``engine/staged.py:_sample_power_v3`` does on the
    TPU; the plain version of K5, which does this in the kernel.  ``edges``:
    the nbins + 1 |k| edges, :func:`bin_setup`'s by default.
    """
    nx, ny, nz = shape
    dev = plane_re.device
    kx, ky, kz = _grid.kvectors(shape, spacing, torch.float32, dev)
    if edges is None:
        edges, _ = bin_setup(shape, spacing, nbins)
    edges_t = torch.as_tensor(edges, dtype=torch.float32, device=dev)
    volume = float(np.float32(nx * ny * nz * float(spacing) ** 3))
    one = torch.ones((), dtype=torch.float32, device=dev)
    kxy = (kx * kx)[:, None] + (ky * ky)[None, :]
    out = torch.zeros((3, nbins + 1), dtype=torch.float64, device=dev)
    for i, p in enumerate(_grid.self_conjugate_kz_planes(nz)):
        fre, fim = _transform.symmetrize_plane_reim(plane_re[:, i],
                                                    plane_im[:, i])
        km = torch.sqrt(kxy + kz[p] * kz[p])
        masked_bins(km, one, (fre * fre + fim * fim) * volume, edges_t, nbins,
                    out)
    return out[:, :nbins]


def spectrum_power(c, shape, spacing, nbins=32, layout="xyz"):
    """Realized binned P(k) straight from a packed sampled spectrum.

    ``c``: a complex (nx, ny, nz//2+1) tensor or an (re, im) pair of float32
    ones, the render's convention (P_hat = |c_k|^2 V); no FFT.  Returns host
    float64 ``(k_mean, p_hat, n_modes)`` like :func:`calculate_power`.
    """
    if layout != "xyz":
        raise NotImplementedError(
            f"layout {layout!r}: the port keeps spectra in 'xyz' order only")
    re, im = (c.real, c.imag) if isinstance(c, torch.Tensor) else c
    shape = tuple(int(s) for s in shape)
    want = (shape[0], shape[1], shape[2] // 2 + 1)
    if tuple(re.shape) != want or tuple(im.shape) != want:
        raise ValueError(f"spectrum must have shape {want}, got "
                         f"{tuple(re.shape)}")
    acc = spectrum_sums(re, im, shape, float(spacing), int(nbins))
    return bins_to_host(acc, int(nbins))


def bin_power_grid(pgrid, shape, spacing, nbins=32):
    """Shell-average a per-mode power half-grid into the estimator's bins.

    The bins, multiplicities and masks of :func:`calculate_power`, so a
    theory grid and a measured spectrum compare bin for bin.  Returns
    ``(k_mean, p_mean, n_modes)``.
    """
    shape = tuple(int(s) for s in shape)
    p = torch.as_tensor(pgrid)
    edges, mult = bin_setup(shape, float(spacing), int(nbins))
    dev = p.device
    edges_t = torch.as_tensor(edges, dtype=p.dtype, device=dev)
    mult_t = torch.as_tensor(mult, dtype=p.dtype, device=dev)
    out = torch.zeros((3, int(nbins) + 1), dtype=torch.float64, device=dev)
    for x0 in range(0, shape[0], _X_CHUNK):
        x1 = min(shape[0], x0 + _X_CHUNK)
        km = _grid.kmag(shape, float(spacing), p.dtype, dev, x0, x1 - x0)
        masked_bins(km, mult_t[None, None, :], p[x0:x1], edges_t, int(nbins),
                     out)
    return bins_to_host(out, int(nbins))


def calculate_power(delta, spacing, nbins=32, mesh=None, window=None,
                    interlaced_with=None):
    """Realized isotropic P(k) of a field, binned in log |k|.

    Returns host float64 ``(k_mean, p_hat, n_modes)``: per bin the
    mode-weighted mean |k|, the mean <|c_k|^2> / V with c_k = a^3 rfftn(delta),
    and the number of full-spectrum modes; empty bins give NaN.  Runs on
    ``delta``'s device.  With ``mesh`` (a :class:`..parallel.mesh.SlabMesh`)
    ``delta`` is this rank's (nx/P, ny, nz) x slab of the field: the
    distributed forward transform runs on the hand kernels, each rank bins
    its ky rows and one all-reduce sums them, so every rank returns the
    whole field's result.  ``window`` and ``interlaced_with`` are not
    ported yet and raise NotImplementedError.
    """
    if window is not None or interlaced_with is not None:
        raise NotImplementedError(
            "calculate_power(window=..., interlaced_with=...) is not ported "
            "to randomfield_tpu_torch yet: the catalog estimators "
            "(ROADMAP.md, Queue 1 item 6)")
    delta = torch.as_tensor(delta)
    if delta.dtype != torch.float32 or delta.ndim != 3:
        raise ValueError(f"delta must be one float32 (nx, ny, nz) field, got "
                         f"{delta.dtype} {tuple(delta.shape)}")
    spacing = float(spacing)
    nbins = int(nbins)
    a3 = float(np.float32(spacing ** 3))
    if mesh is None:
        shape = tuple(int(s) for s in delta.shape)
        c = torch.fft.rfftn(delta) * a3
        re, im, y_off = c.real, c.imag, 0
    else:
        from randomfield_tpu_torch.parallel import dfft as _dfft
        from randomfield_tpu_torch.parallel import mesh as _mesh

        mesh = _mesh.require_slab(mesh)
        shape = (delta.shape[0] * mesh.size, delta.shape[1], delta.shape[2])
        re, im = _dfft.rfftn_slab(delta, shape, mesh)
        re.mul_(a3)
        im.mul_(a3)
        y_off, _ = mesh.rows(shape[1])
    volume = float(np.float32(shape[0] * shape[1] * shape[2] * spacing ** 3))
    out = _binned_sums(re, im, shape, spacing, nbins, y_off, 1.0 / volume)
    if mesh is not None:
        mesh.all_reduce_sum(out)
    return bins_to_host(out, nbins)


def field_moments(delta, mesh=None):
    """(mean, variance) of a field as host floats.

    Two passes over x slabs of ``delta`` on its device, each slab summed in
    float64, so no float32 running sum saturates at any grid size (the
    reason of the JAX package's axiswise reductions).  One device only: a
    slab ``mesh`` raises NotImplementedError.
    """
    if mesh is not None:
        raise NotImplementedError(
            "field_moments of a mesh field is not ported to "
            "randomfield_tpu_torch yet: the mesh versions (ROADMAP.md, "
            "Queue 1 item 8)")
    delta = torch.as_tensor(delta)
    n = delta.numel()
    total = torch.zeros((), dtype=torch.float64, device=delta.device)
    for chunk in delta.split(_X_CHUNK):
        total += chunk.to(torch.float64).sum()
    mean = total / n
    total.zero_()
    for chunk in delta.split(_X_CHUNK):
        total += ((chunk.to(torch.float64) - mean) ** 2).sum()
    return float(mean), float(total / n)
