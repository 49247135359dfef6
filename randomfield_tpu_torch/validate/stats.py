"""Field statistics: the binning core of every estimator, and the estimators.

Port of the single-device ``randomfield_tpu/validate/stats.py`` with its
names, arguments, bins, masks and returns.  The reference is one module of
2,468 lines; here this module keeps the binning core and the public names,
and the estimators live by topic beside it:

* :mod:`.fourier`: ``calculate_power`` (with ``window=`` and
  ``interlaced_with=``), ``calculate_power_multipoles``,
  ``calculate_power_wedges``, ``calculate_cross_power``,
  ``calculate_masked_power``, ``predicted_masked_power``,
  ``calculate_power_1d`` and ``predicted_power_1d``;
* :mod:`.correlation`: xi, xi_ell and w_p, measured and predicted;
* :mod:`.onepoint`: ``field_moments``, ``field_pdf``, ``cell_variance``
  and ``predicted_cell_variance``.

Every Fourier-space binning goes through :func:`..ops.binning.bin_spectrum`
(KB on CUDA tensors, its plain version on the CPU): it places a mode by the
same float32 |k| (:func:`.ops.grid.kmag`, the |k| of the JAX estimator's
``calculate_power``) against the same float32 edges as the binned sampler
K5, so a seed's ``sample_power``, ``spectrum_power`` of its spectrum and
``calculate_power`` of its field count the same modes in every bin.  (The
JAX package builds |k| three ways, squaring kx before or after rounding it
to float32; the ways differ by an ulp, which moves whole lattice shells of
one |k|^2 that lie on an edge.)  The sums differ from the JAX package's on
purpose: it contracts float32 values against a one-hot matrix on the MXU
(``_dot_bin``), the port adds them in float64.  The real-space binnings
(xi, w_p) keep :func:`masked_bins` in plain PyTorch, float64 sums by
:func:`..ops.binning.line_sums`.

Results come back as host float64 numpy arrays.  With ``mesh=`` (a slab
mesh) a field is this rank's (nx/P, ny, nz) x slab: the Fourier estimators
run the distributed forward transform and bin the rank's ky rows, xi runs
both distributed transforms and bins the rank's x rows, and one
all-reduce of the float64 sums gives every rank the whole field's result.
A pencil mesh, and the estimators whose mesh versions are still to come,
raise NotImplementedError naming the ROADMAP item.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from randomfield_tpu_torch.ops import binning as _binning
from randomfield_tpu_torch.ops import grid as _grid
from randomfield_tpu_torch.ops import transform as _transform

_TOPICS = {
    "fourier": ("calculate_power", "calculate_power_multipoles",
                "calculate_power_wedges", "calculate_cross_power",
                "calculate_masked_power", "predicted_masked_power",
                "calculate_power_1d", "predicted_power_1d"),
    "correlation": ("calculate_correlation", "predicted_correlation",
                    "calculate_correlation_multipoles",
                    "predicted_correlation_multipoles",
                    "calculate_projected_correlation",
                    "predicted_projected_correlation"),
    "onepoint": ("field_moments", "field_pdf", "cell_variance",
                 "predicted_cell_variance"),
}
_HOME = {name: topic for topic, names in _TOPICS.items() for name in names}

__all__ = ["spectrum_power", "spectrum_sums", "bin_power_grid",
           "bin_power_multipoles_grid", "bin_power_wedges_grid", "bin_setup",
           "plane_bins", "masked_bins", "bins_to_host", "poles_to_host",
           "wedges_to_host", "mesh_not_ported", "slab_mesh", "mesh_shape",
           "ky_offset", "mesh_sum", "device_of", *_HOME]

LEGENDRE_ELLS = (0, 2, 4)


def __getattr__(name):
    """The estimators of the topic modules, as names of this module."""
    topic = _HOME.get(name)
    if topic is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"randomfield_tpu_torch.validate.{topic}")
    return getattr(module, name)


def mesh_not_ported(what, mesh):
    """The NotImplementedError of an estimator called with a mesh it has no
    version for: the slab mesh's item 8b, the pencil mesh's item 5."""
    from randomfield_tpu_torch.parallel import mesh as _mesh

    pencil = isinstance(mesh, _mesh.PencilMesh)
    return NotImplementedError(
        f"{what} with mesh= is not ported to randomfield_tpu_torch yet: the "
        f"{'pencil' if pencil else 'slab'}-mesh estimators (ROADMAP.md, "
        f"Queue 1 item {5 if pencil else '8b'})")


def slab_mesh(what, mesh):
    """``mesh`` as the slab mesh an estimator runs on (None for one
    device): NotImplementedError for a pencil mesh (:func:`mesh_not_ported`),
    TypeError for anything else."""
    from randomfield_tpu_torch.parallel import mesh as _mesh

    if mesh is None:
        return None
    if isinstance(mesh, _mesh.PencilMesh):
        raise mesh_not_ported(what, mesh)
    return _mesh.require_slab(mesh)


def mesh_shape(field, mesh):
    """The whole grid's (nx, ny, nz) of a field, or of this rank's x slab
    of it on a slab mesh."""
    nx, ny, nz = (int(n) for n in field.shape[-3:])
    return (nx * (1 if mesh is None else mesh.size), ny, nz)


def ky_offset(shape, mesh):
    """This rank's first ky row (0 on one device)."""
    return 0 if mesh is None else mesh.rows(shape[1])[0]


def mesh_sum(acc, mesh):
    """``acc`` summed over the ranks of ``mesh`` in place (itself on one
    device)."""
    return acc if mesh is None else mesh.all_reduce_sum(acc)


def device_of(x, device=None):
    """The device an estimator of ``x`` runs on: ``device`` when given, a
    tensor's own, and the card for anything else (a numpy array)."""
    if device is not None:
        return torch.device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    return torch.device("cuda")


def check_ells(ells, why="for an autocorrelation"):
    """``ells`` as a tuple of ints, each of 0, 2, 4 (ValueError else)."""
    ells = tuple(int(e) for e in ells)
    for e in ells:
        if e not in LEGENDRE_ELLS:
            raise ValueError(f"ell={e} unsupported: even multipoles 0/2/4 "
                             f"only (odd ones vanish {why})")
    return ells


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
    zero weights are masked.  The real-space binnings (xi by |r|) and the
    plane part of K5's plain version use it; spectra go through KB.  The
    sums are :func:`..ops.binning.line_sums` (float64).
    """
    idx = torch.searchsorted(edges, km.contiguous()) - 1
    wb = torch.broadcast_to(w, km.shape)
    valid = (idx >= 0) & (idx < nbins) & (km > 0) & (wb > 0)
    idx = torch.where(valid, idx, nbins)
    wv = torch.where(valid, wb, 0.0).to(torch.float64)
    pv = torch.where(valid, torch.broadcast_to(p, km.shape), 0.0)
    n = out.shape[-1]
    out[0] += _binning.line_sums(idx, wv, n)
    out[1] += _binning.line_sums(idx, wv * pv.to(torch.float64), n)
    out[2] += _binning.line_sums(idx, wv * km.to(torch.float64), n)
    return out


def bins_to_host(acc, nbins):
    """(k_mean, p_hat, n_modes) host float64 from a (3, >= nbins) sum block;
    empty bins give NaN."""
    counts, psum, ksum = acc[:, :nbins].to(torch.float64).cpu().numpy()
    with np.errstate(invalid="ignore", divide="ignore"):
        return ksum / counts, psum / counts, counts


def poles_to_host(acc, nbins):
    """(k_mean, p_ell (n_ells, nbins), n_modes) from KB's (n_ells, 3,
    nbins + 1) multipole sums."""
    a = acc[:, :, :nbins].cpu().numpy()
    counts, ksum = a[0, 0], a[0, 2]
    with np.errstate(invalid="ignore", divide="ignore"):
        return ksum / counts, a[:, 1] / counts, counts


def wedges_to_host(acc, nbins, nmu):
    """(k_mean (nbins,), p (nbins, nmu), n_modes (nbins, nmu)) from KB's
    (1, 3, nbins nmu + 1) wedge sums; k_mean over each shell's wedges."""
    a = acc[0, :, :nbins * nmu].cpu().numpy().reshape(3, nbins, nmu)
    counts, psum, ksum = a
    with np.errstate(invalid="ignore", divide="ignore"):
        return ksum.sum(axis=1) / counts.sum(axis=1), psum / counts, counts


def spectrum_sums(cre, cim, shape, spacing, nbins, y_off=0):
    """float64 (3, nbins + 1) sums of |c|^2 V over a packed 'xyz' spectrum
    or its ky rows [y_off, y_off + ny_loc) (a slab mesh's shard): KB."""
    return _binned_sums(cre, cim, shape, spacing, nbins, y_off,
                        float(np.float32(shape[0] * shape[1] * shape[2]
                                         * float(spacing) ** 3)))


def _binned_sums(cre, cim, shape, spacing, nbins, y_off, factor):
    """float64 (3, nbins + 1) sums of |c|^2 factor over the ky rows
    [y_off, y_off + ny_loc) of a packed 'xyz' spectrum (KB 'auto')."""
    edges, _ = bin_setup(shape, spacing, nbins)
    return _binning.bin_spectrum("auto", (cre, cim), shape, spacing, edges,
                                 y_off=y_off, factor=factor)[0]


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
    float64 ``(k_mean, p_hat, n_modes)`` like ``calculate_power``.
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


def _grid_sums(pgrid, shape, spacing, nbins, **out):
    """KB 'grid' sums of a per-mode float32 half-grid (float64 grids are
    rounded to float32, as the JAX package holds them)."""
    shape = tuple(int(s) for s in shape)
    p = torch.as_tensor(pgrid)
    p = p.to(torch.float32) if p.dtype != torch.float32 else p
    edges, _ = bin_setup(shape, float(spacing), int(nbins))
    return _binning.bin_spectrum("grid", (p,), shape, float(spacing), edges,
                                 **out)


def bin_power_grid(pgrid, shape, spacing, nbins=32):
    """Shell-average a per-mode power half-grid into the estimator's bins.

    The bins, multiplicities and masks of ``calculate_power``, so a theory
    grid and a measured spectrum compare bin for bin.  Returns
    ``(k_mean, p_mean, n_modes)``.
    """
    return bins_to_host(_grid_sums(pgrid, shape, spacing, nbins)[0],
                        int(nbins))


def bin_power_multipoles_grid(pgrid, shape, spacing, nbins=32,
                              ells=(0, 2, 4), los_axis=2):
    """Multipole-average a per-mode power half-grid into estimator bins:
    the Legendre weights, bins, multiplicities and masks of
    ``calculate_power_multipoles``.  Returns ``(k_mean, p_ell, n_modes)``
    with ``p_ell`` shaped ``(len(ells), nbins)``."""
    ells = check_ells(ells, "under Hermitian symmetry")
    acc = _grid_sums(pgrid, shape, spacing, nbins, ells=ells,
                     los_axis=int(los_axis))
    return poles_to_host(acc, int(nbins))


def bin_power_wedges_grid(pgrid, shape, spacing, nbins=32, nmu=4,
                          los_axis=2):
    """Wedge-average a per-mode power half-grid into estimator bins: the
    joint (|k|, |mu|) bins, multiplicities and masks of
    ``calculate_power_wedges``.  Returns ``(k_mean, p, n_modes)`` with
    ``p`` and ``n_modes`` shaped ``(nbins, nmu)``."""
    acc = _grid_sums(pgrid, shape, spacing, nbins, nmu=int(nmu),
                     los_axis=int(los_axis))
    return wedges_to_host(acc, int(nbins), int(nmu))
