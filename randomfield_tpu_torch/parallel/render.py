"""Sharded renders on a slab mesh: both samplers, and the binned spectrum.

Port of the slab paths of ``randomfield_tpu/parallel/render.py``.  Every
rank draws only its ky rows of the spectrum, at the counters they have in
the whole grid, so a mesh render equals the single-device render of the
same seed on any number of ranks:

* ``sampler='threefry'`` (``_sampled_spectrum_reim``,
  ``make_sharded_render``): K7 over the rank's ky rows
  (:func:`..ops.sampler.draw_scale_shard`), which draws the canonical
  Threefry stream, makes the kz = 0 / Nyquist planes Hermitian and scales
  in one pass.  A plane mode whose conjugate partner lies on another rank
  draws the partner's counter itself, so this sampler exchanges nothing;
* ``sampler='pallas'`` (``make_sharded_render_pallas``): K8 over the rank's
  ky rows (:func:`..ops.sampler.sample_shard`), which draws, fixes the
  planes and scales in one pass the same way, so this sampler exchanges
  nothing either (:func:`..ops.transform.symmetrize_slab_reim`, the
  gathered fix the JAX mesh lowers to collectives, stays as the plain
  version it is checked against);

then the distributed inverse (:func:`.dfft.irfftn_slab_reim`) turns the
rank's spectrum into its x slab of the field.
:func:`spectrum_bins` is ``make_sharded_spectrum_bins``: a Threefry
``sample_power`` binned shard by shard and summed with one all-reduce.
"""

from __future__ import annotations

from randomfield_tpu_torch.ops import sampler as _sampler
from randomfield_tpu_torch.validate import stats as _stats

__all__ = ["threefry_spectrum", "pallas_spectrum", "spectrum_bins"]


def threefry_spectrum(seed, table, shape, spacing, smoothing_length, mesh):
    """This rank's (nx, ny/P, nzh) ky slab of the seed's Threefry spectrum,
    as float32 (re, im)."""
    y_off, ny_loc = mesh.rows(shape[1])
    re, im = _sampler.draw_scale_shard(seed, table, shape, spacing,
                                       smoothing_length, y_off, ny_loc)
    return re, im


def pallas_spectrum(seed, table, shape, spacing, smoothing_length, mesh):
    """This rank's (nx, ny/P, nzh) ky slab of the seed's
    ``sampler='pallas'`` spectrum, as float32 (re, im), with no exchange."""
    y_off, ny_loc = mesh.rows(shape[1])
    return _sampler.sample_shard(seed, table, shape, spacing,
                                 smoothing_length, y_off, ny_loc)


def spectrum_bins(spectrum, shape, spacing, nbins, mesh):
    """float64 (3, nbins + 1) sums of |c|^2 V over a ky-slab spectrum
    (:func:`..validate.stats.spectrum_sums` of the rank's rows), summed
    over the ranks: every rank returns the whole grid's sums."""
    y_off, _ = mesh.rows(shape[1])
    out = _stats.spectrum_sums(*spectrum, shape, spacing, nbins, y_off)
    return mesh.all_reduce_sum(out)
