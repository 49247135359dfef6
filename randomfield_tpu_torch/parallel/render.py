"""Sharded renders on a slab mesh: every sampler, the fixed, derived and
2LPT fields, and the binned spectrum.

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
* ``sampler='nested'`` (``_sampled_spectrum(nested=True)``): KN over the
  rank's ky rows (:func:`..ops.sampler.sample_nested` with a ky block),
  the same way;
* the fixed and paired fields (``_sampled_spectrum(fixed, flip)``,
  :func:`fixed_spectrum`): K2F's fixed mode over the rank's ky rows, or
  KN's for a nested scene;

then the distributed inverse (:func:`.dfft.irfftn_slab_reim`) turns the
rank's spectrum into its x slab of the field.
:func:`spectrum_bins` is ``make_sharded_spectrum_bins``: a Threefry
``sample_power`` binned shard by shard and summed with one all-reduce.
:func:`..ops.derived.fields_from_spectrum` with a mesh is
``make_sharded_derived``: KD over the rank's ky rows at their global k,
then the distributed inverse with unit weights;
:func:`displacement_2lpt` is ``make_sharded_displacement_2lpt``: six tidal
renders of the sampled spectrum, the pointwise second-order source on the
rank's x slab (every rank holds the same x rows of the six, so nothing is
exchanged), the distributed forward transform and three gradient
inverses.

The JAX package's mesh programs for the fixed and derived fields draw the
positional Threefry stream whatever the scene's sampler, so a nested
scene's mesh fields there are not its one-device fields (ROADMAP.md,
Queue 3).  Here a nested scene draws the nested stream on a mesh too, so
its mesh fields equal its one-device fields.
"""

from __future__ import annotations

from randomfield_tpu_torch.ops import derived as _derived
from randomfield_tpu_torch.ops import sampler as _sampler
from randomfield_tpu_torch.parallel import dfft as _dfft
from randomfield_tpu_torch.validate import stats as _stats

__all__ = ["threefry_spectrum", "pallas_spectrum", "nested_spectrum",
           "fixed_spectrum", "spectrum_bins", "displacement_2lpt"]


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


def nested_spectrum(seed, table, shape, spacing, smoothing_length, mesh):
    """This rank's (nx, ny/P, nzh) ky slab of the seed's
    ``sampler='nested'`` spectrum, as float32 (re, im): KN on the shard."""
    y_off, ny_loc = mesh.rows(shape[1])
    spec = _sampler.sample_nested(seed, table, shape, spacing,
                                  smoothing_length, y_off=y_off,
                                  ny_loc=ny_loc)
    return spec[0], spec[1]


def fixed_spectrum(seed, table, shape, spacing, smoothing_length, flip, mesh,
                   nested=False):
    """This rank's ky slab of the seed's fixed spectrum (|c| = sigma times
    the filter, the seed's Hermitian phases; ``flip`` the paired one), as
    float32 (re, im): K2F's fixed mode on the shard, or KN's with
    ``nested``."""
    y_off, ny_loc = mesh.rows(shape[1])
    if nested:
        spec = _sampler.sample_nested(seed, table, shape, spacing,
                                      smoothing_length, mode="fixed",
                                      flip=flip, y_off=y_off, ny_loc=ny_loc)
    else:
        spec = _sampler.draw_fixed(seed, table, shape, spacing,
                                   smoothing_length, flip, y_off, ny_loc)
    return spec[0], spec[1]


def displacement_2lpt(re, im, shape, spacing, mesh, comps=(0, 1, 2)):
    """The 2LPT correction psi(2) of a sampled spectrum on a slab mesh: a
    list of this rank's float32 (nx/P, ny, nz) x slabs, one a component of
    ``comps``.

    The six tidal fields phi,ij of the spectrum (KD 'tidal' on
    Nyquist-zeroed vectors, diagonals included), S2 = sum_{i<j} [phi,ii
    phi,jj - phi,ij^2] on the rank's x slab, its distributed forward
    transform (K6, forward K3 twice and one exchange), then psi(2)_k =
    (3/7) i k S2_k / (N k^2) through KD 'grad' and the distributed
    inverse.  ``re``/``im`` are consumed."""
    d00, d11, d22, d01, d02, d12 = _derived.fields_from_spectrum(
        re, im, shape, spacing, "tidal", range(6), 1.0, True, mesh)
    s2 = (d00 * d11 + d00 * d22 + d11 * d22
          - d01 * d01 - d02 * d02 - d12 * d12)
    del d00, d11, d22, d01, d02, d12
    sre, sim = _dfft.rfftn_slab(s2, shape, mesh)
    del s2
    inv_n = 1.0 / (shape[0] * shape[1] * shape[2])
    return _derived.fields_from_spectrum(sre, sim, shape, spacing, "grad",
                                         list(comps), (3.0 / 7.0) * inv_n,
                                         mesh=mesh)


def spectrum_bins(spectrum, shape, spacing, nbins, mesh):
    """float64 (3, nbins + 1) sums of |c|^2 V over a ky-slab spectrum
    (:func:`..validate.stats.spectrum_sums` of the rank's rows), summed
    over the ranks: every rank returns the whole grid's sums."""
    y_off, _ = mesh.rows(shape[1])
    out = _stats.spectrum_sums(*spectrum, shape, spacing, nbins, y_off)
    return mesh.all_reduce_sum(out)
