"""The staged render and its variants: v5 (default), v4 and v6.

Counterpart of the re/im-native part of ``randomfield_tpu/engine/staged.py``
(``render_v3``, ``_select_build``, ``render_v3_batch``,
``render_v3_threefry``).  A single-device ``sampler='pallas'`` render runs
one of three stage lists, chosen by ``RF_STAGED_PIPELINE`` exactly as in the
JAX package; the port works in the 'xyz' layout (nx, ny, nzh):

* default, v5: K1 :func:`~..ops.sampler.sample_modes` (which makes the
  kz = 0 / Nyquist planes Hermitian in the same pass) -> K3
  :func:`~..ops.fft.ifft_axis` along x, then y, in place -> K4
  :func:`~..ops.fft.c2r_tail`.
* ``v4``: K1 -> K9 :func:`~..ops.fft.ifft_rotate` on the
  view (1 group, n = nx, cols = ny nzh), which gives (ny nzh, nx); read as
  (1 group, n = ny, cols = nzh nx) -> K9 -> (nzh, nx, ny); one plain
  reordering copy to (nx, ny, nzh) -> K4.  No transform works on a
  non-minor axis in place; each pass writes its transformed axis minor.
  The same stream as v5: the field is the default field of the seed.
* ``v6``: :func:`~..ops.genfft.plane_spectra` -> K10
  :func:`~..ops.genfft.sample_fftx`, which draws every x-line and
  transforms it before it reaches device memory, giving (nzh, ny, nx) with
  x done -> K3 along y -> one plain reordering copy to (nx, ny, nzh) ->
  K4.  Its own realization family (:data:`..ops.genfft.STREAM`): the same
  seed gives another field than v4/v5, deterministic all the same.

Any other value of the switch (``v3`` included: the port has one tail, K4)
is the default.  A variant whose ``can_v*`` rule refuses the grid falls to
the default as well.

:func:`render_v3_batch` renders a seed batch into one preallocated stack,
K4 writing each field into its row, with no host synchronization between
the seeds; :func:`render_v3_threefry` is the Threefry scene's staged render
(the canonical draws fused into K2 -> the default transforms), the same
field as the Generator's default path.

Not ported: the JAX package's chunked v1/v2/v3 variants,
``RF_STAGED_V3_MERGE``, its ``optimization_barrier`` pins and the
auto-staging threshold, which manage a memory ceiling this device does not
have (ROADMAP.md, Queue 1 item 9).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from randomfield_tpu_torch.ops import fft as _fft
from randomfield_tpu_torch.ops import genfft as _genfft
from randomfield_tpu_torch.ops import sampler as _sampler
from randomfield_tpu_torch.ops import transform as _transform

__all__ = [
    "VARIANTS",
    "can_v4",
    "can_v5",
    "can_v6",
    "selected_variant",
    "variant_stages",
    "finish_staged_reim",
    "scaled_draws",
    "render_v3",
    "render_v3_batch",
    "render_v3_threefry",
    "can_batch_staged",
]

VARIANTS = ("v5", "v4", "v6")
PIPELINE_ENV = "RF_STAGED_PIPELINE"
_INV_SQRT2 = float(np.float32(0.7071067811865476))


def can_v5(shape) -> bool:
    """The grids K3 and K4 take on CUDA: nx, ny and nz/2 powers of two in
    [16, 2048] (:func:`..ops.fft.kernel_length_ok`), nz even."""
    nx, ny, nz = shape
    return (_fft.kernel_length_ok(nx) and _fft.kernel_length_ok(ny)
            and nz % 2 == 0 and _fft.kernel_length_ok(nz // 2))


def can_v4(shape) -> bool:
    """v4's grids: v5's (K9 takes the lengths K3 takes and any column
    count; the TPU kernel's multiple-of-128 column rule has no
    counterpart)."""
    return can_v5(shape)


def can_v6(shape) -> bool:
    """v6's grids: v5's and K10's (:func:`..ops.genfft.can_genfft`)."""
    return can_v5(shape) and _genfft.can_genfft(shape)


def selected_variant(shape) -> str:
    """The variant ``RF_STAGED_PIPELINE`` selects for ``shape``: 'v4' or
    'v6' when asked for and the grid allows it, else 'v5'."""
    env = os.environ.get(PIPELINE_ENV, "")
    if env == "v4" and can_v4(shape):
        return "v4"
    if env == "v6" and can_v6(shape):
        return "v6"
    return "v5"


def _to_xyz(t, dims, order):
    """The plain reordering copy: ``t`` viewed as ``dims``, permuted by
    ``order`` into a new contiguous (nx, ny, nzh) tensor."""
    return t.view(dims).permute(order).contiguous()


def variant_stages(variant, seed, table, shape, spacing, weights,
                   smoothing_length=0.0, out=None):
    """The calls of one render of ``variant``, in order, by name.

    Returns ``{name: stage}``; each ``stage(prev)`` takes the stage
    before's result (the first takes None) and the last returns the
    (nx, ny, nz) field (written into ``out`` when given).
    :func:`render_v3` runs exactly these, so whoever times or checks a
    stage reads the render's own calls.
    """
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    if variant not in VARIANTS:
        raise ValueError(f"unknown staged variant {variant!r}")

    def tail(ri):
        return _fft.c2r_tail(*ri, nz, weights, out=out)

    if variant == "v6":
        return {
            "plane_spectra (plain)": lambda _: _genfft.plane_spectra(
                seed, table, shape, spacing, smoothing_length),
            "K10 sample_fftx": lambda planes: _genfft.sample_fftx(
                seed, table, shape, spacing, smoothing_length, planes=planes),
            "K3 fft_axis y pass": lambda ri: _fft.ifft_axis(*ri, nzh, ny, nx),
            "reorder (nzh, ny, nx) -> (nx, ny, nzh) (plain copy)":
                lambda ri: tuple(_to_xyz(t, (nzh, ny, nx), (2, 1, 0))
                                 for t in ri),
            "K4 c2r_tail": tail,
        }
    stages = {
        "K1 sample_modes (draw, Hermitian fix, scale)":
            lambda _: _sampler.sample_modes(seed, table, shape, spacing,
                                            smoothing_length),
    }
    if variant == "v4":
        stages["K9 ifft_rotate x pass"] = lambda ri: _fft.ifft_rotate(
            *ri, 1, nx, ny * nzh)
        stages["K9 ifft_rotate y pass"] = lambda ri: _fft.ifft_rotate(
            *ri, 1, ny, nzh * nx)
        stages["reorder (nzh, nx, ny) -> (nx, ny, nzh) (plain copy)"] = (
            lambda ri: tuple(_to_xyz(t, (nzh, nx, ny), (1, 2, 0)) for t in ri))
    else:
        stages["K3 fft_axis x pass"] = lambda ri: _fft.ifft_axis(
            *ri, 1, nx, ny * nzh)
        stages["K3 fft_axis y pass"] = lambda ri: _fft.ifft_axis(
            *ri, nx, ny, nzh)
    stages["K4 c2r_tail"] = tail
    return stages


def _run(stages):
    prev = None
    for stage in stages.values():
        prev = stage(prev)
    return prev


def finish_staged_reim(re, im, weights, shape, out=None):
    """Spectrum -> field by the default transforms: K3 along x, K3 along y
    (both in place: the (nx, ny, nzh) lattices are consumed), K4."""
    return _transform.irfftn_reim(re, im, shape, weights, out)


def scaled_draws(re, im, table, shape, spacing, smoothing_length=0.0):
    """Unit draws the caller supplies -> spectrum, in place: the Hermitian
    fix, then K2 with the draws' 1/sqrt(2) folded into its amplitude
    (``generate_from_noise``; a seeded render fuses all three,
    :func:`..ops.sampler.draw_scale`)."""
    _transform.symmetrize_with_shape_reim(re, im, shape[2])
    return _sampler.scale_sigma(re, im, table, shape, spacing,
                                smoothing_length, gain=_INV_SQRT2)


def render_v3(seed, table, shape, spacing, weights, smoothing_length=0.0,
              out=None):
    """The staged render of a ``sampler='pallas'`` scene on one device.

    ``table``: the scene's :class:`~..ops.sampler.SigmaTable`, whose device
    the render runs on; ``weights``: float32 (nz,) plane weights.  Returns
    the float32 (nx, ny, nz) field (``out`` when given).  The variant is
    :func:`selected_variant`'s: v4 and v5 draw one family (the same field),
    v6 its own.
    """
    shape = tuple(int(n) for n in shape)
    return _run(variant_stages(selected_variant(shape), seed, table, shape,
                               spacing, weights, smoothing_length, out))


def can_batch_staged(shape, batch, device="cpu") -> bool:
    """Whether a ``batch``-seed stack fits beside a render's working set:
    ``batch + 3`` fields (the stack, and about three field-sized buffers a
    render holds at its peak) against the memory ``device`` has free now,
    PyTorch's cached blocks included.  No limit on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return True
    nx, ny, nz = shape
    free, _ = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return (int(batch) + 3) * 4 * nx * ny * nz <= free + cached


def render_v3_batch(seeds, table, shape, spacing, weights,
                    smoothing_length=0.0):
    """A seed batch: a float32 (len(seeds), nx, ny, nz) stack whose row i
    is bit for bit :func:`render_v3` of ``seeds[i]``.

    The stack is allocated once and K4 writes each field into its row, so
    there is no per-seed copy, and nothing synchronizes the host with the
    device between seeds.  The caller checks :func:`can_batch_staged`.
    """
    shape = tuple(int(n) for n in shape)
    seeds = [int(s) for s in np.asarray(seeds).ravel()]
    stack = torch.empty((len(seeds), *shape), dtype=torch.float32,
                        device=table.knots.device)
    for row, seed in zip(stack, seeds):
        render_v3(seed, table, shape, spacing, weights, smoothing_length,
                  out=row)
    return stack


def render_v3_threefry(seed, table, shape, spacing, weights,
                       smoothing_length=0.0, out=None):
    """The staged render of a Threefry scene: the seed's canonical draws,
    Hermitian fix and K2 in one pass (:func:`..ops.sampler.draw_scale`) ->
    the default transforms.  One canonical stream: the same field as the
    Generator's default (``pipeline='auto'``) render."""
    shape = tuple(int(n) for n in shape)
    re, im = _sampler.draw_scale(seed, table, shape, spacing, smoothing_length)
    return finish_staged_reim(re, im, weights, shape, out)
