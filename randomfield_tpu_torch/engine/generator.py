"""The Generator scene/state API — render seeded Gaussian random fields.

Port of the core of ``randomfield_tpu/engine/generator.py`` for the default
``sampler='threefry'``.  The constructor does the scene setup once (power
table, uniform sigma(k) table, lightcone weights); each
``generate_delta_field(seed)`` then runs, on the scene's device:

1. the canonical Threefry unit draws (:mod:`.ops.sample`), bit for bit the
   JAX package's stream at the same seed, with the kz = 0 and Nyquist
   planes made Hermitian (:mod:`.ops.transform`);
2. K2, in place: sigma(|k|) * exp(-k^2 s^2 / 2) / sqrt(2), the last factor
   the draws' complex normalization (:func:`.ops.sampler.scale_sigma`);
3. K3, in place: inverse FFT along x, then along y (:func:`.ops.fft.ifft_axis`);
4. K4: c2r along kz times the plane weights D(z)/D(0), which writes the
   field (:func:`.ops.fft.c2r_tail`).

On CUDA the spectrum is two float32 lattices updated in place through
steps 1-3; a render's peak is those two lattices, the field and one
Threefry chunk's temporaries.  On the CPU every step runs its plain
PyTorch version.
"""

from __future__ import annotations

import numpy as np
import torch

from randomfield_tpu_torch.engine import scene as _scene
from randomfield_tpu_torch.models import cosmology as _cosmo
from randomfield_tpu_torch.models.powerspec import resolve_power
from randomfield_tpu_torch.ops import fft as _fft
from randomfield_tpu_torch.ops import sample as _sample
from randomfield_tpu_torch.ops import sampler as _sampler
from randomfield_tpu_torch.ops import threefry as _threefry
from randomfield_tpu_torch.ops import transform as _transform

__all__ = ["Generator"]

_INV_SQRT2 = float(np.float32(0.7071067811865476))

_NOT_PORTED = {
    "sampler='pallas'": "K1, the hardware-PRNG sampler (ROADMAP.md, Queue 2 K1)",
    "sampler='nested'": "the nested stream (ROADMAP.md, Queue 1 item 4)",
    "mesh": "torch.distributed meshes (ROADMAP.md, Queue 1 item 11)",
    "pipeline='staged'": ("the staged (x, kz, y) pipeline, not needed on an "
                          "80 GB card (ROADMAP.md, Queue 1 item 7)"),
}


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not ported to randomfield_tpu_torch yet: {_NOT_PORTED[what]}"
    )


class Generator:
    """Generate 3-D Gaussian random density fields with a given P(k).

    Parameters follow ``randomfield_tpu.Generator``:

    nx, ny, nz : grid dimensions; the z axis is the line of sight.
    grid_spacing : comoving grid spacing in Mpc/h.
    cosmology : a :class:`~randomfield_tpu_torch.models.cosmology.Cosmology`,
        a preset name ('Planck13'...), a dict of overrides, or None.
    power : tabulated P(k) — (k, Pk) in h/Mpc, (Mpc/h)^3 — a model name
        ('default', 'eh98', 'bbks'), or None for the default table.
    interpolation : 'log10k' (P linear in log10 k) or 'loglog'.
    z0 : redshift of the nearest lightcone plane.
    sampler : 'threefry' only, for now.
    mesh, pipeline : accepted for API parity; anything but None / 'auto' /
        'fused' raises NotImplementedError.
    device : where renders run, "cuda" by default.  On CUDA every axis the
        kernels transform must be a power of two: nx, ny and nz/2 in
        [16, 2048]; other shapes raise ValueError here.
    """

    def __init__(self, nx, ny, nz, grid_spacing, cosmology=None, power=None,
                 interpolation="log10k", z0=0.0, mesh=None, pipeline="auto",
                 sampler="threefry", device="cuda"):
        if sampler not in ("threefry", "pallas", "nested"):
            raise ValueError(f"unknown sampler {sampler!r}")
        if sampler != "threefry":
            raise _not_ported(f"sampler={sampler!r}")
        if mesh is not None:
            raise _not_ported("mesh")
        if pipeline == "staged":
            raise _not_ported("pipeline='staged'")
        if pipeline not in ("auto", "fused"):
            raise ValueError(f"unknown pipeline {pipeline!r}")
        self.device = torch.device(device)
        shape = (int(nx), int(ny), int(nz))
        if self.device.type == "cuda":
            _check_kernel_shape(shape)
        self.cosmology = _cosmo.create_cosmology(cosmology)
        self.scene = _scene.Scene(
            nx=shape[0], ny=shape[1], nz=shape[2],
            grid_spacing=float(grid_spacing), cosmology=self.cosmology,
            interpolation=interpolation, z0=float(z0),
        )
        self.state, self._aux = _scene.build_state(
            self.scene, resolve_power(power, self.cosmology), self.device
        )

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

    def predicted_variance(self, smoothing_length=0.0, apply_lightcone=False):
        """Expected variance of a rendered field, from the table sigma.

        The sum over packed modes of multiplicity * (sigma * filter)^2, with
        the float32 per-mode amplitudes the render applies, accumulated in
        float64 on the scene's device.  ``apply_lightcone=True`` predicts
        the default lightcone-weighted render: the plane mean of D^2 times
        the unweighted variance.
        """
        nx, ny, nz = self.shape
        nzh = nz // 2 + 1
        mult = torch.full((nzh,), 2.0, dtype=torch.float64, device=self.device)
        mult[0] = 1.0
        if nz % 2 == 0:
            mult[-1] = 1.0
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        step = 64  # x planes per pass: bounds the temporaries at any size
        for x0 in range(0, nx, step):
            amp = _sampler.sigma_amplitude(
                self.state.table, self.shape, self.grid_spacing,
                smoothing_length, x0, min(step, nx - x0),
            ).to(torch.float64)
            total += (amp * amp * mult).sum()
        out = float(total)
        if apply_lightcone:
            w = np.asarray(self.growth_function, np.float64)
            out *= float(np.mean(w * w))
        return out

    # ---- rendering -----------------------------------------------------------
    def _weights(self, apply_lightcone):
        w = self.state.lightcone_weights
        return w if apply_lightcone else torch.ones_like(w)

    def _render_reim(self, re, im, smoothing_length, apply_lightcone):
        """Unit draws (consumed in place) -> field: symmetrize, K2-K4."""
        nx, ny, nz = self.shape
        nzh = nz // 2 + 1
        _transform.symmetrize_with_shape_reim(re, im, nz)
        _sampler.scale_sigma(re, im, self.state.table, self.shape,
                             self.grid_spacing, smoothing_length,
                             gain=_INV_SQRT2)
        _fft.ifft_axis(re, im, 1, nx, ny * nzh)
        _fft.ifft_axis(re, im, nx, ny, nzh)
        return _fft.c2r_tail(re, im, nz, self._weights(apply_lightcone))

    def generate_delta_field(self, seed=0, smoothing_length=0.0,
                             apply_lightcone=True):
        """Render one realization: an (nx, ny, nz) float32 tensor on the
        scene's device.  A fixed seed gives a bit-identical field; the
        stream is the JAX package's at the same seed."""
        re, im = _sample.unit_draws_reim(
            _threefry.key_from_seed(seed), self.shape, self.device
        )
        return self._render_reim(re, im, smoothing_length, apply_lightcone)

    def generate_delta_fields(self, seeds, smoothing_length=0.0,
                              apply_lightcone=True):
        """A batch of seeds (leading axis = seed), one render per seed."""
        return torch.stack([
            self.generate_delta_field(s, smoothing_length, apply_lightcone)
            for s in np.asarray(seeds).ravel()
        ])

    def generate_noise(self, seed=0):
        """A seed's raw unit normal draws, shape (2, nx, ny, nz//2+1): the
        state before symmetrization and scaling.  ``generate_from_noise``
        of it equals ``generate_delta_field(seed)`` exactly."""
        re, im = _sample.unit_draws_reim(
            _threefry.key_from_seed(seed), self.shape, self.device
        )
        return torch.stack([re, im])

    def generate_from_noise(self, draws, smoothing_length=0.0,
                            apply_lightcone=True):
        """Render from external unit normal draws (2, nx, ny, nz//2+1).

        The same algebra as a seeded render: symmetrize, sigma(k) and the
        filter, c2r, lightcone.  ``draws`` is copied, not consumed.
        """
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
        return self._render_reim(re, im, smoothing_length, apply_lightcone)


def _check_kernel_shape(shape):
    """Raise ValueError unless the CUDA kernels take this grid."""
    nx, ny, nz = shape
    ok = (_fft.kernel_length_ok(nx) and _fft.kernel_length_ok(ny)
          and nz % 2 == 0 and _fft.kernel_length_ok(nz // 2))
    if not ok:
        raise ValueError(
            f"grid {shape} is not supported on CUDA: nx, ny and nz/2 must be "
            f"powers of two in [{_fft.MIN_LENGTH}, {_fft.MAX_LENGTH}] (a "
            f"mixed-radix FFT is on the roadmap); use device='cpu'"
        )
