"""Scene (static spec) and State (per-scene tensors).

Port of ``randomfield_tpu/engine/scene.py``.  The JAX State holds a
per-mode sigma grid; the port's holds the small uniform log10-k sigma table
instead (:mod:`randomfield_tpu_torch.ops.sampler`), which the sigma-scale
kernel interpolates per mode, so no (nx, ny, nzh) sigma lattice exists.
"""

from __future__ import annotations

import dataclasses
import typing

import torch

from randomfield_tpu_torch.models import cosmology as _cosmo
from randomfield_tpu_torch.ops import grid as _grid
from randomfield_tpu_torch.ops import power as _power
from randomfield_tpu_torch.ops import sampler as _sampler

__all__ = ["Scene", "State", "build_state"]


@dataclasses.dataclass(frozen=True)
class Scene:
    """Static scene spec."""

    nx: int
    ny: int
    nz: int
    grid_spacing: float  # Mpc/h
    cosmology: _cosmo.Cosmology = _cosmo.Planck13
    interpolation: str = "log10k"
    z0: float = 0.0  # redshift of the nearest lightcone plane

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.nx, self.ny, self.nz)

    @property
    def k_bounds(self) -> tuple[float, float]:
        return _grid.get_k_bounds(self.shape, self.grid_spacing)


class State(typing.NamedTuple):
    """Per-scene state a render reads."""

    table: _sampler.SigmaTable  # uniform log10-k sigma(k) = sqrt(P/V) knots
    lightcone_weights: torch.Tensor  # float32 (nz,): D(z_plane)/D(0)
    power: _power.PowerTable  # the validated input table


def build_state(scene: Scene, power, device="cpu",
                box_table=False) -> tuple[State, dict]:
    """The sigma table and lightcone weights of a scene.

    ``box_table=True`` (a nested scene) builds the box-anchored table of
    :func:`..ops.sampler.make_box_sigma_table`, so grids of one box share
    their knots; otherwise the grid's own :func:`make_sigma_table`.
    Returns ``(state, aux)``; ``aux`` holds the host float64 plane
    redshifts and growth factors.
    """
    table = _power.validate_power(power)
    make = (_sampler.make_box_sigma_table if box_table
            else _sampler.make_sigma_table)
    sigma_table = make(
        table, scene.shape, scene.grid_spacing, scene.interpolation, device
    )
    redshifts = _cosmo.get_redshifts(
        scene.cosmology, scene.nz, scene.grid_spacing, scaled_by_h=True,
        z0=scene.z0,
    )
    growth = _cosmo.get_growth_function(scene.cosmology, redshifts)
    # growth is normalized to D(z=0) = 1, so D(z_i) IS the plane weight
    weights = torch.as_tensor(growth, dtype=torch.float32, device=device)
    state = State(table=sigma_table, lightcone_weights=weights, power=table)
    return state, {"redshifts": redshifts, "growth": growth}
