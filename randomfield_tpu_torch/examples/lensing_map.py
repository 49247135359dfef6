"""Weak-lensing convergence and shear from one lightcone render.

Port of ``examples/lensing_map.py``: the default render already carries
D(z)/D(0) per plane, so the Born convergence is one weighted reduction
along the line of sight (on the field's device).

    python -m randomfield_tpu_torch.examples.lensing_map
"""

import numpy as np

import randomfield_tpu_torch as rft
from randomfield_tpu_torch.examples import cli
from randomfield_tpu_torch.models import lensing


def main(device=None, n=None):
    n = n or 128
    spacing = 10.0  # 128^3: a (1.28 Gpc/h)^3 lightcone box
    g = rft.Generator(n, n, n, grid_spacing=spacing, device=device)
    delta = g.generate_delta_field(seed=42)

    out = {}
    for z_source in (0.5, 1.0, 2.0):
        kappa = lensing.convergence_map(
            delta, g.cosmology, g.scene.grid_spacing, z_source=z_source
        )
        k = kappa.cpu().numpy()
        print(f"z_s = {z_source}: sigma_kappa = {k.std():.5f} "
              f"(mean {k.mean():+.2e})")
        out[f"sigma_kappa_{z_source}"] = float(k.std())
        out[f"mean_kappa_{z_source}"] = float(k.mean())

    # flat-sky shear of the deepest map (Kaiser-Squires)
    g1, g2 = lensing.convergence_to_shear(kappa, g.scene.grid_spacing)
    g1, g2 = g1.cpu().numpy(), g2.cpu().numpy()
    print(f"shear: sigma_gamma1 = {g1.std():.5f}, "
          f"sigma_gamma2 = {g2.std():.5f}")
    ratio = round(float((g1.var() + g2.var()) / k.var()), 3)
    print("E-mode consistency <|gamma|^2>/<kappa^2> =", ratio)
    out.update(sigma_gamma1=float(g1.std()), sigma_gamma2=float(g2.std()),
               e_mode_ratio=ratio)
    return out


if __name__ == "__main__":
    cli(main)
