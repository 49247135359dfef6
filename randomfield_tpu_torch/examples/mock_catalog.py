"""Mock galaxy catalogs two ways: lognormal tracers and Zel'dovich RSD.

Port of ``examples/mock_catalog.py``.

Part A, lognormal mock: render a positive-definite lognormal density
field with the default linear P(k), Poisson-sample galaxies per cell (KH)
and check the catalog's shot-noise-subtracted P(k) against the target.

Part B, Zel'dovich redshift-space mock: displace a uniform particle grid
by the displacement field, boost the line-of-sight component by the
growth rate f, and compare the monopole with Kaiser x linear P(k).

    python -m randomfield_tpu_torch.examples.mock_catalog
"""

import numpy as np
import torch

import randomfield_tpu_torch as rft
from randomfield_tpu_torch.examples import cli
from randomfield_tpu_torch.models import zeldovich as zl
from randomfield_tpu_torch.models.lognormal import LognormalGenerator
from randomfield_tpu_torch.ops.power import PowerTable, interpolate_power

NBAR = 2e-3  # galaxies per (Mpc/h)^3


def _table_at(table, k):
    return interpolate_power(
        table, torch.as_tensor(k, dtype=torch.float32)).numpy()


def main(device=None, n=None):
    n = n or 64
    spacing = 8.0  # 64^3: a 512 Mpc/h box
    volume = (n * spacing) ** 3
    shape = (n, n, n)

    # --- Part A: lognormal galaxy mock --------------------------------
    ln = LognormalGenerator(n, n, n, grid_spacing=spacing, device=device)
    delta = ln.generate_delta_field(seed=42, apply_lightcone=False)
    counts = zl.poisson_sample(delta, NBAR, spacing, seed=42)
    total = float(counts.sum(dtype=torch.float64))
    print(f"galaxies: {total:.0f} (target {NBAR * volume:.0f})")

    # galaxies live at cell centers: NGP painting is exact
    q = zl.lagrangian_positions(shape, spacing, device=ln.device)
    k, p, nm = zl.catalog_power(q, spacing, weights=counts, nbins=14,
                                window="ngp")
    shot = zl.shot_noise(counts, volume)
    print(f"shot noise subtracted: {shot:.1f} (Mpc/h)^3")
    target = _table_at(ln.power, k)
    print("lognormal tracer P(k) vs target:")
    for i in range(len(k)):
        if nm[i] > 200:
            print(f"  k = {k[i]:7.4f}  P^ = {p[i]:10.1f}  "
                  f"target = {target[i]:10.1f}  ({nm[i]:7.0f} modes)")

    # --- Part B: Zel'dovich redshift-space mock -------------------------
    # a low-amplitude spectrum keeps the Zel'dovich mapping linear
    base = ln.power
    table = PowerTable(base.k, 0.05 * base.Pk)
    g = rft.Generator(n, n, n, grid_spacing=spacing, power=table,
                      device=device)
    f = float(g.cosmology.growth_rate(0.5))
    psi = g.generate_displacement(seed=7)
    pos = zl.zeldovich_positions(psi, spacing, f=f)  # redshift space
    k_s, ps, nm_s = zl.catalog_power(pos, spacing, nbins=14, window="cic")
    kaiser = 1.0 + 2.0 * f / 3.0 + f * f / 5.0
    plin = _table_at(table, k_s)
    print(f"\nZel'dovich RSD monopole vs Kaiser x linear (f = {f:.3f}, "
          f"boost = {kaiser:.3f}):")
    for i in range(len(k_s)):
        if nm_s[i] > 200 and k_s[i] < 0.5 * np.pi / spacing:
            print(f"  k = {k_s[i]:7.4f}  P^_s = {ps[i]:9.2f}  "
                  f"Kaiser*P_lin = {kaiser * plin[i]:9.2f}  "
                  f"({nm_s[i]:7.0f} modes)")
    return dict(galaxies=total, shot_noise=shot, k=k, p_hat=p,
                target=target, n_modes=nm, f=f, kaiser=kaiser, k_s=k_s,
                p_s=ps, n_modes_s=nm_s, kaiser_p_lin=kaiser * plin)


if __name__ == "__main__":
    cli(main)
