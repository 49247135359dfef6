"""Variance-reduction and zoom workflows for mock ensembles.

Port of ``examples/variance_reduction.py``.

Part A, fixed & paired: pin every mode's amplitude to sigma(k) (Angulo &
Pontzen 2016) and render the phase-conjugate pair.  The measured P(k) of
a single fixed field carries no sampling scatter, and (fixed, paired)
averages cancel the leading variance of nonlinear statistics too (shown
on a lognormal field).

Part B, zoom-matched realizations: with ``sampler='nested'`` a box
rendered at twice the resolution keeps every large-scale mode of the
coarse render.  The script's grids are n/2 and n (16^3 and 32^3) over one
box; the CUDA kernels take nz/2 >= 16, so on the card run it with n >= 64:

    python -m randomfield_tpu_torch.examples.variance_reduction --n 64
    python -m randomfield_tpu_torch.examples.variance_reduction --device cpu
"""

import numpy as np
import torch

import randomfield_tpu_torch as rft
from randomfield_tpu_torch.examples import cli
from randomfield_tpu_torch.models.lognormal import LognormalGenerator


def main(device=None, n=None):
    n = n or 32
    if n < 64 and torch.device(device or "cuda").type == "cuda":
        raise ValueError(
            f"variance_reduction: the zoom's {n // 2}^3 grid is below the "
            "CUDA kernels' nz/2 >= 16; on the card run it with --n 64")
    spacing = 8.0  # 32^3: a 256 Mpc/h box
    box = n * spacing
    nbins = 10

    # --- Part A: fixed & paired ---------------------------------------
    g = rft.Generator(n, n, n, grid_spacing=spacing, device=device)
    _, _, nm = g.sample_power(0, nbins=nbins)  # any seed: the bins

    # random realizations scatter around P(k); fixed ones do not
    p_rand = np.stack([
        g.calculate_power(g.generate_delta_field(s, apply_lightcone=False),
                          nbins=nbins)[1]
        for s in range(4)
    ])
    p_fixed = np.stack([
        g.calculate_power(g.generate_fixed_field(s, apply_lightcone=False),
                          nbins=nbins)[1]
        for s in range(4)
    ])
    m = nm > 8
    s_rand = float(np.nanmean(np.std(p_rand, 0)[m] / np.mean(p_rand, 0)[m]))
    s_fixed = float(np.nanmean(np.std(p_fixed, 0)[m]
                               / np.mean(p_fixed, 0)[m]))
    print("per-bin scatter across 4 seeds (relative):")
    print(f"  random : {s_rand:.4f}")
    print(f"  fixed  : {s_fixed:.2e}")

    # paired averages cancel leading-order variance of NONLINEAR statistics
    ln = LognormalGenerator(n, n, n, grid_spacing=spacing, device=device)
    d_plus = ln.generate_fixed_field(7, apply_lightcone=False).cpu().numpy()
    d_minus = ln.generate_fixed_field(7, apply_lightcone=False,
                                      flip=True).cpu().numpy()
    pair = (d_plus.mean() + d_minus.mean()) / 2
    print(f"lognormal pair means: {d_plus.mean():+.5f} / "
          f"{d_minus.mean():+.5f} -> pair average {pair:+.6f}")

    # --- Part B: zoom-matched realizations ------------------------------
    lo, hi = n // 2, n
    g_lo = rft.Generator(lo, lo, lo, grid_spacing=box / lo,
                         sampler="nested", device=device)
    g_hi = rft.Generator(hi, hi, hi, grid_spacing=box / hi,
                         sampler="nested", device=device)
    d_lo = g_lo.generate_delta_field(5, apply_lightcone=False).cpu().numpy()
    d_hi = g_hi.generate_delta_field(5, apply_lightcone=False).cpu().numpy()
    c_lo = np.fft.rfftn(d_lo.astype(np.float64), norm="forward")
    c_hi = np.fft.rfftn(d_hi.astype(np.float64), norm="forward")
    reach = lo // 2 - 1
    diffs = [
        abs(c_lo[sx % lo, sy % lo, kz] - c_hi[sx % hi, sy % hi, kz])
        for sx in range(-reach, reach + 1) for sy in range(-reach, reach + 1)
        for kz in range(lo // 2)
    ]
    scale = float(np.abs(c_lo).max())
    print(f"zoom: max shared-mode |c_lo - c_hi| = {max(diffs):.2e} "
          f"(of scale {scale:.2e}) over {len(diffs)} modes")
    return dict(scatter_random=s_rand, scatter_fixed=s_fixed,
                mean_plus=float(d_plus.mean()),
                mean_minus=float(d_minus.mean()), pair_mean=float(pair),
                zoom_max_diff=float(max(diffs)), zoom_scale=scale,
                zoom_modes=len(diffs))


if __name__ == "__main__":
    cli(main)
