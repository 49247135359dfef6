"""Constrained realizations and data-conditioned field reconstruction.

Port of ``examples/constrained_field.py``.

Part A, Hoffman-Ribak constraints: pin a smoothed peak and a void at
chosen comoving positions; every realization meets the constraints
exactly while keeping the conditional ensemble statistics elsewhere.

Part B, noisy-data conditioning: observe one realization through white
noise, reconstruct it with the Wiener filter, and draw exact posterior
samples whose scatter measures the reconstruction's uncertainty.

    python -m randomfield_tpu_torch.examples.constrained_field
"""

import numpy as np
import torch

import randomfield_tpu_torch as rft
from randomfield_tpu_torch.examples import cli


def main(device=None, n=None):
    n = n or 32
    spacing = 256.0 / n  # a 256 Mpc/h box, which the constraints fill

    # --- Part A: Hoffman-Ribak constrained realizations -------------------
    g = rft.Generator(n, n, n, grid_spacing=spacing, device=device)
    constraints = [
        ((128.0, 128.0, 128.0), +3.0, 16.0),  # 3-sigma-ish peak, R = 16
        ((48.0, 208.0, 64.0), -1.5, 24.0),    # broad void
    ]

    gram = g.constraint_matrix(constraints)
    print("constraint Gram matrix (inspect conditioning):")
    print(np.array_str(gram, precision=4))

    measured = []
    for seed in (0, 1, 2):
        d = g.generate_constrained_field(seed, constraints)
        got = g.measure_constraints(d, constraints)
        measured.append(got)
        print(f"  seed {seed}: measured constraints = {np.round(got, 4)} "
              f"(targets +3.0 / -1.5), field var "
              f"{float(d.to(torch.float64).var(unbiased=False)):.3f}")

    mean = g.constrained_mean_field(constraints)
    mean_got = g.measure_constraints(mean, constraints)
    print(f"conditional mean field: constraints {np.round(mean_got, 4)}, "
          f"|mean| max {float(mean.abs().max()):.3f}")

    # conditional variance at a probe point, from the augmented Gram
    probe = (192.0, 64.0, 192.0)
    xi = g.constraint_matrix(constraints + [(probe, 0.0, 0.0)])
    cc, cf = xi[:2, :2], xi[2, :2]
    cond_var = xi[2, 2] - cf @ np.linalg.solve(cc, cf)
    print(f"probe-point variance: unconditional {xi[2, 2]:.3f} -> "
          f"conditional {cond_var:.3f} (exact Gaussian formula)")

    # --- Part B: Wiener filtering / posterior sampling ---------------------
    truth = g.generate_delta_field(42, apply_lightcone=False).cpu().numpy()
    noise_std = 0.6 * truth.std()
    data = truth + np.random.RandomState(0).normal(scale=noise_std,
                                                   size=truth.shape)
    data_t = torch.as_tensor(data, dtype=torch.float32, device=g.device)
    noise_power = noise_std**2 * spacing**3  # white noise, physical units

    rec = g.wiener_filter(data_t, noise_power).cpu().numpy()
    mse_data = float(np.mean((data - truth) ** 2))
    mse_rec = float(np.mean((rec - truth) ** 2))
    mse_pred = float(g.predicted_posterior_mse(noise_power))
    print(f"wiener: data MSE {mse_data:.4f} -> reconstruction MSE "
          f"{mse_rec:.4f} (exact expectation {mse_pred:.4f})")

    post = np.stack([
        g.generate_posterior_field(s, data_t, noise_power).cpu().numpy()
        for s in range(8)
    ])
    resid = float(np.sqrt(np.mean((post.mean(0) - rec) ** 2)))
    scatter = float(post.std(0).mean())
    print(f"posterior samples: mean-field residual rms {resid:.4f}, "
          f"per-sample scatter rms {scatter:.4f}")
    return dict(gram=gram, measured=np.asarray(measured),
                mean_measured=mean_got, unconditional_var=float(xi[2, 2]),
                conditional_var=float(cond_var), mse_data=mse_data,
                mse_reconstruction=mse_rec, mse_predicted=mse_pred,
                posterior_residual=resid, posterior_scatter=scatter)


if __name__ == "__main__":
    cli(main)
