"""Quickstart: one seeded realization + validation (config 1 workload).

Port of ``examples/quickstart.py``:

    python -m randomfield_tpu_torch.examples.quickstart [--device cpu]
"""

import numpy as np
import torch

import randomfield_tpu_torch as rft
from randomfield_tpu_torch.examples import cli
from randomfield_tpu_torch.ops.power import interpolate_power
from randomfield_tpu_torch.validate.stats import field_moments


def main(device=None, n=None):
    n = n or 64
    gen = rft.Generator(n, n, n, grid_spacing=4.0, device=device)
    delta = gen.generate_delta_field(seed=42)

    mean, var = field_moments(delta)  # float64 sums of x slabs
    pred = gen.predicted_variance()
    d2 = float(np.mean(gen.growth_function**2))
    print(f"field: {tuple(delta.shape)} "
          f"{str(delta.dtype).removeprefix('torch.')}")
    print(f"mean = {mean:.2e}  (exactly 0 in expectation)")
    print(f"var  = {var:.4f}  vs predicted {pred:.4f}"
          f" (x <D^2> = {d2:.3f} for the lightcone)")

    k, p_hat, n_modes = gen.calculate_power(delta, nbins=10)
    p_true = interpolate_power(gen.power, torch.as_tensor(k, dtype=torch.float32)).numpy()
    print("\nrealized P(k) vs input table:")
    for i in range(len(k)):
        if n_modes[i] > 0:
            print(f"  k={k[i]:.4f}  P^={p_hat[i]:10.1f}  P={p_true[i]:10.1f} "
                  f" ({n_modes[i]:5.0f} modes)")
    return dict(mean=mean, var=var, predicted_variance=pred, d2=d2, k=k,
                p_hat=p_hat, p_true=p_true, n_modes=n_modes)


if __name__ == "__main__":
    cli(main)
