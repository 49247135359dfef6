#!/usr/bin/env python3
"""On-card fidelity gate of randomfield_tpu_torch: render statistics by size.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/validate_gpu.py [--staged] [--nested] [--fixed]

Without a card it exits non-zero.  It imports torch, numpy and the port only.

* default: at 128^3, 256^3 and 512^3 the default render's variance against
  ``predicted_variance`` (within 5%) and its binned P(k), through the port's
  ``calculate_power``, against the input table (max |P / P_table - 1| < 0.15
  over bins of more than 1000 modes);
* ``--staged``: one 1024^3 render of each sampler ('threefry', 'pallas'):
  variance within 5%, and the field's binned P(k) against ``sample_power``
  of the same seed (the spectrum binned with no transform) within 2e-3;
* ``--nested``: a 256^3 nested render's variance within 5%, and a 128^3
  render of the same box sharing its low-k spectrum (zoom matching) within
  1e-3 of the scale;
* ``--fixed``: the fixed field of each stream at 256^3: variance within 1e-4
  of the prediction, and the paired field its exact negation.

Each line names the card and its power limit; any failed check exits
non-zero after the rest have run.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()


def table_power(power, k):
    """P(k) of the scene's table, linear in log10 k (its 'log10k'
    interpolation), at the bins' mean |k|."""
    return np.interp(np.log10(k), np.log10(power.k), power.Pk)


def render_ms(torch, fn, reps=3):
    """Best host milliseconds of ``fn()`` over ``reps`` runs, each ended by
    a synchronize, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def report(ok, msg, card):
    print(f"{'OK  ' if ok else 'FAIL'} {msg} [{card}]", flush=True)
    return 0 if ok else 1


def main_gate(torch, rft, card, sizes=((128, 16.0), (256, 8.0), (512, 4.0))):
    from randomfield_tpu_torch.validate.stats import field_moments

    failures = 0
    for n, sp in sizes:
        g = rft.Generator(n, n, n, grid_spacing=sp)
        d = g.generate_delta_field(0, apply_lightcone=False)
        _, var = field_moments(d)
        ratio = var / g.predicted_variance()
        k, ph, nm = g.calculate_power(d, nbins=12)
        mask = nm > 1000
        resid = float(np.abs(ph[mask] / table_power(g.power, k[mask]) - 1).max())
        ms = render_ms(torch, lambda: g.generate_delta_field(
            1, apply_lightcone=False))
        failures += report(
            abs(ratio - 1) < 0.05 and resid < 0.15,
            f"{n}^3: var/pred={ratio:.4f} max|P resid|={resid:.3f} "
            f"render={ms:.2f} ms ({n**3 / ms / 1e6:.2f} Gcells/s)", card)
        del g, d
        torch.cuda.empty_cache()
    return failures


def staged_gate(torch, rft, card, sampler, n=1024, sp=2.0, seed=3):
    from randomfield_tpu_torch.validate.stats import field_moments

    g = rft.Generator(n, n, n, grid_spacing=sp, sampler=sampler)
    ms = render_ms(torch, lambda: g.generate_delta_field(
        seed, apply_lightcone=False), reps=1)
    d = g.generate_delta_field(seed, apply_lightcone=False)
    _, var = field_moments(d)
    ratio = var / g.predicted_variance()
    kf, pf, nf = g.calculate_power(d, nbins=16)
    del d
    torch.cuda.empty_cache()
    ks, ps, ns = g.sample_power(seed, nbins=16)
    mask = nf > 0
    dev = float(np.abs(pf[mask] / ps[mask] - 1).max())
    return report(
        abs(ratio - 1) < 0.05 and dev < 2e-3 and np.array_equal(nf, ns),
        f"{n}^3 ({sampler}): var/pred={ratio:.4f} max|field/spectrum P - 1|="
        f"{dev:.2e} render={ms:.2f} ms", card)


def nested_gate(torch, rft, card, n=256, box=2048.0, seed=5):
    from randomfield_tpu_torch.validate.stats import field_moments

    g_hi = rft.Generator(n, n, n, grid_spacing=box / n, sampler="nested")
    d_hi = g_hi.generate_delta_field(seed, apply_lightcone=False)
    _, var = field_moments(d_hi)
    ratio = var / g_hi.predicted_variance()
    m = n // 2
    g_lo = rft.Generator(m, m, m, grid_spacing=box / m, sampler="nested")
    d_lo = g_lo.generate_delta_field(seed, apply_lightcone=False)
    c_lo = torch.fft.rfftn(d_lo.double(), norm="forward").cpu().numpy()
    c_hi = torch.fft.rfftn(d_hi.double(), norm="forward").cpu().numpy()
    q = min(8, m // 2 - 1)
    rows = np.r_[0:q, -q:0]  # low |k| rows both grids hold
    zs = np.arange(q)
    dev = np.abs(c_lo[np.ix_(rows, rows, zs)] - c_hi[np.ix_(rows, rows, zs)])
    scale = np.abs(c_lo[np.ix_(rows, rows, zs)]).max()
    gap = float(dev.max() / scale)
    return report(abs(ratio - 1) < 0.05 and gap < 1e-3,
                  f"nested {n}^3: var/pred={ratio:.4f} zoom against {m}^3 "
                  f"max|dc|/scale={gap:.2e}", card)


def fixed_gate(torch, rft, card, n=256, sp=8.0, seed=5):
    from randomfield_tpu_torch.validate.stats import field_moments

    failures = 0
    for sampler in ("threefry", "nested"):
        g = rft.Generator(n, n, n, grid_spacing=sp, sampler=sampler)
        fixed = g.generate_fixed_field(seed, apply_lightcone=False)
        paired = g.generate_fixed_field(seed, apply_lightcone=False,
                                        flip=True)
        _, var = field_moments(fixed)
        ratio = var / g.predicted_variance()
        negated = bool(torch.equal(paired, -fixed))
        failures += report(
            abs(ratio - 1) < 1e-4 and negated,
            f"fixed {n}^3 ({sampler}): var/pred={ratio:.7f}, paired "
            f"{'= -fixed bit for bit' if negated else 'NOT -fixed'}", card)
        del g, fixed, paired
        torch.cuda.empty_cache()
    return failures


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("validate_gpu: torch.cuda.is_available() is False; this gate "
              "runs on a CUDA card only", file=sys.stderr)
        return 1
    import randomfield_tpu_torch as rft

    card = card_line()
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    failures = main_gate(torch, rft, card)
    if "--staged" in argv:
        for sampler in ("threefry", "pallas"):
            failures += staged_gate(torch, rft, card, sampler)
    if "--nested" in argv:
        failures += nested_gate(torch, rft, card)
    if "--fixed" in argv:
        failures += fixed_gate(torch, rft, card)
    if failures:
        print(f"validate_gpu: {failures} check(s) FAILED", file=sys.stderr)
        return 1
    print("fidelity gate PASSED", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
