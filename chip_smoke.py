#!/usr/bin/env python3
"""Smoke run of randomfield_tpu_torch on one CUDA card: build, check, time.

Run from the repository root on a machine with one NVIDIA GPU (H100):

    python3 chip_smoke.py

It needs PyTorch with CUDA, nvcc (the kernels are built from
randomfield_tpu_torch/csrc at first use) and numpy; it never imports JAX
or the randomfield_tpu package.  Phases, any failure of which exits
non-zero with no result line:

0. the card's name and power limit (nvidia-smi), CUDA version, kernel build;
1. each hand kernel against its plain PyTorch version on the card, at the
   exact shapes, table and weights the 1024^3 main paths give it: K2
   scale_sigma, K3 fft_axis, K4 c2r_tail (and over a sweep of lengths), K1
   sample_modes (s = 0 and 8), K5 sample_power_bins (nbins = 32; counts
   exact, repeatable bit for bit, and equal to binning K1's spectrum);
2. the slices at 128^3, both samplers: CUDA render vs the CPU render (plain
   versions) at the same seed, which the CPU tests hold to the JAX package;
   the sampler='pallas' statistical gate (2000 seeds at 16^3); sample_power
   vs calculate_power of the same seed's field at 256^3;
3. the main paths at 1024^3, through the public API, each with the launch
   counts set to 0 before it and read after it: the default render and the
   sampler='pallas' render (determinism, finite values, variance vs
   predicted_variance), and the config-4 ensemble, sample_power_batch of 64
   seeds (nbins = 32), whose mean P(k) must match the binned prediction
   within 6 sigma of its sampling noise;
4. times (CUDA events, median after warm-up) of renders, of each stage of a
   1024^3 render for both samplers, of each kernel beside its plain version
   and, for K3 and K4, beside the cuFFT call that computes the same
   function; each kernel's bound from its bytes and operations; the device's
   idle share during a 1024^3 render (torch.profiler) and its peak device
   memory.

The line before the last is a JSON object of the kernels; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

KERNELS = {
    "K1": dict(name="sample_modes", route="cuda",
               source="randomfield_tpu_torch/csrc/sample_modes.cu",
               replaces="randomfield_tpu/ops/pallas_sampler.py:239"),
    "K2": dict(name="scale_sigma", route="cuda",
               source="randomfield_tpu_torch/csrc/scale_sigma.cu",
               replaces="randomfield_tpu/ops/pallas_sampler.py:491"),
    "K3": dict(name="fft_axis", route="cuda",
               source="randomfield_tpu_torch/csrc/fft_axis.cu",
               replaces="randomfield_tpu/ops/pallas_fft.py:135"),
    "K4": dict(name="c2r_tail", route="cuda",
               source="randomfield_tpu_torch/csrc/c2r_tail.cu",
               replaces="randomfield_tpu/ops/pallas_fft.py:338"),
    "K5": dict(name="sample_power_bins", route="cuda",
               source="randomfield_tpu_torch/csrc/sample_power_bins.cu",
               replaces="randomfield_tpu/ops/pallas_sampler.py:786"),
}
KERNEL_ORDER = ("K1", "K2", "K3", "K4", "K5")
# relative bars (max|kernel - plain| / max|plain|): float32 rounding of a
# scale (K1's Box-Muller and K2; libdevice logf/sincosf on both sides) and of
# a log2(n)-stage FFT against cuFFT's (K3, and K4 as the c2r tail test of the
# JAX package's tests/test_pallas_fft.py)
BARS = {"K1": 2e-6, "K2": 2e-6, "K3": 2e-6, "K4": 5e-6}
# K5 vs plain: the same float32 per-mode terms, added in float64 in another
# order (per-run and per-block partials vs index_add_); counts exactly
K5_SUM_RTOL = 1e-6
# K5 (plus its plane fix) vs binning K1's materialized spectrum: both put
# each mode in the bin of the estimator's edge search on the same float32
# |k|, so the counts agree exactly by design; the bar admits 1e-6 of a
# bin plus a handful, the rounding a mode's |k| could see
SPEC_COUNT_BAR = (1e-6, 16)
NBINS = 32
ENSEMBLE_SEEDS = 64
# ensemble mean of p_hat vs the binned prediction, in sampling sigmas
ENSEMBLE_SIGMAS = 6.0
# sampler='pallas' statistical gate: bench.py's size on the TPU
GATE_SEEDS, GATE_SHAPE = 2000, (16, 16, 16)
# sample_power vs calculate_power of the field at 256^3: the spectrum's
# round trip through the c2r render and the forward rfftn
CONSISTENCY_SHAPE, CONSISTENCY_SPACING, CONSISTENCY_RTOL = (256, 256, 256), 8.0, 1e-4
# the card's published peaks (NVIDIA H100 SXM data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# 32-bit operations per mode, counted from the kernels' source: Threefry-2x32
# is 20 rounds of add, rotate, xor plus 5 key injections of two adds and the
# two initial adds (72), plus the counter split (2); each transcendental
# (logf, sqrtf, sincosf as two, expf) counts as one operation.  K1: the hash,
# |k|^2 (7), the sigma lookup (12), Box-Muller (12) and the amplitude (4).
# K5: the hash, |k|^2 for sigma and for the bin (12), the lookup (12),
# u1 and r^2 (6), amplitude, filter and power (8), the bin guess and edge
# compares (6), the weights and the three float64 adds (6).
OPS_PER_MODE = {"K1": 74 + 7 + 12 + 12 + 4, "K5": 74 + 12 + 12 + 6 + 8 + 6 + 6,
                "K2": 24}
# CUDA vs CPU render at one seed: float32 FFTs of two libraries
SLICE_BAR = 1e-5
# single-seed variance vs prediction at 1024^3
VAR_BAR = 0.10
HEADLINE = (1024, 1024, 1024)
HEADLINE_SPACING = 2.0  # 2048 / n Mpc/h, as bench.py sizes its grids
TIMING_REPS = 5
# the constant a render folds into K2's amplitude (the draws' 1/sqrt(2))
RENDER_GAIN = 0.5 ** 0.5


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def rel_err(got, want):
    """(max |got - want|, that over max |want|) across paired tensors."""
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    return abs_err, abs_err / scale


def cuda_ms(torch, fn, reps=TIMING_REPS, setup=None):
    """Median device milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up; ``setup()`` runs before each, outside the timed span."""
    times = []
    for i in range(reps + 1):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if i:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase1_kernels(torch, g, errs):
    """Each kernel vs its plain version on the card, first at the shapes,
    table and weights the main path's scene ``g`` gives it; fills
    errs[K] = max abs."""
    from randomfield_tpu_torch.ops import fft, sampler

    dev = g.device

    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def record(kid, what, got, want):
        a, r = rel_err(got, want)
        errs[kid] = max(errs.get(kid, 0.0), a)
        log(f"phase 1 {kid} {what}: max|d| {a:.3e}, rel {r:.3e} "
            f"(bar {BARS[kid]:g})")
        if not r <= BARS[kid]:
            raise AssertionError(f"{kid} {what} disagrees: rel {r:.3e}")

    def check_k3(outer, n, inner):
        re, im = randn(outer, n, inner), randn(outer, n, inner)
        a, b = fft.ifft_axis(re.clone(), im.clone(), outer, n, inner)
        c, d = fft.ifft_axis_plain(re.clone(), im.clone(), outer, n, inner)
        torch.cuda.synchronize()
        record("K3", f"({outer}, {n}, {inner})", (a, b), (c, d))

    def check_k4(lead, nz_, w):
        nzh = nz_ // 2 + 1
        re, im = randn(*lead, nzh), randn(*lead, nzh)
        im[..., 0] = 0.0   # a packed half-spectrum's DC and Nyquist
        im[..., -1] = 0.0  # terms are real
        got = fft.c2r_tail(re, im, nz_, w)
        want = fft.c2r_tail_plain(re, im, nz_, w)
        torch.cuda.synchronize()
        record("K4", f"{tuple(re.shape)} nz={nz_}", (got,), (want,))

    # the main path's calls: its shapes, sigma table, gain and weights
    nx, ny, nz = g.shape
    nzh = nz // 2 + 1
    table = g.state.table
    re, im = randn(nx, ny, nzh), randn(nx, ny, nzh)
    for s in (0.0, 6.0):
        a, b = re.clone(), im.clone()
        sampler.scale_sigma(a, b, table, g.shape, g.grid_spacing, s,
                            gain=RENDER_GAIN)
        c, d = re.clone(), im.clone()
        sampler.scale_sigma_plain(c, d, table, g.shape, g.grid_spacing, s,
                                  gain=RENDER_GAIN)
        torch.cuda.synchronize()
        record("K2", f"{tuple(re.shape)} s={s}", (a, b), (c, d))
        del a, b, c, d
    del re, im
    check_k3(1, nx, ny * nzh)  # x pass
    check_k3(nx, ny, nzh)      # y pass
    check_k4((nx, ny), nz, g.state.lightcone_weights)
    torch.cuda.empty_cache()

    # the other lengths the kernels take, at smaller sizes
    for n in (128, 256, 512, 1024, 2048):
        for outer, inner in ((1, 2**24 // n), (max(1, 2**24 // (n * 513)), 513)):
            check_k3(outer, n, inner)
    for nz_ in (256, 1024, 2048):
        lines = 2**23 // (nz_ // 2 + 1)
        check_k4((lines // 64, 64), nz_,
                 torch.rand(nz_, generator=gen, device=dev) + 0.5)


def phase1_sampler(torch, g, errs):
    """K1 and K5 vs their plain versions at the 1024^3 shapes and table of
    the sampler='pallas' scene ``g``; fills errs["K1"], errs["K5"]."""
    from randomfield_tpu_torch.ops import sampler
    from randomfield_tpu_torch.validate import stats

    seed, table = 17, g.state.table
    shape, spacing = g.shape, g.grid_spacing
    for s in (0.0, 8.0):
        a, b = sampler.sample_modes(seed, table, shape, spacing, s)
        c, d = sampler.seeded_modes_plain(seed, table, shape, spacing, s)
        torch.cuda.synchronize()
        abs_err, r = rel_err((a, b), (c, d))
        errs["K1"] = max(errs.get("K1", 0.0), abs_err)
        log(f"phase 1 K1 {tuple(a.shape)} s={s}: max|d| {abs_err:.3e}, rel "
            f"{r:.3e} (bar {BARS['K1']:g})")
        if not r <= BARS["K1"]:
            raise AssertionError(f"K1 s={s} disagrees: rel {r:.3e}")
        del a, b, c, d
        torch.cuda.empty_cache()

    edges, _ = stats.bin_setup(shape, spacing, NBINS)
    acc, pre, pim = sampler.sample_power_bins(seed, table, shape, spacing, 0.0,
                                              edges)
    again, _, _ = sampler.sample_power_bins(seed, table, shape, spacing, 0.0,
                                            edges)
    want, wpre, wpim = sampler.seeded_power_bins_plain(seed, table, shape,
                                                       spacing, 0.0, edges)
    torch.cuda.synchronize()
    repeat = float((acc - again).abs().max())
    log(f"phase 1 K5 repeatability, two calls of seed {seed}: "
        f"{'bit-identical' if torch.equal(acc, again) else f'max|d| {repeat:.3e}'}")
    if not torch.equal(acc[0], again[0]) or repeat > 1e-12 * float(acc.abs().max()):
        raise AssertionError("K5 is not repeatable")
    if not torch.equal(acc[0], want[0]):
        raise AssertionError(f"K5 counts differ from plain: "
                             f"{(acc[0] - want[0]).abs().max()}")
    live = want[0] > 0
    sums_rel = float(((acc[1:] - want[1:]).abs() / want[1:].abs())[:, live].max())
    errs["K5"] = float((acc - want).abs().max())
    _, planes_rel = rel_err((pre, pim), (wpre, wpim))
    log(f"phase 1 K5 {shape} nbins={NBINS} vs plain: counts equal (total "
        f"{float(acc[0].sum()):.0f}), sums max rel {sums_rel:.3e} (bar "
        f"{K5_SUM_RTOL:g}), max|d| {errs['K5']:.3e}, planes rel "
        f"{planes_rel:.3e} (bar {BARS['K1']:g})")
    if not (sums_rel <= K5_SUM_RTOL and planes_rel <= BARS["K1"]):
        raise AssertionError("K5 disagrees with its plain version")
    del want, wpre, wpim, again

    re, im = sampler.sample_spectrum(seed, table, shape, spacing, 0.0)
    k, p, n = stats.spectrum_power((re, im), shape, spacing, NBINS)
    del re, im
    counts, psum, ksum = (acc + stats.plane_bins(pre, pim, shape, spacing,
                                                 NBINS)).cpu().numpy()
    dn = np.abs(counts - n)
    bar = SPEC_COUNT_BAR[0] * n + SPEC_COUNT_BAR[1]
    pop = n > 0
    p_rel = float(np.max(np.abs(psum[pop] / counts[pop] / p[pop] - 1.0)))
    log(f"phase 1 K5 vs spectrum_power of K1's spectrum {shape}: count "
        f"differences max {dn.max():.0f} (bar 1e-6 n + 16 per bin), p_hat max "
        f"rel {p_rel:.3e}")
    if np.any(dn > bar) or not p_rel <= K5_SUM_RTOL:
        raise AssertionError("K5 disagrees with binning K1's spectrum")
    affine_misbins(torch, g, edges, n)
    torch.cuda.empty_cache()


def affine_misbins(torch, g, edges, n):
    """Modes the TPU kernel's affine bin index alone, floor((log10|k| -
    le0) inv_dle), puts in another bin than the estimator's edge search
    (the reason K5 fixes its guess at the edges); logged, not a check."""
    from randomfield_tpu_torch.ops import grid

    nx, ny, nz = g.shape
    mult = torch.full((nz // 2 + 1,), 2.0, dtype=torch.float64, device=g.device)
    mult[0] = mult[-1] = 1.0
    ledges = np.log10(edges)
    le0 = float(np.float32(ledges[0]))
    inv_dle = float(np.float32(NBINS / (ledges[-1] - ledges[0])))
    edges_t = torch.as_tensor(edges, dtype=torch.float32, device=g.device)
    moved = torch.zeros(NBINS + 1, dtype=torch.float64, device=g.device)
    for x0 in range(0, nx, 64):
        km = grid.kmag(g.shape, g.grid_spacing, torch.float32, g.device, x0,
                       min(64, nx - x0))
        by_edges = torch.searchsorted(edges_t, km) - 1
        affine = torch.floor((torch.log10(km) - le0) * inv_dle).to(torch.int64)
        differ = (affine != by_edges) & (km > 0)
        differ &= (by_edges >= 0) & (by_edges < NBINS)
        w = torch.broadcast_to(mult, km.shape)[differ]
        moved.index_add_(0, by_edges[differ], w)
    moved = moved[:NBINS].cpu().numpy()
    worst = int(np.argmax(moved / np.maximum(n, 1)))
    log(f"phase 1 affine bin index alone vs the edge search {g.shape} "
        f"nbins={NBINS}: {moved.sum():.0f} modes in another bin; worst bin "
        f"{worst}: {moved[worst]:.0f} of {n[worst]:.0f} "
        f"({moved[worst] / max(n[worst], 1):.3e})")


def reset_counts():
    from randomfield_tpu_torch.ops import fft, sampler

    sampler.K1_LAUNCHES = sampler.K2_LAUNCHES = sampler.K5_LAUNCHES = 0
    fft.K3_LAUNCHES = fft.K4_LAUNCHES = 0


def read_counts():
    from randomfield_tpu_torch.ops import fft, sampler

    return {"K1": sampler.K1_LAUNCHES, "K2": sampler.K2_LAUNCHES,
            "K3": fft.K3_LAUNCHES, "K4": fft.K4_LAUNCHES,
            "K5": sampler.K5_LAUNCHES}


def require_launches(counts, least, what):
    """Fail unless every kernel in ``least`` launched at least that often."""
    short = {k: counts[k] for k, n in least.items() if counts[k] < n}
    if short:
        raise AssertionError(f"{what} skipped a kernel: {counts}")


def phase2_slice(torch, rft, dev):
    """CUDA render vs CPU (plain) render at 128^3, seed 7, both samplers."""
    shape, spacing, seed = (128, 128, 128), 16.0, 7
    first = {"threefry": "K2", "pallas": "K1"}
    for name, kernel in first.items():
        g_dev = rft.Generator(*shape, grid_spacing=spacing, device=dev,
                              sampler=name)
        g_cpu = rft.Generator(*shape, grid_spacing=spacing, device="cpu",
                              sampler=name)
        for s in (0.0, 20.0):
            reset_counts()
            got = g_dev.generate_delta_field(seed, smoothing_length=s)
            torch.cuda.synchronize()
            counts = read_counts()
            want = g_cpu.generate_delta_field(seed, smoothing_length=s)
            _, r = rel_err((got.cpu(),), (want,))
            log(f"phase 2 slice {name} {shape} seed {seed} s={s}: rel {r:.3e} "
                f"(bar {SLICE_BAR:g}), launches {counts}")
            if not r <= SLICE_BAR:
                raise AssertionError(f"CUDA render disagrees with CPU: rel {r:.3e}")
            require_launches(counts, {kernel: 1, "K3": 2, "K4": 1}, "render")


def phase2_gate(torch, dev):
    """The sampler='pallas' statistical gate on the card."""
    from randomfield_tpu_torch.validate import sampler_gate

    t0 = time.perf_counter()
    out = sampler_gate.run_checks(GATE_SEEDS, GATE_SHAPE, device=dev)
    log(f"phase 2 sampler gate {GATE_SHAPE}, {GATE_SEEDS} seeds: per-mode max "
        f"|var/exp - 1| {out['per_mode_max']:.4f} (bar "
        f"{out['per_mode_tol']:.4f}), pooled shell {out['pooled_shell_max']:.5f}, "
        f"skew {out['skew']:+.5f}, kurtosis {out['kurtosis']:.4f}; "
        f"{time.perf_counter() - t0:.1f} s")


def phase2_consistency(torch, rft, dev):
    """sample_power(s) vs calculate_power(generate_delta_field(s)) at 256^3:
    a mis-addressed transform keeps the variance but moves power."""
    g = rft.Generator(*CONSISTENCY_SHAPE, grid_spacing=CONSISTENCY_SPACING,
                      device=dev, sampler="pallas")
    k1, p1, n1 = g.sample_power(5, nbins=NBINS)
    field = g.generate_delta_field(5, apply_lightcone=False)
    k2, p2, n2 = g.calculate_power(field, nbins=NBINS)
    pop = n2 > 0
    rel = float(np.max(np.abs(p1[pop] / p2[pop] - 1.0)))
    log(f"phase 2 sample_power vs calculate_power {CONSISTENCY_SHAPE}: counts "
        f"{'equal' if np.array_equal(n1, n2) else 'DIFFER'}, p_hat max rel "
        f"{rel:.3e} over {int(pop.sum())} bins (bar {CONSISTENCY_RTOL:g})")
    if not np.array_equal(n1, n2) or not rel <= CONSISTENCY_RTOL:
        raise AssertionError("sample_power disagrees with calculate_power")


def field_variance(torch, f):
    """float64 variance of a large field, accumulated per x-slab."""
    n = f.numel()
    s1 = s2 = 0.0
    for chunk in f.split(64):
        c = chunk.to(torch.float64)
        s1 += float(c.sum())
        s2 += float((c * c).sum())
    mean = s1 / n
    return s2 / n - mean * mean


def phase3_main(torch, g):
    """A 1024^3 render path through the public API; returns the launch
    counts of its run."""
    reset_counts()
    f1 = g.generate_delta_field(seed=1)
    f2 = g.generate_delta_field(seed=1)
    torch.cuda.synchronize()
    counts = read_counts()
    if not torch.equal(f1, f2):
        raise AssertionError("same seed, different fields")
    del f2
    if tuple(f1.shape) != HEADLINE or not bool(torch.isfinite(f1).all()):
        raise AssertionError("field has the wrong shape or non-finite values")
    var = field_variance(torch, f1)
    pred = g.predicted_variance(apply_lightcone=True)
    log(f"phase 3 main path sampler={g.sampler!r} {HEADLINE}: var {var:.6g}, "
        f"predicted {pred:.6g}, ratio {var / pred:.5f}, launches {counts}")
    if not abs(var / pred - 1.0) <= VAR_BAR:
        raise AssertionError(f"variance off prediction: {var / pred:.4f}")
    first = "K1" if g.sampler == "pallas" else "K2"
    require_launches(counts, {first: 2, "K3": 4, "K4": 2}, "main path")
    return counts


def predicted_bins(torch, g):
    """The estimator's bins of E[P_hat] = sigma(|k|)^2 V per mode, the power
    the scene's table asks for."""
    from randomfield_tpu_torch.ops import sampler
    from randomfield_tpu_torch.validate import stats

    nx, ny, nz = g.shape
    volume = nx * ny * nz * g.grid_spacing ** 3
    pgrid = torch.empty((nx, ny, nz // 2 + 1), dtype=torch.float32,
                        device=g.device)
    for x0 in range(0, nx, 64):
        amp = sampler.sigma_amplitude(g.state.table, g.shape, g.grid_spacing,
                                      0.0, x0, min(64, nx - x0))
        pgrid[x0:x0 + 64] = amp * amp * volume
    return stats.bin_power_grid(pgrid, g.shape, g.grid_spacing, NBINS)


def phase3_config4(torch, g, card):
    """BASELINE config 4 through the public API: sample_power_batch of 64
    seeds at 1024^3; returns (launch counts, total s, mean P(k) check)."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    k, p, n = g.sample_power_batch(range(ENSEMBLE_SEEDS), nbins=NBINS)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = read_counts()
    require_launches(counts, {"K5": ENSEMBLE_SEEDS}, "config 4")
    if p.shape != (ENSEMBLE_SEEDS, NBINS) or not np.all(np.isfinite(p[:, n > 0])):
        raise AssertionError(f"ensemble p_hat has shape {p.shape} or is not finite")
    kt, pt, nt = predicted_bins(torch, g)
    if not np.array_equal(n, nt):
        raise AssertionError("ensemble and prediction bin different modes")
    pop = n > 0
    # per bin, n/2 independent complex modes with exponential |c|^2
    sigma = pt[pop] * np.sqrt(2.0 / n[pop]) / np.sqrt(ENSEMBLE_SEEDS)
    z = (p[:, pop].mean(axis=0) - pt[pop]) / sigma
    log(f"phase 3 config 4 sample_power_batch {ENSEMBLE_SEEDS} seeds "
        f"{HEADLINE} nbins={NBINS}: {total:.3f} s, {1e3 * total / ENSEMBLE_SEEDS:.3f} "
        f"ms per seed (host clock) [{card}]; mean p_hat vs prediction max |z| "
        f"{np.abs(z).max():.3f} over {int(pop.sum())} bins (bar "
        f"{ENSEMBLE_SIGMAS:g}); launches {counts}")
    if not np.all(np.abs(z) <= ENSEMBLE_SIGMAS):
        raise AssertionError(f"ensemble P(k) off prediction: z {z}")
    return counts, total


def render_stages(g, seed):
    """The calls of ``g.generate_delta_field(seed)``, one by one, by name."""
    from randomfield_tpu_torch.ops import fft, sample, sampler, threefry, transform

    nx, ny, nz = g.shape
    nzh = nz // 2 + 1
    if g.sampler == "pallas":
        stages = {"K1 sample_modes": lambda _: sampler.sample_modes(
            seed, g.state.table, g.shape, g.grid_spacing)}
    else:
        stages = {
            "Threefry draws (plain PyTorch)": lambda _: sample.unit_draws_reim(
                threefry.key_from_seed(seed), g.shape, g.device),
        }
    stages["Hermitian symmetrize (plain)"] = lambda ri: (
        transform.symmetrize_with_shape_reim(*ri, nz), ri)[1]
    if g.sampler != "pallas":
        stages["K2 scale_sigma"] = lambda ri: sampler.scale_sigma(
            *ri, g.state.table, g.shape, g.grid_spacing, gain=RENDER_GAIN)
    stages["K3 fft_axis x pass"] = lambda ri: fft.ifft_axis(*ri, 1, nx, ny * nzh)
    stages["K3 fft_axis y pass"] = lambda ri: fft.ifft_axis(*ri, nx, ny, nzh)
    stages["K4 c2r_tail"] = lambda ri: fft.c2r_tail(*ri, nz,
                                                    g.state.lightcone_weights)
    return stages


def stage_breakdown(torch, g, seed):
    """Median device ms of each stage of ``g``'s render, timed with CUDA
    events between the stages (:func:`render_stages`); the field they give
    must equal ``generate_delta_field``'s bit for bit."""
    stages = render_stages(g, seed)
    times = {name: [] for name in stages}
    for rep in range(TIMING_REPS + 1):
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(stages) + 1)]
        events[0].record()
        out = None
        for i, stage in enumerate(stages.values()):
            out = stage(out)
            events[i + 1].record()
        torch.cuda.synchronize()
        if rep:
            for i, name in enumerate(stages):
                times[name].append(events[i].elapsed_time(events[i + 1]))
    if not torch.equal(out, g.generate_delta_field(seed)):
        raise AssertionError("the timed stages are not the render's")
    return {name: statistics.median(t) for name, t in times.items()}


def device_idle_share(torch, g, seed):
    """(idle share, device span ms, busy ms) of one render under
    torch.profiler, or None when the trace holds no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        g.generate_delta_field(seed)
        torch.cuda.synchronize()
    spans = sorted(
        (e.start_ns(), e.end_ns())
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
        and e.end_ns() > e.start_ns()
    )
    if not spans:
        return None
    busy, cur_start, cur_end = 0, *spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    span = max(e for _, e in spans) - spans[0][0]
    return 1.0 - busy / span, span / 1e6, busy / 1e6


def render_profile(torch, g, card):
    """Stage breakdown, device idle share and peak memory of a 1024^3 render
    of ``g``."""
    tag = f"sampler={g.sampler!r} {HEADLINE}"
    stage_ms = stage_breakdown(torch, g, seed=2)
    total = sum(stage_ms.values())
    for name, ms in stage_ms.items():
        log(f"phase 4 stage {name} {tag}: {ms:.3f} ms, {100 * ms / total:.2f}% "
            f"of the {total:.3f} ms stage sum [{card}]")
    idle = device_idle_share(torch, g, seed=2)
    if idle is None:
        log(f"phase 4 device idle share of a {tag} render: not measured "
            f"(the profiler recorded no device activity) [{card}]")
    else:
        log(f"phase 4 device idle share of a {tag} render: "
            f"{100 * idle[0]:.3f}% (device span {idle[1]:.3f} ms, busy "
            f"{idle[2]:.3f} ms; torch.profiler) [{card}]")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    f = g.generate_delta_field(seed=3)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"phase 4 peak device memory of a {tag} render: "
        f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above "
        f"the {base / 2**30:.3f} GiB held before it) [{card}]")
    del f


def phase4_times(torch, rft, dev, g, gp, card):
    """Times at the main paths' shapes; returns {K: (ms, plain_ms,
    library_ms or None)}."""
    from randomfield_tpu_torch.ops import fft, sampler
    from randomfield_tpu_torch.validate import stats

    nx, ny, nz = HEADLINE
    nzh = nz // 2 + 1
    g512 = rft.Generator(512, 512, 512, grid_spacing=4.0, device=dev)
    for gen_ in (g512, g, gp):
        ms = cuda_ms(torch, lambda: gen_.generate_delta_field(seed=2))
        n = gen_.shape[0] * gen_.shape[1] * gen_.shape[2]
        log(f"phase 4 render sampler={gen_.sampler!r} {gen_.shape}: {ms:.3f} "
            f"ms, {n / ms / 1e6:.4f} Gcells/s [{card}]")
    render_profile(torch, g, card)
    render_profile(torch, gp, card)

    gen = torch.Generator(device=dev).manual_seed(4)
    src_re = torch.randn((nx, ny, nzh), generator=gen, device=dev)
    src_im = torch.randn((nx, ny, nzh), generator=gen, device=dev)
    src_im[..., 0] = 0.0
    src_im[..., -1] = 0.0
    re, im = torch.empty_like(src_re), torch.empty_like(src_im)
    spec = torch.complex(src_re, src_im)  # the library calls' input

    def fresh():
        re.copy_(src_re)
        im.copy_(src_im)

    t, w = g.state.table, g.state.lightcone_weights
    edges, _ = stats.bin_setup(HEADLINE, HEADLINE_SPACING, NBINS)
    ifft = torch.fft.ifft
    runs = {
        "K1": (lambda: sampler.sample_modes(2, t, HEADLINE, HEADLINE_SPACING),
               lambda: sampler.seeded_modes_plain(2, t, HEADLINE,
                                                  HEADLINE_SPACING),
               None),
        "K2": (lambda: sampler.scale_sigma(re, im, t, HEADLINE, HEADLINE_SPACING,
                                           gain=RENDER_GAIN),
               lambda: sampler.scale_sigma_plain(re, im, t, HEADLINE,
                                                 HEADLINE_SPACING,
                                                 gain=RENDER_GAIN),
               None),
        "K3 x pass": (lambda: fft.ifft_axis(re, im, 1, nx, ny * nzh),
                      lambda: fft.ifft_axis_plain(re, im, 1, nx, ny * nzh),
                      lambda: ifft(spec, dim=0, norm="forward")),
        "K3 y pass": (lambda: fft.ifft_axis(re, im, nx, ny, nzh),
                      lambda: fft.ifft_axis_plain(re, im, nx, ny, nzh),
                      lambda: ifft(spec, dim=1, norm="forward")),
        "K4": (lambda: fft.c2r_tail(re, im, nz, w),
               lambda: fft.c2r_tail_plain(re, im, nz, w),
               lambda: torch.fft.irfft(spec, n=nz, dim=-1, norm="forward")),
        "K5": (lambda: sampler.sample_power_bins(2, t, HEADLINE,
                                                 HEADLINE_SPACING, 0.0, edges),
               lambda: sampler.seeded_power_bins_plain(2, t, HEADLINE,
                                                       HEADLINE_SPACING, 0.0,
                                                       edges),
               None),
    }
    times = {}
    for what, (kernel, plain, library) in runs.items():
        # in turns: plain, kernel, kernel, plain; the mean of each pair
        p1 = cuda_ms(torch, plain, setup=fresh)
        k1 = cuda_ms(torch, kernel, setup=fresh)
        k2 = cuda_ms(torch, kernel, setup=fresh)
        p2 = cuda_ms(torch, plain, setup=fresh)
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        lib_ms = None if library is None else cuda_ms(torch, library)
        times[what] = (k_ms, p_ms, lib_ms)
        lib = "" if lib_ms is None else f", cuFFT call {lib_ms:.3f} ms"
        log(f"phase 4 {what} at {HEADLINE}: kernel {k_ms:.3f} ms "
            f"({k1:.3f}, {k2:.3f}), plain {p_ms:.3f} ms ({p1:.3f}, {p2:.3f})"
            f"{lib} [{card}]")
        torch.cuda.empty_cache()
    x, y = times.pop("K3 x pass"), times.pop("K3 y pass")
    times["K3"] = (x[0] + y[0], x[1] + y[1], x[2] + y[2])
    return times


def kernel_bounds(g):
    """{K: (bound_ms, bound_by)} at the 1024^3 main paths' shapes: the larger
    of the bytes each kernel must move (inputs read once, outputs written
    once) over the HBM rate and its operations over the float32 rate."""
    nx, ny, nz = HEADLINE
    nzh = nz // 2 + 1
    modes, cells = nx * ny * nzh, nx * ny * nz
    knots = 4 * g.state.table.knots.numel()
    m = nz // 2

    def fft_ops(n, lines):
        return 5.0 * n * np.log2(n) * lines

    work = {  # (bytes, operations)
        "K1": (8 * modes + knots, OPS_PER_MODE["K1"] * modes),
        "K2": (16 * modes + knots, OPS_PER_MODE["K2"] * modes),
        "K3": (2 * 16 * modes + 4 * (nx + ny),
               fft_ops(nx, ny * nzh) + fft_ops(ny, nx * nzh)),
        "K4": (8 * modes + 4 * cells + 4 * nz + 4 * m,
               fft_ops(m, nx * ny) + 10.0 * m * nx * ny + cells),
        "K5": (knots + 4 * (nx + ny + nzh + NBINS + 1) + 16 * nx * ny
               + 24 * NBINS, OPS_PER_MODE["K5"] * modes),
    }
    out = {}
    for k, (nbytes, ops) in work.items():
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
        out[k] = (1e3 * max(t_bytes, t_ops),
                  "bytes" if t_bytes >= t_ops else "operations")
        log(f"phase 4 {k} bound at {HEADLINE}: {nbytes / 1e9:.4f} GB -> "
            f"{1e3 * t_bytes:.4f} ms, {ops / 1e9:.2f} G operations -> "
            f"{1e3 * t_ops:.4f} ms; bound {out[k][0]:.4f} ms by {out[k][1]}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs one CUDA card", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import randomfield_tpu_torch as rft
        from randomfield_tpu_torch.ops import _build
    except ImportError:
        traceback.print_exc()
        print("chip_smoke: run it from the repository root", file=sys.stderr)
        return 1
    pkg = os.path.join(here, "randomfield_tpu_torch") + os.sep
    if not os.path.abspath(rft.__file__).startswith(pkg):
        print(f"chip_smoke: randomfield_tpu_torch came from {rft.__file__}, "
              f"not from this checkout ({pkg})", file=sys.stderr)
        return 1
    if "jax" in sys.modules or "randomfield_tpu" in sys.modules:
        print("chip_smoke: the port pulled in JAX", file=sys.stderr)
        return 1

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    try:
        card = card_line()
        log(card)
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
            f"device(s)")
        t0 = time.perf_counter()
        _build.library()
        log(f"phase 0 kernel build: {time.perf_counter() - t0:.1f} s "
            f"(nvcc {' '.join(_build.NVCC_FLAGS)})")

        t0 = time.perf_counter()
        g = rft.Generator(*HEADLINE, grid_spacing=HEADLINE_SPACING, device=dev)
        log(f"phase 0 scene setup {HEADLINE}: {time.perf_counter() - t0:.3f} s "
            f"on the host")
        gp = rft.Generator(*HEADLINE, grid_spacing=HEADLINE_SPACING,
                           device=dev, sampler="pallas")

        errs = {}
        phase1_kernels(torch, g, errs)
        torch.cuda.empty_cache()
        phase1_sampler(torch, gp, errs)
        phase2_slice(torch, rft, dev)
        phase2_gate(torch, dev)
        phase2_consistency(torch, rft, dev)
        torch.cuda.empty_cache()
        launches = dict.fromkeys(KERNEL_ORDER, 0)
        for counts in (phase3_main(torch, g), phase3_main(torch, gp),
                       phase3_config4(torch, gp, card)[0]):
            for k in KERNEL_ORDER:
                launches[k] += counts[k]
        torch.cuda.empty_cache()
        times = phase4_times(torch, rft, dev, g, gp, card)
        bounds = kernel_bounds(g)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    kernels = [
        dict(KERNELS[k], launches=launches[k], max_abs_err=errs[k],
             ms=times[k][0], plain_ms=times[k][1], bound_ms=bounds[k][0],
             bound_by=bounds[k][1], library_ms=times[k][2])
        for k in KERNEL_ORDER
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
