#!/usr/bin/env python3
"""Smoke run of randomfield_tpu_torch on one CUDA card: build, check, time.

Run from the repository root on a machine with one NVIDIA GPU (H100):

    python3 chip_smoke.py

It needs PyTorch with CUDA, nvcc (the kernels are built from
randomfield_tpu_torch/csrc at first use) and numpy; it never imports JAX
or the randomfield_tpu package.  Phases, any failure of which exits
non-zero with no result line:

0. the card's name and power limit (nvidia-smi), CUDA version, kernel build;
   registers a thread and blocks an SM of every instance of the kernels on
   the register-radix FFT core: K3 (both signs), K4, K6, K9 and K10;
   registers and the SASS instructions of the loop body a mode of the
   hashing kernels K1 (and K8, the same kernel), K2F (and K7), K5, KN (K1's
   kernel on the nested stream) and K2F's fixed mode (cuobjdump), and the
   issue-rate time they imply; K2F's spectrum instance held to its
   registers and instructions a mode (K2F_SPECTRUM_SASS), and K5 to its
   (K5_SASS: its binning code, csrc/bins_common.cuh, must not move); the
   registers of KB's eighteen instances (four kinds and the geometry pass;
   the outputs and the read probe) and its launch plans at 1024^3; K4's
   1024^3 instance held to its registers and SASS count (K4_SASS_512) with
   K4L in its template, the registers of KP's, KC's and K4L's instances,
   the shared-memory atomics of KP's deposit instances and what a 64-bit
   atomicAdd on shared memory compiles to; KC MEASURE's loop a kz step
   (its F2F.F64.F32 and float64 instructions) and KC's plans at M = 1, 8,
   40, 64, 128 and 3000 (the constraints a pass takes);
1. each hand kernel against its plain PyTorch version on the card, at the
   exact shapes, table and weights the 1024^3 main paths give it: the
   default render's fused K2 draw_scale (its device normal over all 2^23
   inputs it can take within 3 ulps of the plain normal, the bits of its
   hash exact, its unit normals within 3 ulps, the spectrum at s = 0 and
   8), K2
   scale_sigma, K3 fft_axis (and every length 16..2048, both signs, one and
   several outer groups, inner = 1, 513 and ragged counts), K4 c2r_tail (and
   every nz / 2 = 16..2048, ragged line counts, one line), K1
   sample_modes (s = 0 and 8; the raw draws plus the plane fix, the planes
   exactly Hermitian), K5 sample_power_bins (nbins = 32; against its plain
   version, power_bins_plain plus plane_bins: counts exact, sums within
   1e-6, repeatable bit for bit, and equal to binning K1's spectrum); the
   slab mesh's K6 r2c_head and forward K3 at the 1024^3 forward transform's
   shapes (K6 also at every length 16..2048, ragged line counts, one line), K7
   draw_scale_shard and K8 sample_shard on each of the
   four (1024, 256, 513) shards of a four-rank mesh (K8 against the raw
   shard plus the plane fix), their unions equal to whole-grid draw_scale
   and K1 bit for bit; the staged variants' K9
   ifft_rotate at the v4 render's x and y passes on a render's own spectrum
   (and every length 16..2048 with several groups, ragged column counts,
   one column) and K10 sample_fftx (s = 0 and 8; bulk rows and plane rows
   apart); KN sample_nested (bits exact; spectrum, unit normals and the
   fixed field), K2F's fixed mode draw_fixed (|c| = sigma filter, the paired
   field the exact negation) and KD apply_kernel (each kind and component);
   KB bin_spectrum on the forward transforms of two 1024^3 renders (and the
   Kaiser expectation grid): auto, cross, interlaced and grid, each
   isotropic, with ells (0, 2, 4), with nmu = 4 wedges, with the cic
   window and at its most bins (1024 with the multipoles, 256 x 4 wedges),
   counts equal to the plain version's, sums within 1e-10, two calls
   bit-equal, and its geometry pass alone (KBG; isotropic and 4 wedges)
   against the plain version's counts and |k| sums; K5's block at 256^3 against its stored digest; the
   threefry and pallas scenes' sigma tables unchanged, the nested tables
   of 512^3 and 1024^3 over one box sharing their knots; KP on 1024^3
   particles in random order (plus particles on faces, at L and below 0)
   and on 1024^3 Zel'dovich positions in lattice order (NGP, CIC, TSC,
   scalar and per-particle weights, the interlacing shift) bit-equal to
   its plain version and to a second call, the deposit's folded total
   equal to the sums' and KPC on it bit-equal, KC (M = 1, 8, 40 and 64, the
   last in two passes; s = 0 and 8) MEASURE within 1e-10 and CORRECT
   bit-equal, K4L within K4's bar;
2. the slices at 128^3, both samplers, and the v4 and v6 variants: CUDA
   render vs the CPU render (plain versions) at the same seed, which the CPU
   tests hold to the JAX package; the sampler='pallas' statistical gate (2000
   seeds at 16^3) on K1's stream and on the v6 stream of K10; sample_power
   vs calculate_power of the same seed's field at 256^3; the nested render,
   fixed and paired fields and every derived field, CUDA vs CPU at 128^3;
   the estimators' gates: Kaiser multipoles and wedges of 8 renders at
   512^3 against predicted_kaiser_multipoles / _wedges (5 sigma of the mean
   + 5e-3 of the scale), the cross power of a field with itself bit-equal
   to its power, xi of 6 renders at 256^3 against predicted_correlation,
   the local f_NL bispectrum of 2 renders at 256^3 against
   predicted_ng_bispectrum (slope, |z| < 5, SNR) and a fixed Gaussian
   field's against 0, sample_power_ensemble resumed from its checkpoint
   equal to the uninterrupted run, and each estimator on the card against
   the same on the CPU at 128^3; the mock makers' gates at 128^3 (the
   lognormal P(k) of 8 seeds against its target, its mean, minimum and
   per-plane variance; the displaced lattice's P(k), the Kaiser monopole
   and quadrupole, interlaced TSC against the field; 8 constraints met,
   the conditional mean and variance, the Wiener MSE, the posterior mean)
   and each mock path on the card against the CPU;
3. the main paths at 1024^3, through the public API, each with the launch
   counts set to 0 before it and read after it: the default render and the
   sampler='pallas' render (determinism, finite values, variance vs
   predicted_variance), generate_noise -> generate_from_noise held to the
   default render bit for bit, and the config-4 ensemble, sample_power_batch
   of 64 seeds (nbins = 32; one K5 launch over the batch into one device
   block, one transfer), whose mean P(k) must match the binned prediction within 6
   sigma of its sampling noise and whose rows must equal single sample_power
   calls bit for bit; the estimator paths (calculate_power, the
   multipoles, the bispectrum, the potential f_NL render), each launching
   K6, K3, K4 or KB and never torch.fft, calculate_power on a geometry KB
   has not kept (its geometry pass, KBG); then the slab mesh at 1024^3, both
   samplers: four ranks in a gloo group share the card (spawned processes;
   gloo stages the CUDA tensors of its collectives through host memory),
   each rank's x slab equal to the same rows of the single-device render
   and calculate_power(mesh=...) equal to the single-device estimator; and
   a one-rank NCCL mesh through the public API (render and estimator);
   then the staged variants through the public API, RF_STAGED_PIPELINE set
   around each render and restored after it: the v4 render (K9 twice) held
   to the default render of the seed, the v6 render (K10; repeatable,
   another field than the default, variance and calculate_power against the
   predictions), and generate_delta_fields of 4 seeds at 512^3 through the
   in-program seed batch, its rows bit-equal to single renders; then the
   nested render (determinism, variance, zoom against 512^3 over the same
   box within 1e-6 of max|c|), its generate_noise -> generate_from_noise bit-equal to it, the
   fixed field (variance within 1e-4, paired = -fixed bit for bit),
   -div(psi) of the displacement against delta, the velocity, tidal and
   Kaiser fields, and 2LPT and classify_web at 512^3 with their peak memory;
   then the mock makers at 1024^3: the lognormal render (its transformed
   spectrum on the card), displacement -> redshift-space positions ->
   interlaced TSC catalog multipoles, an 8-constraint field checked by
   measure_constraints, the Wiener filter and the posterior sample, each
   with its launches (KP, KC, K4L among them, never torch.fft) and peak
   memory;
4. times (CUDA events, median after warm-up) of renders, of each stage of a
   1024^3 render for both samplers and for the v4 and v6 variants, of
   generate_noise beside the plain draws, of each
   kernel beside its plain version and, for K3, K4 and K6, beside the cuFFT
   call that computes the same function (K9: beside cuFFT plus the copy of
   the transpose, two calls); K5's batch as one launch over the batch
   against one launch a seed, in turns; each kernel's bound from its bytes and
   operations; the device's idle share during a 1024^3 render
   (torch.profiler) and its peak device memory; the seed batch beside the
   loop of single renders; the one-rank mesh render beside the single-device
   render, and
   the four-rank run's per-rank stage times (host clock; the exchanges are
   gloo's through host memory, not the card's); KN (three modes), K2F fixed
   and KD beside their plain versions, the nested, fixed and displacement
   renders and their stages; calculate_power split into its transform and
   KB, KB beside its plain version (index_add_), its first call for a
   geometry (the geometry pass and the data pass), the geometry pass alone
   beside its plain version, every kind and output,
   the read-rate yardsticks (torch sums of the lattices, KB's staging
   alone), the multipoles, wedges, cross and interlaced estimators with
   their peak memory, the
   bispectrum (nbins = 8: first call and cached, its peak memory), xi and
   both f_NL renders; KP beside its plain version and index_add_ (and
   NGP, CIC, TSC on both orders, by pass, with the design's bytes), KPC on
   the deposit's total, KC's
   two passes beside theirs and each pass at M = 1, 8, 40, 64, 128, K4L
   beside its
   plain version and irfft, the stages of the lognormal, constrained and
   Zel'dovich paths, the constrained render, measure_constraints, Wiener
   and posterior with their peak memory, and the whole run's wall time.

The line before the last is a JSON object of the kernels; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

``python3 chip_smoke.py --kc-times`` builds the kernels and logs KC's
passes at every M of phase 4 alone, with the package beside the script:
copied into another checkout, it sets that tree's KC against this one's
on the same card.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import os
import re
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
    # K2 fused with the jax.random draw in front of it
    # (randomfield_tpu/engine/staged.py:214) and the Hermitian fix
    "K2F": dict(name="draw_scale", route="cuda",
                source="randomfield_tpu_torch/csrc/draw_scale.cu",
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
    "K6": dict(name="r2c_head", route="cuda",
               source="randomfield_tpu_torch/csrc/r2c_head.cu",
               replaces="randomfield_tpu/ops/pallas_fft.py:490"),
    "K7": dict(name="draw_scale_shard", route="cuda",
               source="randomfield_tpu_torch/csrc/draw_scale.cu",
               replaces="randomfield_tpu/ops/pallas_sampler.py:573"),
    "K8": dict(name="sample_shard", route="cuda",
               source="randomfield_tpu_torch/csrc/sample_modes.cu",
               replaces="randomfield_tpu/ops/pallas_sampler.py:685"),
    "K9": dict(name="ifft_rotate", route="cuda",
               source="randomfield_tpu_torch/csrc/fft_rotate.cu",
               replaces="randomfield_tpu/ops/pallas_fft.py:215"),
    "K10": dict(name="sample_fftx", route="cuda",
                source="randomfield_tpu_torch/csrc/sample_fftx.cu",
                replaces="randomfield_tpu/ops/pallas_genfft.py:76"),
    # three kernels of work the JAX package does in XLA, not in Pallas: the
    # nested draw (K1's kernel on that stream), K2F's fixed mode and the
    # derived fields' spectral kernel
    "KN": dict(name="sample_nested", route="cuda",
               source="randomfield_tpu_torch/csrc/sample_modes.cu",
               replaces="randomfield_tpu/ops/sample.py:207"),
    "K2FX": dict(name="draw_fixed", route="cuda",
                 source="randomfield_tpu_torch/csrc/draw_scale.cu",
                 replaces="randomfield_tpu/ops/sample.py:241"),
    "KD": dict(name="apply_kernel", route="cuda",
               source="randomfield_tpu_torch/csrc/spectral_kernel.cu",
               replaces="randomfield_tpu/ops/derived.py:265"),
    # the estimators' binning: XLA's one-hot contraction _dot_bin behind
    # _masked_bins and its callers, no pl.pallas_call
    "KB": dict(name="bin_spectrum", route="cuda",
               source="randomfield_tpu_torch/csrc/bin_spectrum.cu",
               replaces="randomfield_tpu/validate/stats.py:77"),
    # its geometry pass: the counts and |k| sums of the same bins, once a
    # geometry (binning._geometry keeps them)
    "KBG": dict(name="bin_geometry", route="cuda",
                source="randomfield_tpu_torch/csrc/bin_spectrum.cu",
                replaces="randomfield_tpu/validate/stats.py:77"),
    # the mock makers' XLA stages: the scatter-add painting, the chunked
    # constraint functionals (and :250 _correction_chunked) and the
    # lognormal exp map, fused into K4's tail
    "KP": dict(name="deposit", route="cuda",
               source="randomfield_tpu_torch/csrc/paint.cu",
               replaces="randomfield_tpu/models/zeldovich.py:118"),
    # the painting's contrast, mass / mean - 1 of the reference's paint
    "KPC": dict(name="contrast", route="cuda",
                source="randomfield_tpu_torch/csrc/paint.cu",
                replaces="randomfield_tpu/models/zeldovich.py:186"),
    "KC": dict(name="constraint_measure_correct", route="cuda",
               source="randomfield_tpu_torch/csrc/constraint_kernel.cu",
               replaces="randomfield_tpu/models/constrained.py:224"),
    "K4L": dict(name="c2r_tail_exp", route="cuda",
                source="randomfield_tpu_torch/csrc/c2r_tail.cu",
                replaces="randomfield_tpu/models/lognormal.py:130"),
}
KERNEL_ORDER = ("K1", "K2", "K2F", "K3", "K4", "K5", "K6", "K7", "K8", "K9",
                "K10", "KN", "K2FX", "KD", "KB", "KBG", "KP", "KPC", "KC",
                "K4L")
# relative bars (max|kernel - plain| / max|plain|): float32 rounding of a
# scale (K1's Box-Muller, K2 and the fused K2F, and K8 and K7 that are K1
# and K2F on a shard; libdevice logf/sincosf/log1pf on both sides) and of a
# float32 FFT against
# cuFFT's (K3, a two- or three-pass Stockham transform, and K4 and its
# mirror K6 as the c2r tail test of the JAX package's
# tests/test_pallas_fft.py; K9 is K3's transform written rotated and K10
# K1's draws through the same core, both at the K4 bar)
# KN is K1's Box-Muller on another stream and K2F fixed K2F's draw over
# its own modulus, both at K1's bar; KD repeats its plain version's float32
# operations in their order (0 expected)
BARS = {"K1": 2e-6, "K2": 2e-6, "K2F": 2e-6, "K3": 2e-6, "K4": 5e-6,
        "K6": 5e-6, "K7": 2e-6, "K8": 2e-6, "K9": 5e-6, "K10": 5e-6,
        "KN": 2e-6, "K2FX": 2e-6, "KD": 2e-6, "K4L": 5e-6}
# the fused K2's unit normals vs threefry.normal_at on the card (the same
# float32 operations and libdevice calls: 0 expected)
DRAW_ULPS = 3
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
# float64 operations/s outside the tensor cores (the same data sheet)
FP64_OPS_PER_S = 34e12
# 32-bit operations per mode, counted from the kernels' source: Threefry-2x32
# is 20 rounds of add, rotate, xor plus 5 key injections of two adds and the
# two initial adds (72), plus the counter split (2); each transcendental
# (logf, sqrtf, sincosf as two, expf) counts as one operation.  K1: the hash,
# |k|^2 (7), the sigma lookup (12), Box-Muller (12) and the amplitude (4).
# K5: the hash, |k|^2 for sigma and for the bin (12), the lookup (12),
# u1 and r^2 (6), amplitude, filter and power (8), the bin guess and edge
# compares (6), the weights and the three float64 adds (6).  K10: K1's draw
# per bulk mode (K10_DRAW_OPS; the plane modes are loaded, not drawn) and
# the x transform's 5 log2(nx) floating-point operations per mode, at the
# main path's nx = 1024.  K2F (and
# K7, which is K2F on a shard): two hashes, each mapped to a normal (the
# mantissa uniform and its clamp 6, erfinv's log1p, sqrt and branch
# arithmetic 9, the 9-term polynomial with its selects 25, two multiplies
# 2: 42), the plane fix's selects (6) and K2's amplitude and multiplies (24).
# KN: K1's count (its hash, Box-Muller and K2's amplitude).  K2F fixed: K2F's
# and the modulus (two multiplies, an add, a sqrtf, two divisions, a compare:
# 7).  KD: |k|^2 (3), the division, the kernel's factor (3), two multiplies.
# KB (auto, isotropic): |k|^2 and its sqrtf (3), the edge compare and the
# mask (3), the power (4), the weight and the three float64 adds (5).  KB's
# geometry pass (isotropic): |k|^2 and its sqrtf (3), the edge compare and
# the mask (3), the weight and the two float64 adds (3).
K10_DRAW_OPS = 74 + 7 + 12 + 12 + 4
OPS_PER_MODE = {"K1": 74 + 7 + 12 + 12 + 4, "K5": 74 + 12 + 12 + 6 + 8 + 6 + 6,
                "K2": 24, "K2F": 2 * (74 + 42) + 6 + 24,
                "K10": K10_DRAW_OPS + 5 * 10, "KN": 74 + 7 + 12 + 12 + 4,
                "K2FX": 2 * (74 + 42) + 6 + 24 + 7, "KD": 9, "KB": 15,
                "KBG": 9}
# KP, a particle (CIC): u = (x + shift) / a, uc, floor and fraction (12 over
# the three axes), the 1 - f (3), and a corner's two weight products, its
# conversion to 2^-s units (multiply, round) and its index (4 more): 8 x 6.
# KC, a mode and constraint of each pass: the two complex products of the
# tables (12) and the mode's term or the alpha sum (4): 16 M a pass.  K4L:
# K4's, plus a multiply, a subtract and expm1f a cell.  KPC, a cell: the
# int64 conversion, two multiplies and a subtract in float64, and the
# rounding to float32 (the total's sum is one add a cell more).
KP_OPS_PER_PARTICLE = 12 + 3 + 8 * 6
KPC_FP64_OPS_PER_CELL = 6
KC_OPS_PER_MODE_AND_CONSTRAINT = 16
# what the redesigned kernels issue a mode and constraint: MEASURE the
# complex product (6), the self-conjugate select, two conversions to float64
# and three float64 operations; CORRECT the product, the select and the
# alpha sums' two multiplies and two adds
KC_DESIGN_OPS = {"measure": 6 + 1 + 2 + 3, "correct": 6 + 1 + 4}
K4L_OPS_PER_CELL = 3
# CUDA vs CPU render at one seed: float32 FFTs of two libraries
SLICE_BAR = 1e-5
# single-seed variance vs prediction at 1024^3
VAR_BAR = 0.10
HEADLINE = (1024, 1024, 1024)
HEADLINE_SPACING = 2.0  # 2048 / n Mpc/h, as bench.py sizes its grids
TIMING_REPS = 5
# the transform lengths the FFT kernels take
FFT_LENGTHS = (16, 32, 64, 128, 256, 512, 1024, 2048)
# repeats of a plain version that takes seconds (K1's, K5's, K10's)
SLOW_PLAIN_REPS = 2
# the constant generate_from_noise folds into K2's amplitude (the draws'
# 1/sqrt(2); the fused K2F folds in the same)
RENDER_GAIN = 0.5 ** 0.5
SAMPLERS = ("threefry", "pallas")
# the slab mesh: four ranks share the one card in a gloo group; a mesh
# render equals the single-device render of its seed (bit-equal expected:
# every step works per line or per mode); the estimator's p_hat differs by
# the forward transform's float32 rounding (hand kernels vs cuFFT)
MESH_RANKS = 4
MESH_BAR = 1e-6
MESH_P_RTOL = 1e-5
MESH_TIMEOUT_S = 600.0
MESH_STAGE_REPS = 2
# the staged variants: the switch, the v4 field against the default field of
# the seed (the same spectrum through K9's passes and K3's, the same plans
# and tables in two kernels, and a reordering copy; the class of SLICE_BAR,
# the difference is printed), a single
# field's binned power against the prediction in sampling sigmas, and the
# seed batch
PIPELINE_ENV = "RF_STAGED_PIPELINE"
V4_BAR = 1e-5
FIELD_POWER_SIGMAS = 6.0
BATCH_SHAPE, BATCH_SPACING, BATCH_SEEDS = (512, 512, 512), 4.0, 4
BATCH_PAIRS = 10


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


def check_close(errs, kid, what, got, want):
    """Fail unless paired tensors agree within BARS[kid] relative; keeps
    the largest absolute error of each kernel in errs[kid]."""
    a, r = rel_err(got, want)
    errs[kid] = max(errs.get(kid, 0.0), a)
    log(f"phase 1 {kid} {what}: max|d| {a:.3e}, rel {r:.3e} "
        f"(bar {BARS[kid]:g})")
    if not r <= BARS[kid]:
        raise AssertionError(f"{kid} {what} disagrees: rel {r:.3e}")


@contextlib.contextmanager
def staged_variant(name):
    """RF_STAGED_PIPELINE set to ``name`` inside the block (unset for None)
    and restored after it."""
    old = os.environ.pop(PIPELINE_ENV, None)
    if name is not None:
        os.environ[PIPELINE_ENV] = name
    try:
        yield
    finally:
        os.environ.pop(PIPELINE_ENV, None)
        if old is not None:
            os.environ[PIPELINE_ENV] = old


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


def timed_peak(torch, fn, reps=TIMING_REPS):
    """(cuda_ms of fn, "X GiB (Y above the Z held)"): the peak device
    memory of one call."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    text = (f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} above the "
            f"{base / 2**30:.3f} held)")
    return cuda_ms(torch, fn, reps), text


def phase0_attributes(card):
    """Registers a thread and blocks an SM of every instance of K3 (both
    signs), K4, K6, K9 and K10, as cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor report them (registers
    are what the register-radix core runs short of; K10 with the knots of
    the 1024^3 scene's table)."""
    from randomfield_tpu_torch.ops import fft, genfft, sampler

    knots = sampler.table_knot_count(HEADLINE)

    for n in FFT_LENGTHS:
        plan = "*".join(map(str, fft.radix_plan(n)))
        panel = f"panel {fft.rotate_panel(n)}"
        rows = [("K3 fft_axis inverse", panel,
                 fft.kernel_attributes("fft_axis", n, +1)),
                ("K3 fft_axis forward", panel,
                 fft.kernel_attributes("fft_axis", n, -1)),
                ("K4 c2r_tail", f"nz = {2 * n}",
                 fft.kernel_attributes("c2r_tail", n)),
                ("K6 r2c_head", f"nz = {2 * n}",
                 fft.kernel_attributes("r2c_head", n)),
                ("K9 ifft_rotate", panel,
                 fft.kernel_attributes("ifft_rotate", n)),
                ("K10 sample_fftx", f"nx = {n}, {knots} knots",
                 genfft.kernel_attributes(n, knots))]
        for name, what, (regs, blocks, threads, smem) in rows:
            log(f"phase 0 {name} n = {n} = {plan}, {what}: {regs} registers a "
                f"thread, {blocks} blocks an SM of {threads} threads and "
                f"{smem} bytes of shared memory [{card}]")
            if regs <= 0 or blocks <= 0:
                raise AssertionError(f"{name} n = {n}: no such instance")


# the hashing kernels' SASS: (a pattern of the function's name, hashes a
# mode); K8 is K1's kernel on a shard and K7 K2F's.  K2F's pattern is its
# spectrum instance with 32-bit counters, the one a 1024^3 render runs
# (draw_scale_kernel<0, false>), or the one instance of spectrum mode
# before the counter width was a template parameter; its loop holds two
# modes, four hashes
SASS_KERNELS = {"K1": ("sample_modes_kernel", 1),
                "K2F": (r"draw_scale_kernelILi0E(?:Lb0E)?E", 2),
                "K5": ("power_bins_kernel", 1),
                "KN": (r"nested_modes_kernelILi0EE", 1),
                "K2FX": (r"draw_scale_kernelILi3ELb0EE", 2)}
# K2F's spectrum instance (draw_scale_kernel<0, false>, the one a 1024^3
# render runs): its registers and hot SASS instructions a mode as built for
# sm_90a since its x-row-pair walk; the other modes of the same template
# must not move them
K2F_SPECTRUM_SASS = (54, 363.0)
# rotations of one Threefry-2x32 hash (threefry.cuh), each a funnel shift or
# a byte permute in SASS
ROTATIONS_PER_HASH = 20


def sass_functions(lib, cuobjdump):
    """{function: [(address, instruction)]} of a library's SASS, and
    {function: registers a thread} (``cuobjdump -sass`` and ``-res-usage``:
    the registers ``nvcc -Xptxas -v`` reports)."""
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=600, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs, res_usage(lib, cuobjdump)


def res_usage(lib, cuobjdump):
    """{function: registers a thread} of a library (``cuobjdump
    -res-usage``: the registers ``nvcc -Xptxas -v`` reports)."""
    text = subprocess.run([cuobjdump, "-res-usage", str(lib)],
                          capture_output=True, text=True, timeout=600,
                          check=True).stdout
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"Function (\S+?):?\s+REG:(\d+)", text)}


def hash_loop(instrs):
    """(span, hot, rotations) of the smallest loop (the span of a backward
    branch) that holds a hash's rotations: the per-mode loop of a hashing
    kernel.  ``span`` counts every instruction in it; ``hot`` leaves out
    each inner loop or call with the smallest range a forward branch skips
    around it: the cold paths laid out inside the loop (libdevice's slow
    paths of sincosf and sqrtf, a run's flush in K5, the rare steps of a
    bin search)."""
    branches = []
    for addr, text in instrs:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        if m:
            branches.append((addr, int(m.group(1), 16)))
    calls = [a for a, t in instrs if t.split()[0].startswith("CALL")
             or (t.startswith("@") and t.split()[1].startswith("CALL"))]
    best = None
    for addr, first in branches:
        if first >= addr:
            continue
        body = [(a, t) for a, t in instrs if first <= a <= addr]
        rot = sum(1 for _, t in body
                  if re.match(r"(@!?U?P\w+ )?(SHF\.[LR]\.W|PRMT)", t))
        if rot >= ROTATIONS_PER_HASH // 2 and (best is None
                                                or len(body) < len(best[0])):
            best = (body, rot, first, addr)
    body, rot, first, last = best
    skips = [(at, to) for at, to in branches if first <= at < to <= last]
    cold = set()
    # each inner loop or call, with the smallest forward skip around it
    inner = [(t, a) for a, t in branches if first < t < a < last]
    inner += [(c, c) for c in calls if first < c < last]
    for lo, hi in inner:
        around = [(at, to) for at, to in skips if at < lo and hi < to]
        at, to = (min(around, key=lambda r: r[1] - r[0]) if around
                  else (lo - 1, hi + 1))
        cold.update(a for a, _ in body if at < a < to)
    return len(body), len(body) - len(cold), rot


def sass_counts(lib, cuobjdump):
    """{K: (registers, loop span, hot instructions, hashes in the loop,
    hot instructions a mode)} of the hashing kernels in the library
    ``lib`` (those it holds: another commit's may lack the newer ones)."""
    funcs, regs = sass_functions(lib, cuobjdump)
    out = {}
    for kid, (frag, hashes_a_mode) in SASS_KERNELS.items():
        name = next((f for f in funcs if re.search(frag, f)), None)
        if name is None:
            continue
        span, hot, rot = hash_loop(funcs[name])
        hashes = max(1, round(rot / ROTATIONS_PER_HASH))
        out[kid] = (regs.get(name, -1), span, hot, hashes,
                    hot * hashes_a_mode / hashes)
    return out


def phase0_sass(torch, card):
    """Registers and the SASS loop body a mode of K1 (and K8), K2F (and K7)
    and K5, and the time the hot instructions take at the card's issue
    rate: one warp instruction a clock on each of an SM's four schedulers
    at the maximum SM clock (nvidia-smi), over the 1024^3 modes (K7 and
    K8: a quarter)."""
    from randomfield_tpu_torch.ops import _build

    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    nx, ny, nz = HEADLINE
    modes = nx * ny * (nz // 2 + 1)
    counts = sass_counts(_build.library_path(), _build.cuda_tool("cuobjdump"))
    missing = set(SASS_KERNELS) - set(counts)
    if missing:
        raise AssertionError(f"no SASS function of {sorted(missing)}")
    counts["K8"] = counts["K1"]
    counts["K7"] = counts["K2F"]
    regs, hot = counts["K2F"][0], counts["K2F"][4]
    log(f"phase 0 K2F spectrum instance: {regs} registers, {hot:.1f} hot "
        f"instructions a mode; expected {K2F_SPECTRUM_SASS[0]}, "
        f"{K2F_SPECTRUM_SASS[1]:.1f}")
    if (regs, hot) != K2F_SPECTRUM_SASS:
        raise AssertionError("adding K2F's fixed mode moved its spectrum "
                             "instance")
    regs, hot = counts["K5"][0], counts["K5"][4]
    log(f"phase 0 K5: {regs} registers, {hot:.1f} hot instructions a mode; "
        f"expected {K5_SASS[0]}, {K5_SASS[1]:.1f} (its binning code in "
        f"csrc/bins_common.cuh)")
    if (regs, hot) != K5_SASS:
        raise AssertionError("K5's binning code moved")
    instances = []
    for f, r in sorted(res_usage(_build.library_path(),
                                 _build.cuda_tool("cuobjdump")).items()):
        m = re.search(r"bin_spectrum_kernelILi(\d)ELi(\d)E", f)
        if m:
            instances.append(f"<{m.group(1)}, {m.group(2)}> {r}")
    log(f"phase 0 KB bin_spectrum_kernel<KIND, OUT> (KIND 4: the geometry "
        f"pass; OUT 3: the read probe): registers a thread, "
        f"{', '.join(instances)} [{card}]")
    if len(instances) != 18:
        raise AssertionError("KB's instances are missing from the library")
    kb_plans(card)
    for kid, (regs, span, hot, hashes, per_mode) in counts.items():
        n_modes = modes // MESH_RANKS if kid in ("K7", "K8") else modes
        ms = 1e3 * per_mode * n_modes / 32 / (sms * 4 * clock_mhz * 1e6)
        log(f"phase 0 {kid} SASS: {regs} registers a thread; loop body {span} "
            f"instructions, {hot} outside its cold paths, for {hashes} "
            f"hash(es): {per_mode:.1f} a mode; at {sms} SMs x 4 schedulers x "
            f"{clock_mhz:.0f} MHz those issue in {ms:.3f} ms over {n_modes} "
            f"modes [{card}]")
    return counts


def kb_plans(card):
    """KB's launch plan at the 1024^3 estimators' shapes, each kind and
    output (and MAX_BINS): warps a block, stages, blocks, shared memory."""
    from randomfield_tpu_torch.ops import binning

    nx, ny, nz = HEADLINE
    rows = []
    for kind in KB_KINDS + ("geometry",):
        for what, mode, nbins, nmu in (
                ("isotropic", 0, NBINS, 1), ("multipoles", 1, NBINS, 1),
                ("4 wedges", 2, NBINS, 4), ("probe", 3, 1, 1),
                ("multipoles at MAX_BINS", 1, binning.MAX_BINS, 1)):
            if kind == "geometry" and mode in (1, 3):
                continue
            w, st, b, sm, ch, nch = binning.launch_plan(kind, mode, nx, ny,
                                                        nz, nbins, nmu)
            rows.append(f"{kind} {what}: {w} warps, {st} stages, {b} "
                        f"blocks, {sm} B, {nch} chunks of {ch} tiles")
    log(f"phase 0 KB plans at {HEADLINE} (a tile: 4 kz lines): "
        f"{'; '.join(rows)} [{card}]")


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
        check_close(errs, kid, what, got, want)

    def check_k3(outer, n, inner, sign=+1):
        kernel, plain = ((fft.ifft_axis, fft.ifft_axis_plain) if sign > 0
                         else (fft.fft_axis, fft.fft_axis_plain))
        re, im = randn(outer, n, inner), randn(outer, n, inner)
        a, b = kernel(re.clone(), im.clone(), outer, n, inner)
        c, d = plain(re.clone(), im.clone(), outer, n, inner)
        torch.cuda.synchronize()
        record("K3", f"{'inverse' if sign > 0 else 'forward'} ({outer}, {n}, "
               f"{inner})", (a, b), (c, d))

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

    # every length the kernels take, at smaller sizes.  K3, both signs: one
    # outer group and several; inner counts that fill no panel (8..64
    # columns a block), inner = 513 (a render's y pass) and one column
    for n in FFT_LENGTHS:
        panel = fft.rotate_panel(n)
        for outer, inner in ((1, 2**22 // n + 5), (max(2, 2**22 // (n * 513)), 513),
                             (max(2, 2**16 // n), 1), (5, 3 * panel + 7)):
            for sign in (+1, -1):
                check_k3(outer, n, inner, sign)
    # K4: line counts that fill no block (256 E / m lines a block), one line
    for m in FFT_LENGTHS:
        w = torch.rand(2 * m, generator=gen, device=dev) + 0.5
        for lines in (2**22 // m + 3, 1):
            check_k4((lines,), 2 * m, w)


def max_ulps(torch, a, b):
    """The largest float32 ulp distance between two equal-shaped tensors of
    finite values of one sign pattern, slab by slab along the second axis."""
    worst = 0
    for x0 in range(0, a.shape[1], 64):
        d = (a[:, x0:x0 + 64].view(torch.int32).long()
             - b[:, x0:x0 + 64].view(torch.int32).long())
        worst = max(worst, int(d.abs().max()))
    return worst


def phase1_draw_scale(torch, g, errs):
    """The fused K2 (draw_scale) vs its plain chain on the card at the
    1024^3 main path's shapes, table and gain: its device normal
    (draw_normals) over all 2^23 inputs within DRAW_ULPS of the plain
    normal, with the count of inputs that differ; the bits of its hash
    equal to threefry.bits_at's, its unit normals within DRAW_ULPS of
    threefry.normal_at's, its spectrum (s = 0 and 8) within the K2 bar of
    draw_scale_plain's (unit draws -> Hermitian fix -> scale_sigma_plain);
    fills errs["K2F"]."""
    from randomfield_tpu_torch.ops import sample, sampler, threefry

    seed, table, shape, spacing = 17, g.state.table, g.shape, g.grid_spacing
    # the device normal alone, over every input it can take: it reads only
    # bits >> 9, so the 2^23 words v << 9 cover erfinv's tail branch too
    bits = torch.arange(2**23, dtype=torch.int64, device=g.device) << 9
    got = sampler.draw_normals(bits)
    want = threefry._normal_from_bits(bits)
    torch.cuda.synchronize()
    d = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs()
    ulps, differ = int(d.max()), int((d > 0).sum())
    log(f"phase 1 K2F jax_normal over all 2^23 inputs vs the plain normal: "
        f"{differ} differ, max {ulps} ulps (bar {DRAW_ULPS})")
    if not ulps <= DRAW_ULPS:
        raise AssertionError(f"draw_scale's jax_normal is {ulps} ulps off")
    del bits, got, want, d
    key = threefry.key_from_seed(seed)
    got = sampler.draw_bits(seed, table, shape)
    want = torch.stack(sample.canonical_bits_reim(key, shape, g.device))
    torch.cuda.synchronize()
    exact = torch.equal(got, want)
    log(f"phase 1 K2F draw_scale bits {tuple(got.shape)} vs threefry.bits_at: "
        f"{'equal' if exact else 'DIFFER'}")
    if not exact:
        raise AssertionError("draw_scale's hash is not JAX's Threefry")
    del got, want
    torch.cuda.empty_cache()
    got = sampler.draw_scale(seed, table, shape, spacing, unit=True)
    want = torch.stack(sample.unit_draws_reim(key, shape, g.device))
    torch.cuda.synchronize()
    ulps = max_ulps(torch, got, want)
    log(f"phase 1 K2F draw_scale unit normals {tuple(got.shape)} vs "
        f"threefry.normal_at: max {ulps} ulps (bar {DRAW_ULPS})")
    if not ulps <= DRAW_ULPS:
        raise AssertionError(f"draw_scale's normals are {ulps} ulps off")
    del got, want
    torch.cuda.empty_cache()
    for s_ in (0.0, 8.0):
        got = sampler.draw_scale(seed, table, shape, spacing, s_)
        want = sampler.draw_scale_plain(seed, table, shape, spacing, s_)
        torch.cuda.synchronize()
        same = "bit-equal" if torch.equal(got, want) else "not bit-equal"
        check_close(errs, "K2F", f"{tuple(got.shape)} s={s_} ({same})",
                    (got[0], got[1]), (want[0], want[1]))
        del got, want
        torch.cuda.empty_cache()


def phase1_sampler(torch, g, errs):
    """K1 and K5 vs their plain versions at the 1024^3 shapes and table of
    the sampler='pallas' scene ``g``; fills errs["K1"], errs["K5"].  Both
    plain versions are the raw draws with the plane fix after them: K1's
    seeded_spectrum_plain (raw draws, the planes made Hermitian), K5's
    seeded_power_bins_plain (power_bins_plain plus plane_bins)."""
    from randomfield_tpu_torch.ops import grid, sampler, transform
    from randomfield_tpu_torch.validate import stats

    seed, table = 17, g.state.table
    shape, spacing = g.shape, g.grid_spacing
    for s in (0.0, 8.0):
        a, b = sampler.sample_modes(seed, table, shape, spacing, s)
        c, d = sampler.seeded_spectrum_plain(seed, table, shape, spacing, s)
        torch.cuda.synchronize()
        abs_err, r = rel_err((a, b), (c, d))
        errs["K1"] = max(errs.get("K1", 0.0), abs_err)
        del c, d
        hermitian = True
        for p in grid.self_conjugate_kz_planes(shape[2]):
            fre, fim = transform.symmetrize_plane_reim(a[..., p], b[..., p],
                                                       False)
            hermitian &= torch.equal(fre, a[..., p]) and torch.equal(fim,
                                                                     b[..., p])
        log(f"phase 1 K1 {tuple(a.shape)} s={s} vs the raw draws plus the "
            f"plane fix: max|d| {abs_err:.3e}, rel {r:.3e} (bar "
            f"{BARS['K1']:g}); its kz = 0 and Nyquist planes "
            f"{'exactly Hermitian' if hermitian else 'NOT Hermitian'}")
        if not r <= BARS["K1"] or not hermitian:
            raise AssertionError(f"K1 s={s} disagrees: rel {r:.3e}")
        del a, b
        torch.cuda.empty_cache()

    edges, _ = stats.bin_setup(shape, spacing, NBINS)
    acc = sampler.sample_power_bins(seed, table, shape, spacing, 0.0, edges)
    again = sampler.sample_power_bins(seed, table, shape, spacing, 0.0, edges)
    want = sampler.seeded_power_bins_plain(seed, table, shape, spacing, 0.0,
                                           edges)
    torch.cuda.synchronize()
    log(f"phase 1 K5 repeatability, two calls of seed {seed}: "
        f"{'bit-identical' if torch.equal(acc, again) else 'DIFFERENT'}")
    if not torch.equal(acc, again):
        raise AssertionError("K5 is not repeatable bit for bit")
    if not torch.equal(acc[0], want[0]):
        raise AssertionError(f"K5 counts differ from plain: "
                             f"{(acc[0] - want[0]).abs().max()}")
    live = want[0] > 0
    sums_rel = float(((acc[1:] - want[1:]).abs() / want[1:].abs())[:, live].max())
    errs["K5"] = float((acc - want).abs().max())
    log(f"phase 1 K5 {shape} nbins={NBINS} vs power_bins_plain plus "
        f"plane_bins: counts equal (total {float(acc[0].sum()):.0f}), sums "
        f"max rel {sums_rel:.3e} (bar {K5_SUM_RTOL:g}), max|d| "
        f"{errs['K5']:.3e}")
    if not sums_rel <= K5_SUM_RTOL:
        raise AssertionError("K5 disagrees with its plain version")
    del want, again

    re, im = sampler.sample_spectrum(seed, table, shape, spacing, 0.0)
    k, p, n = stats.spectrum_power((re, im), shape, spacing, NBINS)
    del re, im
    counts, psum, ksum = acc.cpu().numpy()
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
    (the reason K5 bins by the edge search itself); logged, not a check."""
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


def phase1_mesh_kernels(torch, g, gp, errs):
    """The slab mesh's kernels vs their plain versions at the 1024^3 mesh
    paths' shapes: K6 and forward K3 where the one-rank forward transform
    runs them (and forward K3 over a sweep of lengths), K7 and K8 on each
    shard of a four-rank mesh, whose unions must equal whole-grid
    draw_scale and K1 of the same seed bit for bit."""
    from randomfield_tpu_torch.ops import fft, sampler

    dev = g.device
    gen = torch.Generator(device=dev).manual_seed(5)
    nx, ny, nz = g.shape
    nzh = nz // 2 + 1

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = randn(nx, ny, nz)
    got = fft.r2c_head(x)
    want = fft.r2c_head_plain(x)
    torch.cuda.synchronize()
    check_close(errs, "K6", f"{tuple(x.shape)}", got, want)
    del x, got, want
    torch.cuda.empty_cache()
    # every length the kernel takes; line counts that do not fill the last
    # block (a block owns 2..64 lines), and one line
    for m in FFT_LENGTHS:
        for lines in (2**21 // m + 3, 1):
            x = randn(lines, 2 * m)
            got = fft.r2c_head(x)
            want = fft.r2c_head_plain(x)
            torch.cuda.synchronize()
            check_close(errs, "K6", f"({lines}, {2 * m})", got, want)
    del x, got, want
    torch.cuda.empty_cache()

    def check_forward(outer, n, inner):
        re, im = randn(outer, n, inner), randn(outer, n, inner)
        got = fft.fft_axis(re.clone(), im.clone(), outer, n, inner)
        want = fft.fft_axis_plain(re.clone(), im.clone(), outer, n, inner)
        torch.cuda.synchronize()
        check_close(errs, "K3", f"forward ({outer}, {n}, {inner})", got, want)

    # the y and x passes (the other lengths: phase 1's sweep of both signs)
    check_forward(nx, ny, nzh)
    check_forward(1, nx, ny * nzh)
    torch.cuda.empty_cache()

    ny_loc = ny // MESH_RANKS
    whole = sampler.draw_scale(17, g.state.table, g.shape, g.grid_spacing)
    k1 = sampler.sample_modes(17, gp.state.table, gp.shape, gp.grid_spacing)
    for r in range(MESH_RANKS):
        rows = slice(r * ny_loc, (r + 1) * ny_loc)
        got = sampler.draw_scale_shard(17, g.state.table, g.shape,
                                       g.grid_spacing, 0.0, r * ny_loc, ny_loc)
        want = sampler.draw_scale_plain(17, g.state.table, g.shape,
                                        g.grid_spacing, 0.0, 0, r * ny_loc,
                                        None, ny_loc)
        torch.cuda.synchronize()
        check_close(errs, "K7", f"shard {r} {tuple(got[0].shape)}",
                    (got[0], got[1]), (want[0], want[1]))
        if not torch.equal(got, whole[:, :, rows]):
            raise AssertionError(f"K7 shard {r} is not whole-grid "
                                 f"draw_scale's rows")
        got = sampler.sample_shard(17, gp.state.table, gp.shape,
                                   gp.grid_spacing, 0.0, r * ny_loc, ny_loc)
        want = sampler.seeded_spectrum_plain(17, gp.state.table, gp.shape,
                                             gp.grid_spacing, 0.0, r * ny_loc,
                                             ny_loc)
        torch.cuda.synchronize()
        check_close(errs, "K8", f"shard {r} {tuple(got[0].shape)} (the raw "
                    f"draws plus the plane fix)", got, want)
        if not all(torch.equal(a, b[:, rows]) for a, b in zip(got, k1)):
            raise AssertionError(f"K8 shard {r} is not whole-grid K1's rows")
    log(f"phase 1 K7 and K8: the union of the {MESH_RANKS} shards equals "
        f"whole-grid draw_scale and K1 bit for bit")
    del whole, k1, got, want
    torch.cuda.empty_cache()


def phase1_staged_kernels(torch, gp, errs):
    """K9 and K10 vs their plain versions at the shapes the 1024^3 v4 and v6
    renders of the scene ``gp`` give them: K9 on a render's own spectrum (the
    x pass, then the y pass on the x pass's result) and over a sweep of
    lengths with several groups; K10 on the seed's own bits and planes, bulk
    rows and plane rows apart, with and without smoothing."""
    from randomfield_tpu_torch.ops import fft, genfft, sampler

    dev = gp.device
    seed, table = 17, gp.state.table
    shape, spacing = gp.shape, gp.grid_spacing
    nx, ny, nz = shape
    nzh = nz // 2 + 1

    re, im = sampler.sample_spectrum(seed, table, shape, spacing)
    for what, n, cols in (("x", nx, ny * nzh), ("y", ny, nzh * nx)):
        got = fft.ifft_rotate(re, im, 1, n, cols)
        want = fft.ifft_rotate_plain(re, im, 1, n, cols)
        torch.cuda.synchronize()
        check_close(errs, "K9", f"{what} pass (1 group, n = {n}, {cols} columns)",
                    got, want)
        del re, im, want
        re, im = got  # (ny nzh, nx) after x: the y pass's input
        del got
    del re, im
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(9)
    # every length the kernel takes; column counts that do not fill the last
    # panel (8..64 columns), and one column
    for n in FFT_LENGTHS:
        for groups, cols in ((3, 2**22 // (3 * n) + 3), (2, 5), (1, 1)):
            re = torch.randn((groups * n, cols), generator=gen, device=dev)
            im = torch.randn((groups * n, cols), generator=gen, device=dev)
            got = fft.ifft_rotate(re, im, groups, n, cols)
            want = fft.ifft_rotate_plain(re, im, groups, n, cols)
            torch.cuda.synchronize()
            check_close(errs, "K9", f"({groups} groups, n = {n}, {cols} "
                        f"columns)", got, want)
    del re, im, got, want
    torch.cuda.empty_cache()

    m = nz // 2
    for s in (0.0, 8.0):
        planes = genfft.plane_spectra(seed, table, shape, spacing, s)
        a, b = genfft.sample_fftx(seed, table, shape, spacing, s, planes=planes)
        c, d = genfft.seeded_fftx_plain(seed, table, shape, spacing, s,
                                        planes=planes)
        torch.cuda.synchronize()
        bulk = slice(ny, m * ny)
        check_close(errs, "K10", f"{tuple(a.shape)} s={s} bulk rows",
                    (a[bulk], b[bulk]), (c[bulk], d[bulk]))
        lo, hi = slice(0, ny), slice(m * ny, None)
        check_close(errs, "K10", f"{tuple(a.shape)} s={s} plane rows",
                    (a[lo], a[hi], b[lo], b[hi]), (c[lo], c[hi], d[lo], d[hi]))
        del a, b, c, d, planes
        torch.cuda.empty_cache()


def reset_counts():
    from randomfield_tpu_torch.ops import fft, genfft, sampler

    from randomfield_tpu_torch.ops import derived

    sampler.K1_LAUNCHES = sampler.K2_LAUNCHES = sampler.K5_LAUNCHES = 0
    sampler.K2F_LAUNCHES = 0
    sampler.K7_LAUNCHES = sampler.K8_LAUNCHES = 0
    fft.K3_LAUNCHES = fft.K4_LAUNCHES = fft.K6_LAUNCHES = 0
    fft.K9_LAUNCHES = genfft.K10_LAUNCHES = 0
    sampler.KN_LAUNCHES = sampler.K2FX_LAUNCHES = derived.KD_LAUNCHES = 0
    from randomfield_tpu_torch.ops import binning, transform

    binning.KB_LAUNCHES = binning.KB_GEOMETRY_LAUNCHES = 0
    transform.TORCH_FFT_CALLS = 0
    from randomfield_tpu_torch.ops import constraint, paint

    paint.KP_LAUNCHES = paint.KPC_LAUNCHES = 0
    constraint.KC_LAUNCHES = fft.K4L_LAUNCHES = 0


def read_counts():
    """The launches of every kernel, and "torch.fft": the 3-D transforms of
    CUDA tensors that went to torch.fft (grids the kernels do not take)."""
    from randomfield_tpu_torch.ops import binning, fft, genfft, sampler
    from randomfield_tpu_torch.ops import transform

    from randomfield_tpu_torch.ops import derived

    return {"KB": binning.KB_LAUNCHES,
            "KBG": binning.KB_GEOMETRY_LAUNCHES,
            "torch.fft": transform.TORCH_FFT_CALLS,
            "K1": sampler.K1_LAUNCHES, "K2": sampler.K2_LAUNCHES,
            "K2F": sampler.K2F_LAUNCHES, "K3": fft.K3_LAUNCHES,
            "K4": fft.K4_LAUNCHES, "K5": sampler.K5_LAUNCHES,
            "K6": fft.K6_LAUNCHES,
            "K7": sampler.K7_LAUNCHES, "K8": sampler.K8_LAUNCHES,
            "K9": fft.K9_LAUNCHES, "K10": genfft.K10_LAUNCHES,
            "KN": sampler.KN_LAUNCHES, "K2FX": sampler.K2FX_LAUNCHES,
            "KD": derived.KD_LAUNCHES, **mock_counts()}


def require_launches(counts, least, what):
    """Fail unless every kernel in ``least`` launched at least that often."""
    short = {k: counts[k] for k, n in least.items() if counts[k] < n}
    if short:
        raise AssertionError(f"{what} skipped a kernel: {counts}")


def phase2_slice(torch, rft, dev):
    """CUDA render vs CPU (plain) render at 128^3, seed 7, both samplers."""
    shape, spacing, seed = (128, 128, 128), 16.0, 7
    first = {"threefry": "K2F", "pallas": "K1"}
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


def phase2_variants(torch, rft, dev):
    """The v4 and v6 renders on the card vs the CPU (plain) render of the
    same variant at 128^3, seed 7; the switch is set around each."""
    shape, spacing, seed = (128, 128, 128), 16.0, 7
    g_dev = rft.Generator(*shape, grid_spacing=spacing, device=dev,
                          sampler="pallas")
    g_cpu = rft.Generator(*shape, grid_spacing=spacing, device="cpu",
                          sampler="pallas")
    need = {"v4": {"K1": 1, "K9": 2, "K4": 1}, "v6": {"K10": 1, "K3": 1, "K4": 1}}
    for variant, least in need.items():
        for s in (0.0, 20.0):
            with staged_variant(variant):
                reset_counts()
                got = g_dev.generate_delta_field(seed, smoothing_length=s)
                torch.cuda.synchronize()
                counts = read_counts()
                want = g_cpu.generate_delta_field(seed, smoothing_length=s)
            _, r = rel_err((got.cpu(),), (want,))
            log(f"phase 2 slice pallas {variant} {shape} seed {seed} s={s}: rel "
                f"{r:.3e} (bar {SLICE_BAR:g}), launches {counts}")
            if not r <= SLICE_BAR:
                raise AssertionError(f"CUDA {variant} render disagrees with "
                                     f"CPU: rel {r:.3e}")
            require_launches(counts, least, f"{variant} render")


def phase2_gate(torch, dev, stream="modes"):
    """The sampler='pallas' statistical gate on the card: K1's stream, or
    (``stream='genfft'``) the v6 stream of K10."""
    from randomfield_tpu_torch.validate import sampler_gate

    t0 = time.perf_counter()
    out = sampler_gate.run_checks(GATE_SEEDS, GATE_SHAPE, device=dev,
                                  stream=stream)
    which = "" if stream == "modes" else " (v6 stream, K10)"
    log(f"phase 2 sampler gate{which} {GATE_SHAPE}, {GATE_SEEDS} seeds: per-mode max "
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
    first = "K1" if g.sampler == "pallas" else "K2F"
    require_launches(counts, {first: 2, "K3": 4, "K4": 2}, "main path")
    return counts


def phase3_noise(torch, g):
    """generate_noise -> generate_from_noise at 1024^3 through the public
    API of the threefry scene ``g``, held to generate_delta_field of the seed
    bit for bit: the fused kernel's unit mode, then the Hermitian fix and K2
    scale_sigma on the caller's draws; returns the launch counts."""
    nx, ny, nz = g.shape
    want = g.generate_delta_field(seed=4)
    torch.cuda.synchronize()
    reset_counts()
    noise = g.generate_noise(seed=4)
    got = g.generate_from_noise(noise)
    torch.cuda.synchronize()
    counts = read_counts()
    equal = torch.equal(got, want)
    log(f"phase 3 main path generate_noise -> generate_from_noise {g.shape}: "
        f"noise {tuple(noise.shape)} {noise.dtype}, field "
        f"{'bit-equal to' if equal else 'DIFFERS from'} "
        f"generate_delta_field(4); launches {counts}")
    if tuple(noise.shape) != (2, nx, ny, nz // 2 + 1) or not equal:
        raise AssertionError("generate_from_noise(generate_noise(s)) is not "
                             "generate_delta_field(s)")
    require_launches(counts, {"K2F": 1, "K2": 1, "K3": 2, "K4": 1},
                     "noise round trip")
    del want, noise, got
    torch.cuda.empty_cache()
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
    # one K5 launch over the batch (a grid column per seed)
    require_launches(counts, {"K5": 1}, "config 4")
    if p.shape != (ENSEMBLE_SEEDS, NBINS) or not np.all(np.isfinite(p[:, n > 0])):
        raise AssertionError(f"ensemble p_hat has shape {p.shape} or is not finite")
    singles = [g.sample_power(s_, nbins=NBINS) for s_ in range(ENSEMBLE_SEEDS)]
    rows_equal = all(np.array_equal(k, k1) and np.array_equal(row, p1)
                     and np.array_equal(n, n1)
                     for row, (k1, p1, n1) in zip(p, singles))
    log(f"phase 3 config 4: the {ENSEMBLE_SEEDS} rows "
        f"{'bit-equal to' if rows_equal else 'DIFFER from'} single "
        f"sample_power calls")
    if not rows_equal:
        raise AssertionError("sample_power_batch rows are not sample_power")
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


def phase3_variants(torch, rft, gp, card):
    """This slice's paths at 1024^3 through the public API of the
    sampler='pallas' scene ``gp``, the switch set around each render: v4
    against the default field of the seed, v6 against its predictions; then
    a 4-seed 512^3 batch against single renders.  Returns the launch counts
    of the three runs, summed."""
    from randomfield_tpu_torch.ops import genfft

    seed = 1
    total = dict.fromkeys(KERNEL_ORDER, 0)

    def add(counts):
        for k in KERNEL_ORDER:
            total[k] += counts[k]

    with staged_variant(None):
        default = gp.generate_delta_field(seed)
    peak = float(default.abs().max())
    with staged_variant("v4"):
        torch.cuda.synchronize()
        reset_counts()
        f4 = gp.generate_delta_field(seed)
        torch.cuda.synchronize()
        counts = read_counts()
    diff = float((f4 - default).abs().max())
    log(f"phase 3 main path sampler='pallas' v4 {HEADLINE}: vs the default "
        f"(v5) field of seed {seed}, max|d| {diff:.3e}, max|d| / max|delta| "
        f"{diff / peak:.3e} (bar {V4_BAR:g}), "
        f"{'bit-equal' if torch.equal(f4, default) else 'not bit-equal'}; "
        f"launches {counts}")
    if tuple(f4.shape) != HEADLINE or not diff <= V4_BAR * peak:
        raise AssertionError("the v4 render is not the default render "
                             "within two float32 transforms' rounding")
    require_launches(counts, {"K1": 1, "K9": 2, "K4": 1}, "v4 main path")
    add(counts)
    del f4

    with staged_variant("v6"):
        torch.cuda.synchronize()
        reset_counts()
        f6 = gp.generate_delta_field(seed)
        again = gp.generate_delta_field(seed)
        torch.cuda.synchronize()
        counts = read_counts()
        if not torch.equal(f6, again):
            raise AssertionError("v6: same seed, different fields")
        del again
        unweighted = gp.generate_delta_field(seed, apply_lightcone=False)
    if tuple(f6.shape) != HEADLINE or not bool(torch.isfinite(f6).all()):
        raise AssertionError("v6 field has the wrong shape or non-finite values")
    apart = float((f6 - default).abs().max()) / peak
    del default
    var = field_variance(torch, f6)
    pred = gp.predicted_variance(apply_lightcone=True)
    del f6
    k, p, n = gp.calculate_power(unweighted, nbins=NBINS)
    del unweighted
    kt, pt, nt = predicted_bins(torch, gp)
    if not np.array_equal(n, nt):
        raise AssertionError("the v6 field and the prediction bin different modes")
    pop = n > 0
    # per bin, n/2 independent complex modes with exponential |c|^2
    z = (p[pop] - pt[pop]) / (pt[pop] * np.sqrt(2.0 / n[pop]))
    log(f"phase 3 main path sampler='pallas' v6 {HEADLINE} (stream "
        f"{genfft.STREAM}): same seed twice bit-equal; max|v6 - v5| / "
        f"max|delta| {apart:.3f}; var {var:.6g}, predicted {pred:.6g}, ratio "
        f"{var / pred:.5f} (bar {VAR_BAR:g}); calculate_power vs the binned "
        f"prediction max |z| {np.abs(z).max():.3f} over {int(pop.sum())} bins "
        f"(bar {FIELD_POWER_SIGMAS:g}); launches {counts}")
    if not apart > 0.1:
        raise AssertionError("v6 drew the default family's field")
    if not abs(var / pred - 1.0) <= VAR_BAR:
        raise AssertionError(f"v6 variance off prediction: {var / pred:.4f}")
    if not np.all(np.abs(z) <= FIELD_POWER_SIGMAS):
        raise AssertionError(f"v6 P(k) off prediction: z {z}")
    require_launches(counts, {"K10": 2, "K3": 2, "K4": 2}, "v6 main path")
    add(counts)
    torch.cuda.empty_cache()

    gb = rft.Generator(*BATCH_SHAPE, grid_spacing=BATCH_SPACING,
                       device=gp.device, sampler="pallas")
    seeds = list(range(BATCH_SEEDS))
    with staged_variant(None):
        torch.cuda.synchronize()
        reset_counts()
        batch = gb.generate_delta_fields(seeds)
        torch.cuda.synchronize()
        counts = read_counts()
        rows_equal = all(torch.equal(row, gb.generate_delta_field(s_))
                         for row, s_ in zip(batch, seeds))
    log(f"phase 3 seed batch sampler='pallas' {BATCH_SHAPE}: "
        f"generate_delta_fields of {BATCH_SEEDS} seeds -> {tuple(batch.shape)}, "
        f"rows {'bit-equal to' if rows_equal else 'DIFFER from'} single "
        f"renders; launches {counts} [{card}]")
    if tuple(batch.shape) != (BATCH_SEEDS, *BATCH_SHAPE) or not rows_equal:
        raise AssertionError("the seed batch is not its single renders")
    require_launches(counts, {"K1": BATCH_SEEDS, "K3": 2 * BATCH_SEEDS,
                              "K4": BATCH_SEEDS}, "seed batch")
    add(counts)
    del batch
    torch.cuda.empty_cache()
    return total


# ---- the slab mesh: four ranks on the card (gloo), one rank (NCCL) ----------

GLOO = " (gloo through host memory)"


def host_stage_times(torch, stages, first, reps):
    """Median host-clock ms of each stage over ``reps`` runs, the device
    synchronized before and after each stage (the exchanges block the host
    anyway); returns (ms by name, the last run's output)."""
    times = {name: [] for name in stages}
    out = None
    for _ in range(reps):
        out = first
        for name, stage in stages.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = stage(out)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
    return {name: statistics.median(t) for name, t in times.items()}, out


def mesh_render_stages(g, seed):
    """The calls of a mesh ``g.generate_delta_field(seed)``, one by one."""
    from randomfield_tpu_torch.ops import fft, sampler
    from randomfield_tpu_torch.parallel import dfft

    mesh = g.mesh
    nx, ny, nz = g.shape
    nzh = nz // 2 + 1
    y_off, ny_loc = mesh.rows(ny)
    if g.sampler == "pallas":
        stages = {"K8 sample_shard (draw, Hermitian fix, scale)":
                  lambda _: sampler.sample_shard(
                      seed, g.state.table, g.shape, g.grid_spacing, 0.0,
                      y_off, ny_loc)}
    else:
        stages = {"K7 draw_scale_shard (draw, Hermitian fix, scale)":
                  lambda _: tuple(sampler.draw_scale_shard(
                      seed, g.state.table, g.shape, g.grid_spacing, 0.0,
                      y_off, ny_loc))}
    stages["K3 fft_axis x pass"] = lambda ri: fft.ifft_axis(
        *ri, 1, nx, ny_loc * nzh)
    stages["exchange to x slabs, all_to_all" + GLOO] = lambda ri: tuple(
        dfft.to_x_slabs(t, g.shape, mesh) for t in ri)
    stages["K3 fft_axis y pass"] = lambda ri: fft.ifft_axis(
        *ri, nx // mesh.size, ny, nzh)
    stages["K4 c2r_tail"] = lambda ri: fft.c2r_tail(
        *ri, nz, g.state.lightcone_weights)
    return stages


def mesh_forward_stages(g):
    """The distributed forward transform of ``g.calculate_power``, one
    call per stage."""
    from randomfield_tpu_torch.ops import fft
    from randomfield_tpu_torch.parallel import dfft

    mesh = g.mesh
    nx, ny, nz = g.shape
    nzh = nz // 2 + 1
    return {
        "K6 r2c_head": fft.r2c_head,
        "K3 fft_axis forward y pass": lambda ri: fft.fft_axis(
            *ri, nx // mesh.size, ny, nzh),
        "exchange to ky slabs, all_to_all" + GLOO: lambda ri: tuple(
            dfft.to_ky_slabs(t, g.shape, mesh) for t in ri),
        "K3 fft_axis forward x pass": lambda ri: fft.fft_axis(
            *ri, 1, nx, (ny // mesh.size) * nzh),
    }


def mesh_rank_sampler(torch, rft, mesh, name, seed=1):
    """One rank's part of the four-rank run for one sampler: the public
    API's render and estimator with the counts set to 0 before and read
    after, the stage times, and the comparison with the single-device
    render of the seed (made one rank at a time, to bound the card's
    memory)."""
    import torch.distributed as dist

    g = rft.Generator(*HEADLINE, grid_spacing=HEADLINE_SPACING, mesh=mesh,
                      sampler=name)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    f = g.generate_delta_field(seed)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, p, n = g.calculate_power(f, nbins=NBINS)
    power_s = time.perf_counter() - t0
    res = {"counts": read_counts(), "p": p.tolist(), "n": n.tolist(),
           "render_ms": 1e3 * render_s, "power_ms": 1e3 * power_s,
           "finite": bool(torch.isfinite(f).all()),
           "shape": list(f.shape)}
    res["stages"], out = host_stage_times(torch, mesh_render_stages(g, seed),
                                          None, MESH_STAGE_REPS)
    res["stages_equal"] = torch.equal(out, f)
    fwd, _ = host_stage_times(torch, mesh_forward_stages(g), f,
                              MESH_STAGE_REPS)
    res["stages"].update(fwd)
    del out
    for r in range(mesh.size):
        if r == mesh.rank:
            one = rft.Generator(*HEADLINE, grid_spacing=HEADLINE_SPACING,
                                device=mesh.device, sampler=name)
            w = one.generate_delta_field(seed)
            x0, nx_loc = mesh.rows(HEADLINE[0])
            res["max_abs_diff"] = float((f - w[x0:x0 + nx_loc]).abs().max())
            res["max_abs"] = float(w.abs().max())
            if r == 0:
                _, p1, n1 = one.calculate_power(w, nbins=NBINS)
                res["p_single"], res["n_single"] = p1.tolist(), n1.tolist()
            del w
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier(group=mesh.group)
    return res


def mesh_rank(rank, size, store, out_dir, device):
    """One rank of the four-rank run, all on ``device`` (spawned by
    :func:`phase3_four_ranks`); writes its results to out_dir."""
    import torch

    import randomfield_tpu_torch as rft
    from randomfield_tpu_torch.parallel import mesh as pmesh
    from randomfield_tpu_torch.parallel import multihost

    multihost.initialize("gloo", f"file://{store}", size, rank, device)
    try:
        mesh = pmesh.make_mesh(space=size, device=device)
        out = {name: mesh_rank_sampler(torch, rft, mesh, name)
               for name in SAMPLERS}
    finally:
        multihost.shutdown()
    out["imports_jax"] = "jax" in sys.modules or "randomfield_tpu" in sys.modules
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)


def check_mesh_power(what, p, n, p_single, n_single):
    """calculate_power(mesh=...) vs the single-device estimator: equal
    counts, p_hat within MESH_P_RTOL."""
    p, n = np.asarray(p, np.float64), np.asarray(n, np.float64)
    p_single = np.asarray(p_single, np.float64)
    pop = n > 0
    equal = np.array_equal(n, np.asarray(n_single, np.float64))
    rel = float(np.max(np.abs(p[pop] / p_single[pop] - 1.0)))
    log(f"phase 3 {what} calculate_power(mesh=...) vs the single-device "
        f"estimator: counts {'equal' if equal else 'DIFFER'}, p_hat max rel "
        f"{rel:.3e} over {int(pop.sum())} bins (bar {MESH_P_RTOL:g})")
    if not equal or not rel <= MESH_P_RTOL:
        raise AssertionError(f"{what}: the mesh estimator disagrees")


def phase3_four_ranks(torch, dev, card):
    """The slab mesh at 1024^3 on four ranks sharing the card ``dev``
    (gloo), both samplers; returns the launch counts summed over the
    ranks."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="rf_mesh_")
    try:
        t0 = time.perf_counter()
        ctx = mp.spawn(mesh_rank, nprocs=MESH_RANKS, join=False,
                       args=(MESH_RANKS, os.path.join(tmp, "store"), tmp,
                             str(dev)))
        try:
            while not ctx.join(timeout=5.0):
                if time.perf_counter() - t0 > MESH_TIMEOUT_S:
                    raise TimeoutError("the four-rank run took too long")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 3 four-rank mesh {HEADLINE}: {MESH_RANKS} processes on one "
        f"card, gloo, {wall:.1f} s from spawn to exit [{card}]")
    if any(r["imports_jax"] for r in ranks):
        raise AssertionError("a rank imported JAX")
    counts = dict.fromkeys(KERNEL_ORDER, 0)
    for name in SAMPLERS:
        res = [r[name] for r in ranks]
        rel = max(r["max_abs_diff"] for r in res) / max(r["max_abs"] for r in res)
        log(f"phase 3 four-rank mesh sampler={name!r}: x slabs {res[0]['shape']} "
            f"vs the single-device render, max|d| / max|delta| {rel:.3e} (bar "
            f"{MESH_BAR:g}); render {[round(r['render_ms'], 1) for r in res]} "
            f"ms, calculate_power {[round(r['power_ms'], 1) for r in res]} ms "
            f"per rank (host clock); launches per rank "
            f"{[r['counts'] for r in res]}")
        if not rel <= MESH_BAR:
            raise AssertionError(f"four-rank {name} render disagrees: {rel:.3e}")
        if not all(r["finite"] and r["stages_equal"] for r in res):
            raise AssertionError(f"four-rank {name}: non-finite values, or "
                                 f"the timed stages are not the render's")
        if not all(np.array_equal(r[key], res[0][key], equal_nan=True)
                   for r in res for key in ("p", "n")):
            raise AssertionError("the ranks' estimators differ")
        check_mesh_power(f"four-rank sampler={name!r}", res[0]["p"],
                         res[0]["n"], res[0]["p_single"], res[0]["n_single"])
        first = "K8" if name == "pallas" else "K7"
        for r in res:
            require_launches(r["counts"], {first: 1, "K3": 4, "K4": 1, "K6": 1},
                             f"four-rank {name} rank")
            for k in KERNEL_ORDER:
                counts[k] += r["counts"][k]
        for stage in res[0]["stages"]:
            per_rank = [r["stages"][stage] for r in res]
            log(f"phase 4 four-rank stage {stage} sampler={name!r}: "
                f"{', '.join(f'{t:.3f}' for t in per_rank)} ms per rank "
                f"(host clock, median of {MESH_STAGE_REPS}; four processes "
                f"share the card) [{card}]")
    return counts


def phase3_one_rank(torch, rft, dev, mesh):
    """The public API on a one-rank NCCL mesh at 1024^3, both samplers:
    render and estimator with the counts set to 0 before and read after,
    each held to the single-device result; returns the launch counts."""
    counts = dict.fromkeys(KERNEL_ORDER, 0)
    for name in SAMPLERS:
        g = rft.Generator(*HEADLINE, grid_spacing=HEADLINE_SPACING, mesh=mesh,
                          sampler=name)
        torch.cuda.synchronize()
        reset_counts()
        f = g.generate_delta_field(seed=1)
        _, p, n = g.calculate_power(f, nbins=NBINS)
        torch.cuda.synchronize()
        got = read_counts()
        first = "K8" if name == "pallas" else "K7"
        require_launches(got, {first: 1, "K3": 4, "K4": 1, "K6": 1},
                         "one-rank mesh")
        one = rft.Generator(*HEADLINE, grid_spacing=HEADLINE_SPACING,
                            device=dev, sampler=name)
        w = one.generate_delta_field(seed=1)
        _, r = rel_err((f,), (w,))
        log(f"phase 3 one-rank NCCL mesh sampler={name!r} {HEADLINE}: vs the "
            f"single-device render, rel {r:.3e} (bar {MESH_BAR:g}), "
            f"{'bit-equal' if torch.equal(f, w) else 'not bit-equal'}; "
            f"launches {got}")
        if tuple(f.shape) != HEADLINE or not r <= MESH_BAR:
            raise AssertionError(f"one-rank mesh {name} render disagrees")
        _, p1, n1 = one.calculate_power(w, nbins=NBINS)
        check_mesh_power(f"one-rank sampler={name!r}", p, n, p1, n1)
        for k in KERNEL_ORDER:
            counts[k] += got[k]
        del f, w
        torch.cuda.empty_cache()
    return counts


def nccl_one_rank_mesh(dev):
    """Join a one-rank NCCL group at a free localhost port; its mesh."""
    import socket

    from randomfield_tpu_torch.parallel import mesh as pmesh
    from randomfield_tpu_torch.parallel import multihost

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    multihost.initialize("nccl", f"tcp://127.0.0.1:{port}", 1, 0, dev)
    return pmesh.make_mesh(space=1)


def render_stages(g, seed):
    """The calls of ``g.generate_delta_field(seed)``, one by one, by name:
    for a sampler='pallas' scene the staged render's own list, in the
    variant the switch selects now."""
    from randomfield_tpu_torch.engine import staged
    from randomfield_tpu_torch.ops import fft, sampler

    nx, ny, nz = g.shape
    nzh = nz // 2 + 1
    if g.sampler == "pallas":
        return staged.variant_stages(
            staged.selected_variant(g.shape), seed, g.state.table, g.shape,
            g.grid_spacing, g.state.lightcone_weights)
    return {
        "K2F draw_scale (draw, Hermitian fix, scale)": lambda _: tuple(
            sampler.draw_scale(seed, g.state.table, g.shape, g.grid_spacing)),
        "K3 fft_axis x pass": lambda ri: fft.ifft_axis(*ri, 1, nx, ny * nzh),
        "K3 fft_axis y pass": lambda ri: fft.ifft_axis(*ri, nx, ny, nzh),
        "K4 c2r_tail": lambda ri: fft.c2r_tail(*ri, nz,
                                               g.state.lightcone_weights),
    }


def stage_breakdown(torch, g, seed, stages=None, public=None):
    """Median device ms of each stage of ``g``'s render, timed with CUDA
    events between the stages (:func:`render_stages`, or ``stages``); the
    field they give must equal ``generate_delta_field``'s (or ``public()``'s)
    bit for bit."""
    if stages is None:
        stages = render_stages(g, seed)
        public = lambda: g.generate_delta_field(seed)  # noqa: E731
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
    if not torch.equal(out, public()):
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
    of ``g`` (in the staged variant the switch selects now)."""
    variant = os.environ.get(PIPELINE_ENV)
    tag = (f"sampler={g.sampler!r} {HEADLINE}"
           + (f" variant {variant}" if variant else ""))
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
    from randomfield_tpu_torch.ops import (fft, genfft, sample, sampler,
                                           threefry)
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
    variant_ms = {"v5": cuda_ms(torch, lambda: gp.generate_delta_field(seed=2))}
    for variant in ("v4", "v6"):
        with staged_variant(variant):
            variant_ms[variant] = cuda_ms(
                torch, lambda: gp.generate_delta_field(seed=2))
            render_profile(torch, gp, card)
    log(f"phase 4 render sampler='pallas' {HEADLINE} by variant: "
        + ", ".join(f"{v} {ms:.3f} ms" for v, ms in variant_ms.items())
        + f" [{card}]")
    torch.cuda.empty_cache()

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
    tp = gp.state.table
    edges, _ = stats.bin_setup(HEADLINE, HEADLINE_SPACING, NBINS)
    plan = sampler.bin_plan(HEADLINE, HEADLINE_SPACING, edges, dev)
    ifft = torch.fft.ifft
    planes = genfft.plane_spectra(2, t, HEADLINE, HEADLINE_SPACING)
    slow = dict(plain_reps=SLOW_PLAIN_REPS)

    def rotate_library(n, cols):
        """cuFFT down the rows, then the copy of the transpose: two calls."""
        out = ifft(spec.view(1, n, cols), dim=1, norm="forward")
        return out.transpose(1, 2).contiguous()

    # torch.fft.ifft may return its result laid out with the transformed
    # axis minor already; the second call then moves nothing, and the one
    # ifft call computes K9's function
    one_call = ifft(spec.view(1, nx, ny * nzh), dim=1,
                    norm="forward").transpose(1, 2).is_contiguous()
    two_calls = ("torch.fft.ifft + transpose().contiguous(), two calls"
                 + (" (the transposed view is contiguous already: the second "
                    "moves nothing)," if one_call else ","))
    runs = {
        "K2F": (lambda: sampler.draw_scale(2, t, HEADLINE, HEADLINE_SPACING),
                lambda: sampler.draw_scale_plain(2, t, HEADLINE,
                                                 HEADLINE_SPACING),
                None, slow),
        "K1": (lambda: sampler.sample_modes(2, tp, HEADLINE, HEADLINE_SPACING),
               lambda: sampler.seeded_spectrum_plain(2, tp, HEADLINE,
                                                     HEADLINE_SPACING),
               None, slow),
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
        "K5": (lambda: sampler.sample_power_bins_batch(
                   [2], tp, HEADLINE, HEADLINE_SPACING, 0.0, plan),
               lambda: sampler.seeded_power_bins_plain(2, tp, HEADLINE,
                                                       HEADLINE_SPACING, 0.0,
                                                       edges),
               None, slow),
        "K9 x pass": (lambda: fft.ifft_rotate(re, im, 1, nx, ny * nzh),
                      lambda: fft.ifft_rotate_plain(re, im, 1, nx, ny * nzh),
                      lambda: rotate_library(nx, ny * nzh),
                      dict(lib_label=two_calls)),
        "K9 y pass": (lambda: fft.ifft_rotate(re, im, 1, ny, nzh * nx),
                      lambda: fft.ifft_rotate_plain(re, im, 1, ny, nzh * nx),
                      lambda: rotate_library(ny, nzh * nx),
                      dict(lib_label=two_calls)),
        "K10": (lambda: genfft.sample_fftx(2, t, HEADLINE, HEADLINE_SPACING,
                                           planes=planes),
                lambda: genfft.seeded_fftx_plain(2, t, HEADLINE,
                                                 HEADLINE_SPACING,
                                                 planes=planes),
                None, slow),
    }
    times = {}
    for what, (kernel, plain, library, *opts) in runs.items():
        times[what] = time_kernel(torch, what, kernel, plain, library, fresh,
                                  HEADLINE, card, **(opts[0] if opts else {}))
    x, y = times.pop("K3 x pass"), times.pop("K3 y pass")
    times["K3"] = (x[0] + y[0], x[1] + y[1], x[2] + y[2])
    # K9: a library time only where the one ifft call computed it all
    x, y = times.pop("K9 x pass"), times.pop("K9 y pass")
    times["K9"] = (x[0] + y[0], x[1] + y[1], x[2] + y[2] if one_call else None)
    del src_re, src_im, re, im, spec, planes
    torch.cuda.empty_cache()
    # generate_noise is the fused kernel's unit mode; its plain form is the
    # draw stage a render ran before it
    key = threefry.key_from_seed(2)
    time_kernel(torch, "generate_noise (K2F unit mode)",
                lambda: g.generate_noise(2),
                lambda: torch.stack(sample.unit_draws_reim(key, HEADLINE,
                                                           dev)),
                None, None, HEADLINE, card, plain_reps=SLOW_PLAIN_REPS)
    batch_times(torch, rft, dev, card)
    k5_batch_forms(torch, gp, card)
    return times


def batch_times(torch, rft, dev, card):
    """The in-program seed batch beside the loop of single renders and
    torch.stack: BATCH_PAIRS pairs of one call each, the side that runs
    first alternating (a 512^3 render is short enough for the host's
    scheduling to show, so two medians of five are not enough)."""
    gb = rft.Generator(*BATCH_SHAPE, grid_spacing=BATCH_SPACING, device=dev,
                       sampler="pallas")
    seeds = list(range(BATCH_SEEDS))
    sides = {
        "loop": lambda: torch.stack([gb.generate_delta_field(s_)
                                     for s_ in seeds]),
        "batch": lambda: gb.generate_delta_fields(seeds),
    }
    def once(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    for fn in sides.values():  # warm-up
        once(fn)
    ms = {name: [] for name in sides}
    for pair in range(BATCH_PAIRS):
        for name in (("loop", "batch") if pair % 2 else ("batch", "loop")):
            ms[name].append(once(sides[name]))
    wins = sum(b < l for b, l in zip(ms["batch"], ms["loop"]))
    med = {name: statistics.median(t) for name, t in ms.items()}
    spread = {name: (min(t), max(t)) for name, t in ms.items()}
    log(f"phase 4 seed batch sampler='pallas' {BATCH_SHAPE}, {BATCH_SEEDS} "
        f"seeds, {BATCH_PAIRS} alternating pairs: render_v3_batch "
        f"{med['batch'] / BATCH_SEEDS:.3f} ms per seed (median "
        f"{med['batch']:.3f} ms per batch, {spread['batch'][0]:.3f}-"
        f"{spread['batch'][1]:.3f}), loop + torch.stack "
        f"{med['loop'] / BATCH_SEEDS:.3f} ms per seed (median "
        f"{med['loop']:.3f}, {spread['loop'][0]:.3f}-{spread['loop'][1]:.3f}), "
        f"batch / loop {med['batch'] / med['loop']:.4f}, the batch faster in "
        f"{wins} of {BATCH_PAIRS} pairs [{card}]")
    torch.cuda.empty_cache()


def k5_batch_forms(torch, gp, card):
    """The config-4 batch through K5 in its two forms, timed in turns on the
    device (B A A B, each the median of 3): one launch over the whole batch
    (a grid column per seed: sample_power_bins_batch, what
    sample_power_batch runs) and one launch a seed (a batch of one each);
    the two blocks must be equal bit for bit."""
    from randomfield_tpu_torch.ops import sampler
    from randomfield_tpu_torch.validate import stats

    shape, spacing, t = gp.shape, gp.grid_spacing, gp.state.table
    seeds = list(range(ENSEMBLE_SEEDS))
    edges, _ = stats.bin_setup(shape, spacing, NBINS)
    plan = sampler.bin_plan(shape, spacing, edges, gp.device)

    def batch():
        return sampler.sample_power_bins_batch(seeds, t, shape, spacing, 0.0,
                                               plan)

    def per_seed():
        return torch.cat([sampler.sample_power_bins_batch(
            [s_], t, shape, spacing, 0.0, plan) for s_ in seeds])

    b1 = cuda_ms(torch, per_seed, 3)
    a1 = cuda_ms(torch, batch, 3)
    a2 = cuda_ms(torch, batch, 3)
    b2 = cuda_ms(torch, per_seed, 3)
    equal = torch.equal(per_seed(), batch())
    log(f"phase 4 K5 batch of {len(seeds)} seeds {shape} nbins={NBINS}: one "
        f"launch over the batch {(a1 + a2) / 2:.3f} ms ({a1:.3f}, {a2:.3f}; "
        f"{(a1 + a2) / 2 / len(seeds):.3f} a seed), one launch a seed "
        f"{(b1 + b2) / 2:.3f} ms ({b1:.3f}, {b2:.3f}; "
        f"{(b1 + b2) / 2 / len(seeds):.3f} a seed); blocks "
        f"{'bit-equal' if equal else 'DIFFERENT'} [{card}]")
    if not equal:
        raise AssertionError("K5's two batch forms disagree")
    torch.cuda.empty_cache()


def time_kernel(torch, what, kernel, plain, library, setup, shape, card,
                plain_reps=TIMING_REPS, lib_label="cuFFT call"):
    """(kernel ms, plain ms, library ms or None): in turns plain, kernel,
    kernel, plain, the mean of each pair; then the library call."""
    p1 = cuda_ms(torch, plain, plain_reps, setup=setup)
    k1 = cuda_ms(torch, kernel, setup=setup)
    k2 = cuda_ms(torch, kernel, setup=setup)
    p2 = cuda_ms(torch, plain, plain_reps, setup=setup)
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    lib_ms = None if library is None else cuda_ms(torch, library)
    lib = "" if lib_ms is None else f", {lib_label} {lib_ms:.3f} ms"
    log(f"phase 4 {what} at {shape}: kernel {k_ms:.3f} ms "
        f"({k1:.3f}, {k2:.3f}), plain {p_ms:.3f} ms ({p1:.3f}, {p2:.3f})"
        f"{lib} [{card}]")
    torch.cuda.empty_cache()
    return k_ms, p_ms, lib_ms


def phase4_mesh(torch, rft, dev, g, gp, mesh, card):
    """Times of the mesh's kernels at its 1024^3 shapes (K6 at the one-rank
    forward transform's, K7 and K8 on the second of four shards, forward K3
    beside cuFFT) and of the one-rank mesh render beside the single-device
    render; returns {K: (ms, plain_ms, library_ms or None)}."""
    from randomfield_tpu_torch.ops import fft, sampler

    nx, ny, nz = HEADLINE
    nzh = nz // 2 + 1
    for one in (g, gp):
        m = rft.Generator(*HEADLINE, grid_spacing=HEADLINE_SPACING, mesh=mesh,
                          sampler=one.sampler)
        reps = 3
        s1 = cuda_ms(torch, lambda: one.generate_delta_field(seed=2), reps)
        m1 = cuda_ms(torch, lambda: m.generate_delta_field(seed=2), reps)
        m2 = cuda_ms(torch, lambda: m.generate_delta_field(seed=2), reps)
        s2 = cuda_ms(torch, lambda: one.generate_delta_field(seed=2), reps)
        log(f"phase 4 render sampler={one.sampler!r} {HEADLINE}: one-rank NCCL "
            f"mesh {(m1 + m2) / 2:.3f} ms ({m1:.3f}, {m2:.3f}), single device "
            f"{(s1 + s2) / 2:.3f} ms ({s1:.3f}, {s2:.3f}), mesh / single "
            f"{(m1 + m2) / (s1 + s2):.4f} [{card}]")
        del m
        torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(HEADLINE, generator=gen, device=dev)
    times = {"K6": time_kernel(
        torch, "K6", lambda: fft.r2c_head(x), lambda: fft.r2c_head_plain(x),
        lambda: torch.fft.rfft(x, dim=-1), None, HEADLINE, card)}
    src_re = torch.randn((nx, ny, nzh), generator=gen, device=dev)
    src_im = torch.randn((nx, ny, nzh), generator=gen, device=dev)
    re, im = torch.empty_like(src_re), torch.empty_like(src_im)
    spec = torch.complex(src_re, src_im)

    def fresh():
        re.copy_(src_re)
        im.copy_(src_im)

    for what, dim, view in (("x", 0, (1, nx, ny * nzh)), ("y", 1, (nx, ny, nzh))):
        time_kernel(torch, f"K3 forward {what} pass",
                    lambda: fft.fft_axis(re, im, *view),
                    lambda: fft.fft_axis_plain(re, im, *view),
                    lambda: torch.fft.fft(spec, dim=dim), fresh, HEADLINE, card)
    del x, src_re, src_im, re, im, spec
    torch.cuda.empty_cache()

    ny_loc = ny // MESH_RANKS
    shard = (nx, ny_loc, nzh)
    t = g.state.table
    times["K7"] = time_kernel(
        torch, "K7 (shard 1 of 4)",
        lambda: sampler.draw_scale_shard(2, t, HEADLINE, HEADLINE_SPACING,
                                         0.0, ny_loc, ny_loc),
        lambda: sampler.draw_scale_plain(2, t, HEADLINE, HEADLINE_SPACING,
                                         0.0, 0, ny_loc, None, ny_loc),
        None, None, shard, card, plain_reps=SLOW_PLAIN_REPS)
    tp = gp.state.table
    times["K8"] = time_kernel(
        torch, "K8 (shard 1 of 4)",
        lambda: sampler.sample_shard(2, tp, HEADLINE, HEADLINE_SPACING, 0.0,
                                     ny_loc, ny_loc),
        lambda: sampler.seeded_spectrum_plain(2, tp, HEADLINE,
                                              HEADLINE_SPACING, 0.0, ny_loc,
                                              ny_loc),
        None, None, shard, card)
    return times


# ---- the nested stream (KN), fixed fields (K2F fixed), derived fields (KD) ---

# |c| of a fixed field against sigma times the filter, over max sigma
FIXED_MOD_BAR = 3e-6
# the fixed field's variance against the prediction (tests/test_fixed.py)
FIXED_VAR_BAR = 1e-4
# -div(psi) and trace(T) against delta (tests/test_derived.py:51); the
# gradient zeroes the Nyquist modes, so the field is smoothed to ten cells
DIV_RTOL, DIV_ATOL = 1e-3, 1e-4
DIV_SMOOTH_CELLS = 10
# 2LPT and the T-web at 512^3: a stacked 1024^3 tidal field alone is 26 GB
WEB_SHAPE, WEB_SPACING = (512, 512, 512), 4.0
# KD's kinds and components, and the 2LPT source's diagonals
KD_CASES = ([("scalar", 0, False)] + [("grad", a, False) for a in range(3)]
            + [("tidal", c, False) for c in range(6)]
            + [("kaiser", 2, False)]
            + [("tidal", c, True) for c in range(3)])


def fixed_modulus(torch, spec, table, shape, spacing, s):
    """max | |c| - sigma filter | / max(sigma filter) of a fixed spectrum."""
    from randomfield_tpu_torch.ops import sampler

    worst = top = 0.0
    for x0 in range(0, shape[0], 64):
        n = min(64, shape[0] - x0)
        amp = sampler.sigma_amplitude(table, shape, spacing, s, x0, n)
        mag = torch.sqrt(spec[0, x0:x0 + n] ** 2 + spec[1, x0:x0 + n] ** 2)
        worst = max(worst, float((mag - amp.abs()).abs().max()))
        top = max(top, float(amp.abs().max()))
    return worst / top


def phase1_slice(torch, g, gn, errs):
    """KN, K2F's fixed mode and KD vs their plain versions on the card at
    the 1024^3 shapes and tables of the threefry scene ``g`` and the nested
    scene ``gn``: KN's bits exact, its spectrum (s = 0, 8), unit normals and
    fixed field (s = 0, 8) within the K1 bar, the paired field the exact
    negation; K2F fixed (s = 0, 8) within the bar, |c| = sigma filter, the
    paired field the exact negation; KD in each kind and component (and
    the 2LPT diagonals) within the bar."""
    from randomfield_tpu_torch.ops import derived, sampler

    seed = 17
    t, shape, sp = gn.state.table, gn.shape, gn.grid_spacing
    got = sampler.sample_nested(seed, t, shape, sp, mode="bits")
    want = sampler.sample_nested_plain(seed, t, shape, sp, mode="bits")
    torch.cuda.synchronize()
    exact = torch.equal(got, want)
    log(f"phase 1 KN bits {tuple(got.shape)} vs threefry2x32 of the lattice "
        f"codes: {'equal' if exact else 'DIFFER'}")
    if not exact:
        raise AssertionError("KN's hash is not the nested stream's")
    del got, want
    torch.cuda.empty_cache()
    for mode, s_ in (("spectrum", 0.0), ("spectrum", 8.0), ("unit", 0.0),
                     ("fixed", 0.0), ("fixed", 8.0)):
        got = sampler.sample_nested(seed, t, shape, sp, s_, mode=mode)
        want = sampler.sample_nested_plain(seed, t, shape, sp, s_, mode=mode)
        torch.cuda.synchronize()
        check_close(errs, "KN", f"{mode} {tuple(got.shape)} s={s_}",
                    (got[0], got[1]), (want[0], want[1]))
        del want
        if mode == "fixed":
            paired = sampler.sample_nested(seed, t, shape, sp, s_,
                                           mode="fixed", flip=True)
            negated = torch.equal(paired, -got)
            del paired
            mod = fixed_modulus(torch, got, t, shape, sp, s_)
            log(f"phase 1 KN fixed s={s_}: | |c| - sigma filter | / max "
                f"{mod:.3e} (bar {FIXED_MOD_BAR:g}); paired "
                f"{'= -fixed bit for bit' if negated else 'NOT -fixed'}")
            if not negated or not mod <= FIXED_MOD_BAR:
                raise AssertionError("KN's fixed field is off")
        del got
        torch.cuda.empty_cache()

    t, shape, sp = g.state.table, g.shape, g.grid_spacing
    for s_ in (0.0, 8.0):
        got = sampler.draw_fixed(seed, t, shape, sp, s_)
        want = sampler.draw_fixed_plain(seed, t, shape, sp, s_)
        torch.cuda.synchronize()
        check_close(errs, "K2FX", f"{tuple(got.shape)} s={s_} "
                    f"({'bit-equal' if torch.equal(got, want) else 'not bit-equal'})",
                    (got[0], got[1]), (want[0], want[1]))
        del want
        paired = sampler.draw_fixed(seed, t, shape, sp, s_, flip=True)
        negated = torch.equal(paired, -got)
        del paired
        mod = fixed_modulus(torch, got, t, shape, sp, s_)
        log(f"phase 1 K2FX s={s_}: | |c| - sigma filter | / max {mod:.3e} "
            f"(bar {FIXED_MOD_BAR:g}); paired "
            f"{'= -fixed bit for bit' if negated else 'NOT -fixed'}")
        if not negated or not mod <= FIXED_MOD_BAR:
            raise AssertionError("K2F's fixed mode is off")
        del got
        torch.cuda.empty_cache()

    gen = torch.Generator(device=g.device).manual_seed(7)
    nzh = shape[2] // 2 + 1
    re = torch.randn((shape[0], shape[1], nzh), generator=gen, device=g.device)
    im = torch.randn((shape[0], shape[1], nzh), generator=gen, device=g.device)
    for kind, comp, grad_diag in KD_CASES:
        pref = (1.3, 0.7) if kind == "kaiser" else 0.37
        a, b = derived.apply_kernel(re.clone(), im.clone(), shape, sp, kind,
                                    comp, pref, grad_diag)
        c, d = derived.apply_kernel_plain(re.clone(), im.clone(), shape, sp,
                                          kind, comp, pref, grad_diag)
        torch.cuda.synchronize()
        same = torch.equal(a, c) and torch.equal(b, d)
        check_close(errs, "KD", f"{kind} {comp}{' (2LPT diagonal)' if grad_diag else ''} "
                    f"{tuple(a.shape)} ({'bit-equal' if same else 'not bit-equal'})",
                    (a, b), (c, d))
        del a, b, c, d
    del re, im
    torch.cuda.empty_cache()


def phase2_slice_fields(torch, rft, dev):
    """The nested render, fixed and paired fields and every derived field on
    the card vs the CPU (plain) versions at 128^3, seed 7, for the three
    samplers (fixed fields: threefry and nested, as in the JAX package)."""
    shape, spacing, seed, s = (128, 128, 128), 16.0, 7, 20.0
    draw = {"threefry": "K2F", "pallas": "K1", "nested": "KN"}
    derived_calls = [("generate_potential", dict(z=0.5)),
                     ("generate_displacement", {}),
                     ("generate_displacement", dict(order=2)),
                     ("generate_velocity", dict(z=1.0)),
                     ("generate_tidal_field", {}),
                     ("generate_kaiser_field", dict(z=0.3, bias=1.4))]
    for name, first in draw.items():
        g_dev = rft.Generator(*shape, grid_spacing=spacing, device=dev,
                              sampler=name)
        g_cpu = rft.Generator(*shape, grid_spacing=spacing, device="cpu",
                              sampler=name)
        calls = [(m, kw, {first: 1, "KD": 1, "K3": 2, "K4": 1})
                 for m, kw in derived_calls]
        if name == "nested":
            calls.insert(0, ("generate_delta_field", {},
                             {"KN": 1, "K3": 2, "K4": 1}))
        if name != "pallas":
            fixed = "KN" if name == "nested" else "K2FX"
            calls += [("generate_fixed_field", dict(flip=flip),
                       {fixed: 1, "K3": 2, "K4": 1}) for flip in (False, True)]
        for method, kw, least in calls:
            reset_counts()
            got = getattr(g_dev, method)(seed, smoothing_length=s, **kw)
            torch.cuda.synchronize()
            counts = read_counts()
            want = getattr(g_cpu, method)(seed, smoothing_length=s, **kw)
            _, r = rel_err((got.cpu(),), (want,))
            log(f"phase 2 slice {name} {method}({kw}) {shape} seed {seed} "
                f"s={s}: rel {r:.3e} (bar {SLICE_BAR:g}), launches "
                f"{ {k: n for k, n in counts.items() if n} }")
            if not r <= SLICE_BAR:
                raise AssertionError(f"CUDA {method} disagrees with CPU: "
                                     f"rel {r:.3e}")
            require_launches(counts, least, f"{name} {method}")


def spectral_divergence(torch, psi, shape, spacing):
    """-div(psi) of a (3, nx, ny, nz) displacement, through torch.fft (a
    check, not the port's path)."""
    from randomfield_tpu_torch.ops import grid

    kx, ky, kz = grid.kvectors(shape, spacing, torch.float32, psi.device)
    div = None
    for comp, k in zip(psi, (kx[:, None, None], ky[None, :, None],
                             kz[None, None, :])):
        c = torch.fft.rfftn(comp)
        c = torch.complex(-c.imag * k, c.real * k)  # i k c
        div = c if div is None else div.add_(c)
        del c
    return -torch.fft.irfftn(div, s=shape)


def within(torch, got, want, rtol, atol):
    """(ok, max |got - want| / atol) of |got - want| <= atol + rtol |want|,
    slab by slab."""
    ok, worst = True, 0.0
    for a, b in zip(got.split(64), want.split(64)):
        d = (a - b).abs()
        ok &= bool((d <= atol + rtol * b.abs()).all())
        worst = max(worst, float(d.max()) / atol)
    return ok, worst


def phase3_slice(torch, rft, dev, g, card):
    """This slice's paths through the public API at 1024^3, each with the
    launch counts set to 0 before it and read after it: the nested render
    (determinism, variance, zoom against 512^3 over the same box),
    generate_noise -> generate_from_noise of the nested scene bit-equal to
    its render, the fixed field (variance within 1e-4, the paired field its
    exact negation), the displacement's -div(psi) against delta, the
    velocity, tidal and Kaiser fields; then 2LPT and classify_web at 512^3
    with their peak memory.  Returns the launch counts, summed."""
    from randomfield_tpu_torch.models import web
    from randomfield_tpu_torch.validate import stats

    total = dict.fromkeys(KERNEL_ORDER, 0)

    def run(what, fn, least):
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        require_launches(counts, least, what)
        for k in KERNEL_ORDER:
            total[k] += counts[k]
        return out, {k: n for k, n in counts.items() if n}

    seed = 5
    gn = rft.Generator(*HEADLINE, grid_spacing=HEADLINE_SPACING, device=dev,
                       sampler="nested")
    (f1, f2), counts = run("nested render", lambda: (
        gn.generate_delta_field(seed, apply_lightcone=False),
        gn.generate_delta_field(seed, apply_lightcone=False)),
        {"KN": 2, "K3": 4, "K4": 2})
    same = torch.equal(f1, f2)
    del f2
    if tuple(f1.shape) != HEADLINE or not bool(torch.isfinite(f1).all()):
        raise AssertionError("nested field has the wrong shape or non-finite values")
    _, var = stats.field_moments(f1)
    pred = gn.predicted_variance()
    log(f"phase 3 main path sampler='nested' {HEADLINE}: same seed twice "
        f"{'bit-equal' if same else 'DIFFERENT'}; var {var:.6g}, predicted "
        f"{pred:.6g}, ratio {var / pred:.5f} (bar {VAR_BAR:g}); launches "
        f"{counts}")
    if not same or not abs(var / pred - 1.0) <= VAR_BAR:
        raise AssertionError("the nested render is off")
    coarse_shape = tuple(n // 2 for n in HEADLINE)
    gz = rft.Generator(*coarse_shape, grid_spacing=2 * HEADLINE_SPACING,
                       device=dev, sampler="nested")
    coarse, _ = run("nested coarse render", lambda: gz.generate_delta_field(
        seed, apply_lightcone=False), {"KN": 1})
    m = coarse_shape[0]
    s_idx = torch.cat([torch.arange(0, m // 2, device=dev),
                       torch.arange(-(m // 2) + 1, 0, device=dev)])
    c_lo = torch.fft.rfftn(coarse, norm="forward")[s_idx % m][:, s_idx % m][
        :, :, :m // 2]
    del coarse
    c_hi = torch.fft.rfftn(f1, norm="forward")
    c_hi = c_hi[s_idx % HEADLINE[0]][:, s_idx % HEADLINE[1]][:, :, :m // 2]
    scale = float(c_lo.abs().max())
    d = (c_lo - c_hi).abs()
    gap = float(d.max()) / scale
    ok = gap <= ZOOM_GAP
    log(f"phase 3 nested zoom {coarse_shape} vs {HEADLINE} over one "
        f"{HEADLINE[0] * HEADLINE_SPACING:g} Mpc/h box: the "
        f"{c_lo.numel()} modes both hold, max|dc| / max|c| {gap:.3e} (bar "
        f"{ZOOM_GAP:g})")
    del c_lo, c_hi, d, f1
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("the nested renders do not share their modes")

    def round_trip():
        noise = gn.generate_noise(4)
        return noise, gn.generate_from_noise(noise)

    want = gn.generate_delta_field(4)
    (noise, got), counts = run("nested noise round trip", round_trip,
                               {"KN": 1, "K2": 1, "K3": 2, "K4": 1})
    equal = torch.equal(got, want)
    log(f"phase 3 main path sampler='nested' generate_noise -> "
        f"generate_from_noise {HEADLINE}: noise {tuple(noise.shape)}, field "
        f"{'bit-equal to' if equal else 'DIFFERS from'} generate_delta_field(4); "
        f"launches {counts}")
    del want, noise, got
    torch.cuda.empty_cache()
    if not equal:
        raise AssertionError("nested generate_from_noise(generate_noise(s)) "
                             "is not the render of s")

    (fixed, paired), counts = run("fixed field", lambda: (
        g.generate_fixed_field(2, apply_lightcone=False),
        g.generate_fixed_field(2, apply_lightcone=False, flip=True)),
        {"K2FX": 2, "K3": 4, "K4": 2})
    negated = torch.equal(paired, -fixed)
    del paired
    _, var = stats.field_moments(fixed)
    pred = g.predicted_variance()
    log(f"phase 3 main path generate_fixed_field {HEADLINE}: var {var:.8g}, "
        f"predicted {pred:.8g}, ratio - 1 {var / pred - 1.0:.3e} (bar "
        f"{FIXED_VAR_BAR:g}); paired {'= -fixed bit for bit' if negated else 'NOT -fixed'}; "
        f"launches {counts}")
    del fixed
    torch.cuda.empty_cache()
    if not negated or not abs(var / pred - 1.0) <= FIXED_VAR_BAR:
        raise AssertionError("the fixed field is off")

    s_ = DIV_SMOOTH_CELLS * HEADLINE_SPACING
    psi, counts = run("displacement", lambda: g.generate_displacement(
        3, smoothing_length=s_), {"K2F": 1, "KD": 3, "K3": 6, "K4": 3})
    delta = g.generate_delta_field(3, smoothing_length=s_,
                                   apply_lightcone=False)
    std = float(stats.field_moments(delta)[1]) ** 0.5
    div = spectral_divergence(torch, psi, HEADLINE, HEADLINE_SPACING)
    del psi
    ok, worst = within(torch, div, delta, DIV_RTOL, DIV_ATOL * std)
    log(f"phase 3 main path generate_displacement {HEADLINE} s={s_:g}: "
        f"-div(psi) vs delta, max|d| / (1e-4 std) {worst:.3f} (bar: rtol "
        f"{DIV_RTOL:g}, atol {DIV_ATOL:g} std); launches {counts}")
    del div, delta
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("-div(psi) is not delta")

    (v1, v2), counts = run("velocity", lambda: (
        g.generate_velocity(3, z=1.0), g.generate_velocity(3, z=1.0)),
        {"K2F": 2, "KD": 6, "K3": 12, "K4": 6})
    ok = torch.equal(v1, v2) and bool(torch.isfinite(v1).all())
    log(f"phase 3 main path generate_velocity {tuple(v1.shape)}: "
        f"{'finite and deterministic' if ok else 'NOT finite or deterministic'}; "
        f"launches {counts}")
    del v1, v2
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("the velocity field is off")

    tidal, counts = run("tidal", lambda: g.generate_tidal_field(3),
                        {"K2F": 1, "KD": 6, "K3": 12, "K4": 6})
    ok = bool(torch.isfinite(tidal).all())
    for c in range(6):
        ok &= torch.equal(tidal[c], g.generate_tidal_field(3, component=c))
    delta = g.generate_delta_field(3, apply_lightcone=False)
    std = float(stats.field_moments(delta)[1]) ** 0.5
    trace = tidal[0] + tidal[1] + tidal[2]
    del tidal
    tr_ok, worst = within(torch, trace, delta, DIV_RTOL, DIV_ATOL * std)
    log(f"phase 3 main path generate_tidal_field (6, {HEADLINE}): "
        f"{'finite, each component equal to its own call' if ok else 'NOT finite or deterministic'}; "
        f"trace vs delta max|d| / (1e-4 std) {worst:.3f}; launches {counts}")
    del trace, delta
    torch.cuda.empty_cache()
    if not ok or not tr_ok:
        raise AssertionError("the tidal field is off")

    (k1, k2), counts = run("kaiser", lambda: (
        g.generate_kaiser_field(3, z=0.5, bias=1.3),
        g.generate_kaiser_field(3, z=0.5, bias=1.3)),
        {"K2F": 2, "KD": 2, "K3": 4, "K4": 2})
    ok = torch.equal(k1, k2) and bool(torch.isfinite(k1).all())
    log(f"phase 3 main path generate_kaiser_field {HEADLINE}: "
        f"{'finite and deterministic' if ok else 'NOT finite or deterministic'}; "
        f"launches {counts}")
    del k1, k2
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("the Kaiser field is off")

    gw = rft.Generator(*WEB_SHAPE, grid_spacing=WEB_SPACING, device=dev)
    s_ = 2 * WEB_SPACING
    for what, fn, least in (
            ("2LPT displacement", lambda: gw.generate_displacement(
                1, smoothing_length=s_, order=2),
             {"K2F": 2, "KD": 12, "K6": 2, "K3": 30, "K4": 13}),
            ("classify_web", lambda: gw.classify_web(1, smoothing_length=s_),
             {"K2F": 1, "KD": 6, "K3": 12, "K4": 6})):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out, counts = run(what, fn, least)
        peak = torch.cuda.max_memory_allocated()
        if what == "classify_web":
            frac = web.web_fractions(out)
            ok = out.dtype == torch.int8 and bool((torch.tensor(frac) > 0).all())
            detail = ("web fractions " + ", ".join(
                f"{name} {f:.4f}" for name, f in zip(web.WEB_TYPES, frac)))
        else:
            ok = tuple(out.shape) == (3, *WEB_SHAPE) and bool(
                torch.isfinite(out).all())
            psi1 = gw.generate_displacement(1, smoothing_length=s_)
            detail = (f"rms psi(1) + psi(2) {float(out.double().pow(2).mean()) ** 0.5:.5g}, "
                      f"rms psi(1) {float(psi1.double().pow(2).mean()) ** 0.5:.5g} Mpc/h")
            del psi1
        log(f"phase 3 {what} {WEB_SHAPE} s={s_:g}: {detail}; peak device "
            f"memory {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} "
            f"above the {base / 2**30:.3f} held before it); launches "
            f"{counts} [{card}]")
        del out
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"{what} is off")
    return total


def slice_stages(torch, g, gn, seed):
    """{render: (stages by name, the public call they must equal)} of the
    nested render, the fixed field and one displacement component (the
    draw, the copy each component but the last gets, KD, the transforms)."""
    from randomfield_tpu_torch.ops import derived, fft, sampler

    nx, ny, nz = HEADLINE
    nzh = nz // 2 + 1

    def tail(weights):
        return {
            "K3 fft_axis x pass": lambda ri: fft.ifft_axis(*ri, 1, nx, ny * nzh),
            "K3 fft_axis y pass": lambda ri: fft.ifft_axis(*ri, nx, ny, nzh),
            "K4 c2r_tail": lambda ri: fft.c2r_tail(*ri, nz, weights),
        }

    t, tn, sp = g.state.table, gn.state.table, g.grid_spacing
    nested = {"KN sample_nested (draw, Hermitian fix, scale)": lambda _: tuple(
        sampler.sample_nested(seed, tn, HEADLINE, sp))}
    nested.update(tail(gn.state.lightcone_weights))
    fixed = {"K2FX draw_fixed (draw, fix, z/|z|, scale)": lambda _: tuple(
        sampler.draw_fixed(seed, t, HEADLINE, sp))}
    fixed.update(tail(g.state.lightcone_weights))
    disp = {
        "K2F draw_scale": lambda _: tuple(sampler.draw_scale(seed, t, HEADLINE,
                                                             sp)),
        "copy of the spectrum (plain clone)": lambda ri: (ri[0].clone(),
                                                          ri[1].clone()),
        "KD apply_kernel grad x": lambda ri: derived.apply_kernel(
            *ri, HEADLINE, sp, "grad", 0, 1.0),
    }
    disp.update(tail(torch.ones(nz, dtype=torch.float32, device=g.device)))
    return {
        "nested render": (nested, lambda: gn.generate_delta_field(seed)),
        "fixed render": (fixed, lambda: g.generate_fixed_field(seed)),
        "displacement component x": (disp, lambda: g.generate_displacement(
            seed, component=0)),
    }


def phase4_slice(torch, rft, dev, g, card):
    """Times of this slice at 1024^3: KN (spectrum; unit and fixed mode
    printed), K2F fixed and KD (grad) beside their plain versions, the
    nested, fixed and displacement renders, and the stages of each;
    returns {K: (ms, plain_ms, None)}."""
    from randomfield_tpu_torch.ops import derived, sampler

    nx, ny, nz = HEADLINE
    nzh = nz // 2 + 1
    gn = rft.Generator(*HEADLINE, grid_spacing=HEADLINE_SPACING, device=dev,
                       sampler="nested")
    t, tn, sp = g.state.table, gn.state.table, HEADLINE_SPACING
    slow = dict(plain_reps=SLOW_PLAIN_REPS)
    times = {}
    for mode in ("spectrum", "unit", "fixed"):
        ms = time_kernel(
            torch, f"KN sample_nested {mode} mode",
            lambda: sampler.sample_nested(2, tn, HEADLINE, sp, mode=mode),
            lambda: sampler.sample_nested_plain(2, tn, HEADLINE, sp,
                                                mode=mode),
            None, None, HEADLINE, card, **slow)
        if mode == "spectrum":
            times["KN"] = ms
    times["K2FX"] = time_kernel(
        torch, "K2FX draw_fixed",
        lambda: sampler.draw_fixed(2, t, HEADLINE, sp),
        lambda: sampler.draw_fixed_plain(2, t, HEADLINE, sp),
        None, None, HEADLINE, card, **slow)
    gen = torch.Generator(device=dev).manual_seed(8)
    src_re = torch.randn((nx, ny, nzh), generator=gen, device=dev)
    src_im = torch.randn((nx, ny, nzh), generator=gen, device=dev)
    re, im = torch.empty_like(src_re), torch.empty_like(src_im)

    def fresh():
        re.copy_(src_re)
        im.copy_(src_im)

    for kind, comp, pref in (("grad", 0, 1.0), ("scalar", 0, 1.0),
                             ("tidal", 3, 1.0), ("kaiser", 2, (1.3, 0.7))):
        ms = time_kernel(
            torch, f"KD apply_kernel {kind} {comp}",
            lambda: derived.apply_kernel(re, im, HEADLINE, sp, kind, comp,
                                         pref),
            lambda: derived.apply_kernel_plain(re, im, HEADLINE, sp, kind,
                                               comp, pref),
            None, fresh, HEADLINE, card)
        if kind == "grad":
            times["KD"] = ms
    del src_re, src_im, re, im
    torch.cuda.empty_cache()

    for what, fn in (
            ("nested render", lambda: gn.generate_delta_field(seed=2)),
            ("fixed render", lambda: g.generate_fixed_field(seed=2)),
            ("displacement render, 3 components",
             lambda: g.generate_displacement(seed=2))):
        ms = cuda_ms(torch, fn)
        log(f"phase 4 {what} {HEADLINE}: {ms:.3f} ms [{card}]")
        torch.cuda.empty_cache()
    for what, (stages, public) in slice_stages(torch, g, gn, 2).items():
        stage_ms = stage_breakdown(torch, g, 2, stages, public)
        total = sum(stage_ms.values())
        for name, ms in stage_ms.items():
            log(f"phase 4 stage {name} of the {what} {HEADLINE}: {ms:.3f} ms, "
                f"{100 * ms / total:.2f}% of the {total:.3f} ms stage sum "
                f"[{card}]")
        torch.cuda.empty_cache()
    del gn
    torch.cuda.empty_cache()
    return times



# ---- the measurement surface: KB, the estimators, the bispectrum, f_NL -------

# KB against its plain version at the 1024^3 main path's spectra: the same
# float32 terms a mode, added in float64 in another order; counts exactly,
# two calls bit for bit
KB_SUM_RTOL = 1e-10
KB_KINDS = ("auto", "cross", "interlaced", "grid")
KB_OUTPUTS = {"isotropic": {}, "ells (0, 2, 4)": dict(ells=(0, 2, 4)),
              "nmu = 4 wedges": dict(nmu=4), "window cic": dict(order=2)}
# KB at its most bins (binning.MAX_BINS; the shared memory's budget)
KB_MAX_OUTPUTS = {"ells (0, 2, 4), 1024 bins": dict(ells=(0, 2, 4),
                                                    nbins=1024),
                  "nmu = 4 wedges, 256 x 4 bins": dict(nmu=4, nbins=256)}
# K5's float64 block at 256^3 (pallas, seed 3, NBINS bins, no smoothing):
# the sha256 of its bytes as the kernel computed it before its binning code
# went to csrc/bins_common.cuh (which KB shared until its redesign); K5's
# registers and hot SASS instructions a mode, which must not move either
K5_DIGEST_SHAPE, K5_DIGEST_SPACING, K5_DIGEST_SEED = (256, 256, 256), 8.0, 3
K5_DIGEST = "5cec6ddee1deb2ac9edf9a3397db969f09092784c7ea8a1608de6e561ed093d7"
K5_SASS = (48, 169.5)
# the nested zoom with the box-anchored sigma table: max|dc| / max|c| over
# the modes two grids of one box share (the class of the JAX package's
# per-mode sigma grid)
ZOOM_GAP = 1e-6
# Kaiser multipoles and wedges of 512^3 renders against their exact
# expectations, in sampling sigmas of the seeds' mean with a floor
# (tests/test_kaiser.py, tests/test_wedges.py)
RSD_SHAPE, RSD_SPACING, RSD_SEEDS, RSD_BINS = (512, 512, 512), 4.0, 8, 16
KAISER_BIAS, KAISER_F = 1.3, 0.8
RSD_SIGMAS, RSD_FLOOR = 5.0, 5e-3
# xi at 256^3 against its prediction (tests/test_correlation.py)
XI_SHAPE, XI_SPACING, XI_SEEDS, XI_BINS, XI_FLOOR = ((256, 256, 256), 4.0,
                                                     6, 24, 1e-4)
# local f_NL against the tree prediction at 256^3 (16 shells), and a fixed
# Gaussian field's bispectrum against 0 (tests/test_nongaussian.py,
# tests/test_bispectrum.py).  f_NL is a fifth of the JAX test's 0.05: at
# 256^3 the tree signal stands ~1400 sigma above the noise, so its O(f_NL^3)
# loop term (+1.7% at 0.05, measured) would alone exceed 5 sigma; it falls
# as f_NL^2
NG_SHAPE, NG_SPACING, NG_FNL, NG_NBINS, NG_SEEDS = ((256, 256, 256), 4.0,
                                                    0.01, 8, 2)
NG_SLOPE, NG_Z, NG_SNR = (0.93, 1.07), 5.0, 50.0
ZERO_Z, ZERO_RMS = 5.0, (0.4, 2.0)
# checkpointed ensemble: seeds, checkpoint cadence
ENSEMBLE_CK_SHAPE, ENSEMBLE_CK_SEEDS = (256, 256, 256), 6
# each CUDA estimator against the same on the CPU at 128^3: the hand FFTs
# against torch.fft (float32 rounding of the spectrum), sums in float64;
# the bispectrum's float32 shells at its own bars (tests/test_bispectrum.py),
# of the largest triad count and |B|: a thin triple's count is the small
# remainder of large float32 shell products (1.1e-3 relative measured at
# 128^3)
ESTIMATOR_SHAPE, ESTIMATOR_SPACING, ESTIMATOR_RTOL = (128, 128, 128), 8.0, 1e-5
BISPECTRUM_NTRI_RTOL, BISPECTRUM_B_TOL = 1e-4, 1e-3
# the 1024^3 bispectrum's bins
BISPECTRUM_NBINS = 8


def k5_digest(torch, rft, dev):
    """sha256 of K5's float64 (1, 3, NBINS) block at K5_DIGEST_SHAPE."""
    from randomfield_tpu_torch.ops import sampler
    from randomfield_tpu_torch.validate import stats

    g = rft.Generator(*K5_DIGEST_SHAPE, grid_spacing=K5_DIGEST_SPACING,
                      device=dev, sampler="pallas")
    edges, _ = stats.bin_setup(g.shape, g.grid_spacing, NBINS)
    plan = sampler.bin_plan(g.shape, g.grid_spacing, edges, dev)
    acc = sampler.sample_power_bins_batch([K5_DIGEST_SEED], g.state.table,
                                          g.shape, g.grid_spacing, 0.0, plan)
    return hashlib.sha256(acc.cpu().numpy().tobytes()).hexdigest()


def phase1_measure(torch, rft, dev, g, gp, errs):
    """KB against its plain version at 1024^3 on the main path's spectra
    (the forward transforms of two renders; the Kaiser expectation grid
    for 'grid'), every kind isotropic, with ells (0, 2, 4), with nmu = 4
    wedges and with the cic window: counts exactly equal, sums within
    KB_SUM_RTOL, two calls bit-equal; K5's block at 256^3 against its
    stored digest; the sigma tables of the three samplers."""
    from randomfield_tpu_torch.ops import binning, sampler, transform
    from randomfield_tpu_torch.validate import fourier, stats

    spacing = HEADLINE_SPACING
    f1 = g.generate_delta_field(1, apply_lightcone=False)
    re1, im1 = transform.rfftn(f1)
    del f1
    f2 = g.generate_delta_field(2, apply_lightcone=False)
    re2, im2 = transform.rfftn(f2)
    del f2
    grid = g._kaiser_pgrid(0.0, KAISER_BIAS, KAISER_F, 2, 0.0)
    inputs = {"auto": (re1, im1), "cross": (re1, im1, re2, im2),
              "interlaced": (re1, im1, re2, im2), "grid": (grid,)}
    factor = fourier._factor(HEADLINE, spacing)
    for kind in KB_KINDS:
        for what, kw in {**KB_OUTPUTS, **KB_MAX_OUTPUTS}.items():
            kw = dict(kw)
            edges, _ = stats.bin_setup(HEADLINE, spacing,
                                       kw.pop("nbins", NBINS))
            args = (kind, inputs[kind], HEADLINE, spacing, edges)
            got = binning.bin_spectrum(*args, factor=factor, **kw)
            again = binning.bin_spectrum(*args, factor=factor, **kw)
            want = binning.bin_spectrum_plain(*args, factor=factor, **kw)
            counts = torch.equal(got[:, 0], want[:, 0])
            rel = max(float((got[:, r] - want[:, r]).abs().max()
                            / want[:, r].abs().max()) for r in (1, 2))
            errs["KB"] = max(errs.get("KB", 0.0),
                             float((got - want).abs().max()))
            bit = torch.equal(got, again)
            log(f"phase 1 KB {kind} {what} {HEADLINE}: counts "
                f"{'equal' if counts else 'DIFFER'}, sums rel {rel:.3e} (bar "
                f"{KB_SUM_RTOL:g}), two calls "
                f"{'bit-equal' if bit else 'DIFFERENT'}")
            if not (counts and bit and rel <= KB_SUM_RTOL):
                raise AssertionError(f"KB {kind} {what} disagrees")
    # the geometry pass alone, on a first call, against the plain version's
    # counts and |k| sums: counts equal, sums within KB_SUM_RTOL
    for what, nmu in (("isotropic", 0), ("nmu = 4 wedges", 4)):
        edges, _ = stats.bin_setup(HEADLINE, spacing, NBINS)
        binning._geometry.cache_clear()
        got = kb_geometry(edges, nmu, dev)
        want = kb_geometry_plain(torch, grid, edges, nmu)
        counts = torch.equal(got[0], want[0])
        rel = float((got[1] - want[1]).abs().max() / want[1].abs().max())
        errs["KBG"] = max(errs.get("KBG", 0.0),
                          float((got - want).abs().max()))
        log(f"phase 1 KB geometry pass {what} {HEADLINE}: counts "
            f"{'equal' if counts else 'DIFFER'}, |k| sums rel {rel:.3e} "
            f"(bar {KB_SUM_RTOL:g})")
        if not (counts and rel <= KB_SUM_RTOL):
            raise AssertionError(f"KB's geometry pass {what} disagrees")
    del inputs, re1, im1, re2, im2, grid
    torch.cuda.empty_cache()
    digest = k5_digest(torch, rft, dev)
    log(f"phase 1 K5 {K5_DIGEST_SHAPE} seed {K5_DIGEST_SEED} block sha256 "
        f"{digest} (stored {K5_DIGEST})")
    if digest != K5_DIGEST:
        raise AssertionError("K5's output moved")
    power = g.power
    same = []
    for gen_, make in ((g, sampler.make_sigma_table),
                       (gp, sampler.make_sigma_table)):
        t = make(power, HEADLINE, spacing, device=dev)
        same.append(torch.equal(gen_.state.table.knots, t.knots)
                    and (gen_.state.table.lk0, gen_.state.table.dlk)
                    == (t.lk0, t.dlk))
    fine = sampler.make_box_sigma_table(power, HEADLINE, spacing)
    coarse = sampler.make_box_sigma_table(
        power, tuple(n // 2 for n in HEADLINE), 2 * spacing)
    m = coarse.knots.numel()
    shared = (torch.equal(fine.knots[:m], coarse.knots)
              and (fine.lk0, fine.dlk) == (coarse.lk0, coarse.dlk))
    log(f"phase 1 sigma tables: threefry and pallas scenes "
        f"{'the grid table' if all(same) else 'CHANGED'}; nested "
        f"{tuple(n // 2 for n in HEADLINE)} and {HEADLINE} over one box "
        f"{'share' if shared else 'DO NOT share'} their {m} knots "
        f"({fine.knots.numel()} in the finer table)")
    if not (all(same) and shared):
        raise AssertionError("the sigma tables are off")


def kb_geometry(edges, nmu, dev):
    """float64 (2, nb): KB's geometry pass (counts, |k| sums by key) of
    the 1024^3 grid's isotropic bins (``nmu`` 0) or wedges, kept by
    binning after its first call for the geometry."""
    from randomfield_tpu_torch.ops import binning

    return binning._geometry(HEADLINE, float(HEADLINE_SPACING),
                             np.asarray(edges, np.float64).tobytes(), 0,
                             HEADLINE[1], int(nmu), 2, str(dev))


def kb_geometry_plain(torch, lattice, edges, nmu):
    """:func:`kb_geometry` in plain PyTorch: the counts and |k| sums of
    binning.mode_terms (whose value of ``lattice`` it drops), x-slab by
    x-slab, by binning.line_sums."""
    from randomfield_tpu_torch.ops import binning

    nb = (len(edges) - 1) * max(1, nmu)
    out = torch.zeros((2, nb + 1), dtype=torch.float64, device=lattice.device)
    for x0 in range(0, HEADLINE[0], 16):
        x1 = min(HEADLINE[0], x0 + 16)
        km, idx, w, _ = binning.mode_terms(
            "grid", (lattice,), HEADLINE, HEADLINE_SPACING, edges, x0, x1,
            nmu=nmu or None)
        w = torch.broadcast_to(w, idx.shape)
        out[0] += binning.line_sums(idx, w, nb + 1)
        out[1] += binning.line_sums(idx, w * km.to(torch.float64), nb + 1)
    return out[:, :nb]


def _seed_mean(stack):
    a = np.asarray(stack, np.float64)
    return a.mean(axis=0), a.std(axis=0, ddof=1) / np.sqrt(a.shape[0])


def _rsd_gate(what, mean, sd, pred, counts, scale):
    """Seed-averaged estimates against the exact expectation: within
    RSD_SIGMAS of the mean's scatter plus RSD_FLOOR of ``scale`` (the
    monopole for the multipoles, a shell's largest wedge for the wedges),
    in the bins with more than 4 modes."""
    m = np.broadcast_to(counts > 4, pred.shape)
    budget = RSD_SIGMAS * sd + RSD_FLOOR * np.broadcast_to(scale, pred.shape)
    worst = float(np.max((np.abs(mean - pred) / budget)[m]))
    log(f"phase 2 {what}: max |mean - predicted| / budget {worst:.3f} over "
        f"{int(m.sum())} bins (budget {RSD_SIGMAS:g} sigma of the mean of "
        f"{RSD_SEEDS} seeds + {RSD_FLOOR:g} of the scale)")
    if not worst < 1.0:
        raise AssertionError(f"{what} misses its expectation")


def _gaussian_bispectrum_sigma(kc, tri, ntri, power, volume, nseeds):
    """The Gaussian noise of a binned B: s V P1 P2 P3 / Ntri / nseeds, s =
    6, 2, 1 for equilateral, isoceles and scalene triples."""
    pk = np.interp(np.log10(kc), np.log10(power.k), power.Pk)
    s = np.array([{1: 6, 2: 2, 3: 1}[len(set(t))] for t in map(tuple, tri)],
                 np.float64)
    return np.sqrt(s * volume * pk[tri[:, 0]] * pk[tri[:, 1]] * pk[tri[:, 2]]
                   / ntri / nseeds)


def phase2_measure(torch, rft, dev):
    """The estimators' gates on the card: Kaiser multipoles and wedges at
    512^3, the cross power of a field with itself, xi at 256^3, the local
    f_NL bispectrum and a fixed Gaussian field's at 256^3, the checkpointed
    ensemble, and each CUDA estimator against the CPU at 128^3."""
    import tempfile

    from randomfield_tpu_torch.validate import bispectrum, ensemble, stats

    g = rft.Generator(*RSD_SHAPE, grid_spacing=RSD_SPACING, device=dev)
    kw = dict(bias=KAISER_BIAS, f=KAISER_F)
    poles, wedges = [], []
    for s in range(RSD_SEEDS):
        rs = g.generate_kaiser_field(s, **kw)
        poles.append(stats.calculate_power_multipoles(rs, RSD_SPACING,
                                                      RSD_BINS)[1])
        wedges.append(stats.calculate_power_wedges(rs, RSD_SPACING, RSD_BINS,
                                                   nmu=4)[1])
        if s == 0:
            auto = stats.calculate_power(rs, RSD_SPACING, RSD_BINS)
            cross = stats.calculate_cross_power(rs, rs, RSD_SPACING, RSD_BINS)
            same = all(np.array_equal(a, b, equal_nan=True)
                       for a, b in zip(auto, cross))
            log(f"phase 2 calculate_cross_power(d, d) vs calculate_power(d) "
                f"{RSD_SHAPE}: {'bit-equal' if same else 'DIFFERENT'}")
            if not same:
                raise AssertionError("the cross power of a field with itself "
                                     "is not its power")
        del rs
    _, p_pred, cnt = g.predicted_kaiser_multipoles(nbins=RSD_BINS, **kw)
    mean, sd = _seed_mean(poles)
    _rsd_gate(f"Kaiser multipoles {RSD_SHAPE} vs predicted_kaiser_multipoles",
              mean, sd, p_pred, cnt, np.abs(p_pred[0]))
    _, w_pred, wcnt = g.predicted_kaiser_wedges(nbins=RSD_BINS, nmu=4, **kw)
    mean, sd = _seed_mean(wedges)
    _rsd_gate(f"Kaiser wedges {RSD_SHAPE} vs predicted_kaiser_wedges",
              mean, sd, w_pred, wcnt,
              np.nanmax(np.abs(w_pred), axis=1, keepdims=True))
    del g
    torch.cuda.empty_cache()

    g = rft.Generator(*XI_SHAPE, grid_spacing=XI_SPACING, device=dev)
    r_pred, xi_pred, n_pred = stats.predicted_correlation(
        g.power, XI_SHAPE, XI_SPACING, XI_BINS, device=dev)
    acc = [stats.calculate_correlation(g.generate_delta_field(
        s, apply_lightcone=False), XI_SPACING, XI_BINS)[1]
        for s in range(XI_SEEDS)]
    mean, sd = _seed_mean(acc)
    mask = n_pred > 0
    worst = float(np.max(np.abs(mean - xi_pred)[mask] / (
        5.0 * sd[mask] + XI_FLOOR * np.nanmax(np.abs(xi_pred)))))
    log(f"phase 2 calculate_correlation vs predicted_correlation {XI_SHAPE}, "
        f"{XI_SEEDS} seeds: max |mean - predicted| / budget {worst:.3f} (budget "
        f"5 sigma + {XI_FLOOR:g} max|xi|)")
    if not worst < 1.0:
        raise AssertionError("xi misses its prediction")

    g = rft.Generator(*NG_SHAPE, grid_spacing=NG_SPACING, device=dev)
    volume = float(np.prod(NG_SHAPE)) * NG_SPACING ** 3
    acc = None
    for s in range(NG_SEEDS):
        d = g.generate_nongaussian_field(s, NG_FNL)
        kc, tri, b, ntri = g.calculate_bispectrum(d, nbins=NG_NBINS)
        acc = b if acc is None else acc + b
    b = acc / NG_SEEDS
    _, trip, bp, ntrip = g.predicted_ng_bispectrum(NG_FNL, nbins=NG_NBINS)
    if not np.array_equal(tri, trip):
        raise AssertionError("the prediction's triples differ")
    sig = _gaussian_bispectrum_sigma(kc, tri, ntri, g.power, volume, NG_SEEDS)
    z = (b - bp) / sig
    w = 1.0 / sig ** 2
    slope = float(np.sum(w * b * bp) / np.sum(w * bp * bp))
    snr = float(np.sqrt(np.sum((bp / sig) ** 2)))
    log(f"phase 2 local f_NL = {NG_FNL:g} bispectrum {NG_SHAPE} nbins="
        f"{NG_NBINS}, {NG_SEEDS} seeds, {len(tri)} triples: slope "
        f"{slope:.4f} (bar {NG_SLOPE}), max|z| {np.abs(z).max():.3f} (bar "
        f"{NG_Z:g}), SNR {snr:.1f} (bar > {NG_SNR:g})")
    if not (NG_SLOPE[0] < slope < NG_SLOPE[1] and np.abs(z).max() < NG_Z
            and snr > NG_SNR):
        raise AssertionError("the f_NL bispectrum misses its prediction")
    d = g.generate_fixed_field(11, apply_lightcone=False)
    kc, tri, b, ntri = bispectrum.calculate_bispectrum(d, NG_SPACING,
                                                       nbins=NG_NBINS)
    kp, pp, _ = g.calculate_power(d, nbins=2 * NG_NBINS)
    ok = np.isfinite(pp)
    pk = np.interp(kc[tri], kp[ok], pp[ok])
    s = np.array([{1: 6, 2: 2, 3: 1}[len(set(t))] for t in map(tuple, tri)])
    z = b / np.sqrt(s * volume * pk[:, 0] * pk[:, 1] * pk[:, 2] / ntri)
    rms = float(np.sqrt(np.mean(z ** 2)))
    log(f"phase 2 fixed Gaussian field bispectrum {NG_SHAPE}: max|z| "
        f"{np.abs(z).max():.3f} (bar {ZERO_Z:g}), rms {rms:.3f} (bar "
        f"{ZERO_RMS})")
    if not (np.abs(z).max() < ZERO_Z and ZERO_RMS[0] < rms < ZERO_RMS[1]):
        raise AssertionError("a Gaussian field's bispectrum is not 0")
    del d, g
    torch.cuda.empty_cache()

    g = rft.Generator(*ENSEMBLE_CK_SHAPE, grid_spacing=8.0, device=dev,
                      sampler="pallas")
    seeds = list(range(ENSEMBLE_CK_SEEDS))
    whole = ensemble.sample_power_ensemble(g, seeds, nbins=NBINS)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ensemble.npz")
        ensemble.sample_power_ensemble(g, seeds[:2], nbins=NBINS,
                                       checkpoint_path=ckpt,
                                       checkpoint_every=1)
        resumed = ensemble.sample_power_ensemble(g, seeds, nbins=NBINS,
                                                 checkpoint_path=ckpt,
                                                 checkpoint_every=2)
    equal = all(np.array_equal(a, b, equal_nan=True)
                for a, b in zip(whole, resumed))
    log(f"phase 2 sample_power_ensemble {ENSEMBLE_CK_SHAPE}, "
        f"{ENSEMBLE_CK_SEEDS} seeds, resumed from its checkpoint after 2: "
        f"{'equal' if equal else 'DIFFERS from'} the uninterrupted run")
    if not equal:
        raise AssertionError("the resumed ensemble differs")

    phase2_estimators_vs_cpu(torch, dev)


def phase2_estimators_vs_cpu(torch, dev):
    """Each estimator on the card against the same on the CPU, one 128^3
    field (and a second for the cross and interlaced spectra)."""
    from randomfield_tpu_torch.validate import bispectrum, stats

    gen = torch.Generator(device=dev).manual_seed(9)
    d = torch.randn(ESTIMATOR_SHAPE, generator=gen, device=dev)
    d2 = torch.randn(ESTIMATOR_SHAPE, generator=gen, device=dev)
    sp = ESTIMATOR_SPACING
    calls = {
        "calculate_power": lambda a, b: stats.calculate_power(a, sp),
        "calculate_power cic interlaced": lambda a, b: stats.calculate_power(
            a, sp, window="cic", interlaced_with=b),
        "calculate_power_multipoles": lambda a, b:
            stats.calculate_power_multipoles(a, sp),
        "calculate_power_wedges": lambda a, b: stats.calculate_power_wedges(
            a, sp),
        "calculate_cross_power": lambda a, b: stats.calculate_cross_power(
            a, b, sp),
        "calculate_correlation": lambda a, b: stats.calculate_correlation(
            a, sp),
        "calculate_correlation_multipoles": lambda a, b:
            stats.calculate_correlation_multipoles(a, sp),
        "calculate_power_1d": lambda a, b: stats.calculate_power_1d(a, sp),
    }
    for name, call in calls.items():
        got, want = call(d, d2), call(d.cpu(), d2.cpu())
        worst = 0.0
        for a, b in zip(got, want):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            ok = np.isfinite(b)
            if not np.array_equal(ok, np.isfinite(a)):
                raise AssertionError(f"{name}: other empty bins on the card")
            worst = max(worst, float(np.max(np.abs(a[ok] - b[ok]))
                                     / max(np.max(np.abs(b[ok])), 1e-300)))
        log(f"phase 2 {name} {ESTIMATOR_SHAPE} CUDA vs CPU: max |d| / max "
            f"{worst:.3e} (bar {ESTIMATOR_RTOL:g})")
        if not worst <= ESTIMATOR_RTOL:
            raise AssertionError(f"{name} on the card disagrees with the CPU")
    got = bispectrum.calculate_bispectrum(d, sp, nbins=4)
    want = bispectrum.calculate_bispectrum(d.cpu(), sp, nbins=4)
    ntri = float(np.max(np.abs(got[3] - want[3])) / np.max(want[3]))
    b_err = float(np.max(np.abs(got[2] - want[2])) / np.abs(want[2]).max())
    log(f"phase 2 calculate_bispectrum {ESTIMATOR_SHAPE} CUDA vs CPU: triples "
        f"{'equal' if np.array_equal(got[1], want[1]) else 'DIFFER'}, ntri "
        f"{ntri:.3e} of the largest (bar {BISPECTRUM_NTRI_RTOL:g}; the largest "
        f"relative gap {np.max(np.abs(got[3] / want[3] - 1.0)):.3e}, on the "
        f"thinnest triples), B {b_err:.3e} of max|B| (bar "
        f"{BISPECTRUM_B_TOL:g})")
    if not (np.array_equal(got[1], want[1]) and ntri <= BISPECTRUM_NTRI_RTOL
            and b_err <= BISPECTRUM_B_TOL):
        raise AssertionError("the bispectrum on the card disagrees")


def phase3_measure(torch, rft, dev, g, card):
    """The estimator paths at 1024^3 through the public API, each with the
    launch counts set to 0 before it and read after it: calculate_power,
    the multipoles (K6, forward K3 twice, KB), the bispectrum (its shells
    and unit shells: K3 twice and K4 a shell) and the potential f_NL render
    (the render, two forward and two inverse transforms), none of them
    through torch.fft.  KB's kept geometries are dropped first, so
    calculate_power runs the geometry pass (KBG) as a first call does.
    Returns the launch counts, summed."""
    from randomfield_tpu_torch.ops import binning
    from randomfield_tpu_torch.validate import stats

    total = dict.fromkeys(KERNEL_ORDER, 0)
    field = g.generate_delta_field(7, apply_lightcone=False)
    shells = 2 * BISPECTRUM_NBINS
    binning._geometry.cache_clear()
    paths = (
        ("calculate_power", lambda: g.calculate_power(field, NBINS),
         {"K6": 1, "K3": 2, "KB": 1, "KBG": 1}),
        ("calculate_power_multipoles", lambda: stats.calculate_power_multipoles(
            field, HEADLINE_SPACING, NBINS), {"K6": 1, "K3": 2, "KB": 1}),
        ("calculate_bispectrum", lambda: g.calculate_bispectrum(
            field, nbins=BISPECTRUM_NBINS),
         {"K6": 1, "K3": 2 + 2 * shells, "K4": shells}),
        ("generate_nongaussian_field(kind='potential')",
         lambda: g.generate_nongaussian_field(3, 2e3, kind="potential"),
         {"K2F": 1, "K6": 2, "K3": 10, "K4": 3}),
    )
    for what, fn, least in paths:
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        require_launches(counts, least, what)
        if counts["torch.fft"]:
            raise AssertionError(f"{what} went through torch.fft")
        for k in KERNEL_ORDER:
            total[k] += counts[k]
        log(f"phase 3 main path {what} {HEADLINE}: launches "
            f"{ {k: n for k, n in counts.items() if n} }, torch.fft calls 0")
        del out
    del field
    torch.cuda.empty_cache()
    return total


def phase4_measure(torch, rft, dev, g, card):
    """Times at 1024^3: calculate_power split into its transform and KB,
    KB against its plain version on the card, KB's other kinds (the grid
    kind on the Kaiser expectation) and outputs, the multipoles, wedges and cross power, the
    bispectrum (its first call with the unit shells, then cached) with its
    peak memory, xi, and the f_NL renders.  Returns {"KB": (ms, plain_ms,
    None), "KBG": (the geometry pass's)}."""
    from randomfield_tpu_torch.ops import binning, transform
    from randomfield_tpu_torch.validate import bispectrum, fourier, stats

    sp = HEADLINE_SPACING
    field = g.generate_delta_field(7, apply_lightcone=False)
    field2 = g.generate_delta_field(8, apply_lightcone=False)
    fwd = cuda_ms(torch, lambda: transform.rfftn(field))
    re, im = transform.rfftn(field)
    re2, im2 = transform.rfftn(field2)
    edges, _ = stats.bin_setup(HEADLINE, sp, NBINS)
    factor = fourier._factor(HEADLINE, sp)
    args = ("auto", (re, im), HEADLINE, sp, edges)
    k_ms, p_ms, _ = time_kernel(
        torch, f"KB bin_spectrum auto nbins={NBINS}",
        lambda: binning.bin_spectrum(*args, factor=factor),
        lambda: binning.bin_spectrum_plain(*args, factor=factor), None, None,
        HEADLINE, card, plain_reps=SLOW_PLAIN_REPS)
    # every kind and output (the grid kind on the Kaiser expectation),
    # beside the read-rate yardsticks of its lattices: one torch sum each,
    # and KB's staging alone (binning.read_probe)
    grid = g._kaiser_pgrid(0.0, KAISER_BIAS, KAISER_F, 2, 0.0)
    inputs = {"auto": (re, im), "cross": (re, im, re2, im2),
              "interlaced": (re, im, re2, im2), "grid": (grid,)}
    for what, kw in (("isotropic", {}), ("nmu = 4 wedges", dict(nmu=4))):
        cold = cuda_ms(torch, lambda: binning.bin_spectrum(
            "auto", (re, im), HEADLINE, sp, edges, factor=factor, **kw),
            setup=binning._geometry.cache_clear)
        log(f"phase 4 KB auto {what} {HEADLINE}, its first call for the "
            f"geometry (the geometry pass, then the data pass): {cold:.3f} "
            f"ms [{card}]")
    # the geometry pass alone (KBG) beside its plain version, isotropic
    # and the 4 wedges
    g_ms, gp_ms, _ = time_kernel(
        torch, f"KBG geometry pass isotropic nbins={NBINS}",
        lambda: kb_geometry(edges, 0, dev),
        lambda: kb_geometry_plain(torch, re, edges, 0), None,
        binning._geometry.cache_clear, HEADLINE, card,
        plain_reps=SLOW_PLAIN_REPS)
    time_kernel(torch, f"KBG geometry pass nmu = 4 wedges nbins={NBINS}",
                lambda: kb_geometry(edges, 4, dev),
                lambda: kb_geometry_plain(torch, re, edges, 4), None,
                binning._geometry.cache_clear, HEADLINE, card,
                plain_reps=SLOW_PLAIN_REPS)
    for kind in KB_KINDS:
        arrays = inputs[kind]
        kfac = 1.0 if kind == "grid" else factor
        for what, kw in KB_OUTPUTS.items():
            if kind != "auto" and what == "window cic":
                continue
            ms = cuda_ms(torch, lambda: binning.bin_spectrum(
                kind, arrays, HEADLINE, sp, edges, factor=kfac, **kw))
            log(f"phase 4 KB {kind} {what} {HEADLINE}: {ms:.3f} ms "
                f"[{card}]")
    for n, arrays in ((1, (grid,)), (2, (re, im)), (4, (re, im, re2, im2))):
        nbytes = sum(a.numel() * 4 for a in arrays)
        t_sum = cuda_ms(torch, lambda: [a.sum() for a in arrays])
        t_probe = cuda_ms(torch, lambda: binning.read_probe(arrays))
        log(f"phase 4 KB read yardstick, {n} lattice(s) of {HEADLINE}: "
            f"{nbytes / 1e9:.4f} GB; torch sums {t_sum:.3f} ms "
            f"({nbytes / t_sum / 1e6:.1f} GB/s), KB's staging alone (read "
            f"probe) {t_probe:.3f} ms ({nbytes / t_probe / 1e6:.1f} GB/s) "
            f"[{card}]")
    del re, im, re2, im2, grid, inputs
    torch.cuda.empty_cache()
    total, peak = timed_peak(torch, lambda: stats.calculate_power(
        field, sp, NBINS))
    log(f"phase 4 calculate_power {HEADLINE}: {total:.3f} ms = transform "
        f"(K6, K3 y, K3 x) {fwd:.3f} + KB {k_ms:.3f} + the rest "
        f"{total - fwd - k_ms:.3f}; with the plain binning it would take "
        f"{fwd + p_ms:.3f}; peak device memory {peak} [{card}]")
    for what, fn in (
            ("calculate_power_multipoles", lambda: stats.calculate_power_multipoles(
                field, sp, NBINS)),
            ("calculate_power_wedges", lambda: stats.calculate_power_wedges(
                field, sp, NBINS)),
            ("calculate_cross_power", lambda: stats.calculate_cross_power(
                field, field2, sp, NBINS)),
            ("calculate_power(window='cic', interlaced_with=...)",
             lambda: stats.calculate_power(field, sp, NBINS, window="cic",
                                           interlaced_with=field2))):
        ms, peak = timed_peak(torch, fn)
        log(f"phase 4 {what} {HEADLINE}: {ms:.3f} ms; peak device memory "
            f"{peak} [{card}]")
    del field2
    torch.cuda.empty_cache()
    bispectrum._triangle_counts.cache_clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    bispectrum.calculate_bispectrum(field, sp, nbins=BISPECTRUM_NBINS)
    torch.cuda.synchronize()
    first = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    cached = cuda_ms(torch, lambda: bispectrum.calculate_bispectrum(
        field, sp, nbins=BISPECTRUM_NBINS), reps=3)
    _, tri = bispectrum.bispectrum_bins(HEADLINE, sp, BISPECTRUM_NBINS)
    log(f"phase 4 calculate_bispectrum {HEADLINE} nbins={BISPECTRUM_NBINS} "
        f"({len(tri)} triples, {len({(i, j) for i, j, _ in tri})} pair "
        f"products): first call {first:.1f} ms (host clock, with the "
        f"denominator's unit shells), cached {cached:.1f} ms; peak device "
        f"memory {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB "
        f"above the {base / 2**30:.3f} GiB held) [{card}]")
    ms = cuda_ms(torch, lambda: stats.calculate_correlation(field, sp),
                 reps=3)
    log(f"phase 4 calculate_correlation {HEADLINE}: {ms:.3f} ms [{card}]")
    del field
    torch.cuda.empty_cache()
    for kind, fnl in (("field", 50.0), ("potential", 2e3)):
        ms = cuda_ms(torch, lambda: g.generate_nongaussian_field(
            3, fnl, kind=kind))
        log(f"phase 4 generate_nongaussian_field(kind={kind!r}) {HEADLINE}: "
            f"{ms:.3f} ms [{card}]")
    torch.cuda.empty_cache()
    return {"KB": (k_ms, p_ms, None), "KBG": (g_ms, gp_ms, None)}


# ---- the mock makers: KP (paint), KC (constraint functionals), K4L --------------

# K4's instance at the 1024^3 render's nz / 2 = 512 (Plan<512, 16, 8, 4>): its
# registers and SASS instructions as built for sm_90a before K4L joined its
# template; the lognormal instance must not move them
K4_SASS_512 = (64, 1224)
# KC MEASURE vs its plain version (the same float64 terms, summed in another
# order), relative to the sum of |terms|; CORRECT bit-equal
KC_MEASURE_RTOL = 1e-10
KC_COUNTS = (1, 8, 40)
# M whose tables do not fit in one block's shared memory at 1024^3 (the
# kernels' passes: MEASURE streams the lattices once a pass, CORRECT keeps
# the alpha sums between passes); the plans of phase 0 also at an M far
# above it
KC_BLOCKED = (64, 128)
KC_PLAN_COUNTS = KC_COUNTS + KC_BLOCKED + (3000,)
MOCK_CONSTRAINTS = 8
# particles a block of KP's library timing (its 8 corners' terms, 1 GiB each)
KP_LIB_BLOCK = 1 << 27
# the 1024^3 constrained render: constraints met within the reference's
# bar (tests/test_constrained.py:89-100)
CONSTRAINT_BAR = 2e-3
# phase 2's grids and seeds
MOCK_SHAPE, MOCK_SPACING = (128, 128, 128), 8.0
LOGNORMAL_SEEDS = 8
KAISER_SEEDS = 4
COND_SHAPE, COND_SPACING, COND_SEEDS = (32, 32, 32), 16.0, 128
POSTERIOR_SEEDS = 32
# a mock path's field on the card against the CPU one at 128^3
MOCK_SLICE_BAR = 1e-5


def mock_counts():
    from randomfield_tpu_torch.ops import constraint, fft, paint

    return {"KP": paint.KP_LAUNCHES, "KPC": paint.KPC_LAUNCHES,
            "KC": constraint.KC_LAUNCHES, "K4L": fft.K4L_LAUNCHES}


def phase0_mocks(torch, card):
    """K4's 1024^3 instance held to its registers and SASS count
    (K4_SASS_512) with K4L in its template; the registers of KP's, KC's and
    K4L's instances."""
    from randomfield_tpu_torch.ops import _build, fft

    lib, tool = _build.library_path(), _build.cuda_tool("cuobjdump")
    funcs, regs = sass_functions(lib, tool)
    k4 = [f for f in funcs if "c2r_tail_kernel" in f
          and "PlanILi512ELi16ELi8ELi4E" in f and "Lb0E" in f]
    if len(k4) != 1:
        raise AssertionError(f"no single K4 instance at m = 512: {k4}")
    got = (regs.get(k4[0], -1), len(funcs[k4[0]]))
    log(f"phase 0 K4 c2r_tail m = 512: {got[0]} registers, {got[1]} SASS "
        f"instructions; expected {K4_SASS_512} (the instance before K4L) "
        f"[{card}]")
    if got != K4_SASS_512:
        raise AssertionError("adding K4L moved K4's instance")
    for n in FFT_LENGTHS:
        r, b, t, s = fft.kernel_attributes("c2r_tail_exp", n)
        log(f"phase 0 K4L c2r_tail_exp nz = {2 * n}: {r} registers a thread, "
            f"{b} blocks an SM of {t} threads, {s} bytes of shared memory "
            f"[{card}]")
        if r <= 0 or b <= 0:
            raise AssertionError(f"K4L n = {n}: no such instance")
    wanted = {f"{kind}_kernelILi{o}E{idx}": f"KP {kind} {w}{tag}"
              for o, w in ((1, "ngp"), (2, "cic"), (3, "tsc"))
              for kind, idx, tag in (("count", "", ""), ("scatter", "iE", ""),
                                     ("deposit", "iE", ""),
                                     ("deposit", "xE", " (int64 index)"),
                                     ("gather", "", ""))
              if not (kind == "gather" and o == 1)}
    wanted.update({"contrast_kernel": "KP contrast",
                   "measure_kernelILb0E": "KC measure",
                   "measure_kernelILb1E": "KC measure + scale",
                   "correct_kernelILb0E": "KC correct",
                   "correct_kernelILb1E": "KC correct (in passes)"})
    found, atoms = {}, {}
    for f, r in regs.items():
        for frag, what in wanted.items():
            if frag in f:
                found[what] = r
                if "deposit" in frag:
                    atoms[what] = collections.Counter(
                        op for op in (re.sub(r"^@!?U?P\w+ ", "", t).split()[0]
                                      for _, t in funcs.get(f, ()))
                        if op.startswith("ATOMS"))
    log(f"phase 0 KP and KC registers a thread: {found} [{card}]")
    missing = sorted(set(wanted.values()) - set(found))
    if missing:
        raise AssertionError(f"KP's or KC's instances are missing: {missing}")
    log(f"phase 0 KP deposit shared-memory atomics in SASS: "
        f"{ {k: dict(v) for k, v in atoms.items()} }; a 64-bit atomicAdd "
        f"on shared memory compiles to {shared_atomic64_sass(tool)}")
    kc_sass(funcs, regs, card)


# KC MEASURE's loops a kz step: their float32 -> float64 conversions and
# float64 operations
KC_SASS_OPS = ("F2F.F64.F32", "DFMA", "DMUL", "DADD", "LDS", "FMUL", "FADD")


def kc_sass(funcs, regs, card):
    """Every innermost loop of each KC MEASURE instance that converts
    float32 to float64 (a lane's kz step through a register block of 1, 4
    or 8 constraints; each constraint's term is one DMUL): its instructions
    by opcode; and the plans at 1024^3."""
    from randomfield_tpu_torch.ops import constraint

    for name, what in (("measure_kernelILb1E", "measure + scale"),
                       ("measure_kernelILb0E", "measure")):
        f = next((k for k in funcs if name in k), None)
        if f is None:
            raise AssertionError(f"KC {what}: no SASS function")
        instrs = funcs[f]
        loops = []
        for addr, text in instrs:
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                body = [t for a, t in instrs if int(m.group(1), 16) <= a <= addr]
                if any("F2F.F64.F32" in t for t in body):
                    loops.append((int(m.group(1), 16), addr, body))
        rows = []
        for first, last, body in loops:
            if any(first <= a < b <= last and (a, b) != (first, last)
                   for a, b, _ in loops):
                continue  # holds another converting loop
            ops = collections.Counter()
            for t in body:
                op = re.sub(r"^@!?U?P\w+ ", "", t).split()[0]
                for want in KC_SASS_OPS:
                    if op.startswith(want):
                        ops[want] += 1
            rows.append(f"{len(body)} instructions {dict(ops)}")
        log(f"phase 0 KC {what}: {regs.get(f, -1)} registers; its innermost "
            f"loops that convert (a kz step of a lane through a register "
            f"block; a constraint's term is one DMUL): {'; '.join(rows)} "
            f"[{card}]")
    nx, ny, nz = HEADLINE
    for m in KC_PLAN_COUNTS:
        rows = [f"{what} {constraint.launch_plan(c, sc, nx, ny, nz, m)}"
                for what, c, sc in (("measure", False, False),
                                    ("measure + scale", False, True),
                                    ("correct", True, True))]
        log(f"phase 0 KC plans M={m} at {HEADLINE} (constraints a pass, "
            f"stages, blocks, shared memory): {'; '.join(rows)} "
            f"[{card}]")


# a 64-bit add on shared memory, the form KP's deposit does not use
SHARED_ATOMIC64 = """
__global__ void probe(unsigned long long* out, const unsigned long long* in) {
  __shared__ unsigned long long s[256];
  s[threadIdx.x] = 0;
  __syncthreads();
  atomicAdd(&s[in[threadIdx.x] & 255], in[threadIdx.x]);
  __syncthreads();
  out[threadIdx.x] = s[threadIdx.x];
}
"""


def shared_atomic64_sass(cuobjdump):
    """The shared-memory instructions of SHARED_ATOMIC64 as nvcc builds it
    for sm_90a (its loop, where the add is a compare-and-swap loop)."""
    from randomfield_tpu_torch.ops import _build

    work = _build.build_dir() / "probe"
    work.mkdir(parents=True, exist_ok=True)
    (work / "atomic64.cu").write_text(SHARED_ATOMIC64)
    subprocess.run([_build.cuda_tool("nvcc"), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-cubin", "-o",
                    str(work / "atomic64.cubin"), str(work / "atomic64.cu")],
                   check=True, capture_output=True, timeout=300)
    text = subprocess.run([cuobjdump, "-sass", str(work / "atomic64.cubin")],
                          check=True, capture_output=True, text=True,
                          timeout=300).stdout
    return [m.group(1) for m in re.finditer(
        r"\*/\s+(?:@!?P\d+\s+)?((?:ATOMS|LDS|BRA)[\w.]*)", text)]


def _particles(torch, shape, spacing, dev, seed=11):
    """float32 (3, n) positions: one a cell at a random place in the box,
    then particles exactly on cell faces, at L and at -a/2."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = int(np.prod(shape))
    pos = torch.empty((3, n + 4096), dtype=torch.float32, device=dev)
    for a in range(3):
        pos[a, :n].uniform_(0.0, shape[a] * spacing, generator=gen)
    faces = torch.randint(-2, 2 * shape[0] + 2, (3, 4096), generator=gen,
                          device=dev).to(torch.float32) * (spacing / 2)
    faces[:, :8] = shape[0] * spacing
    faces[:, 8:16] = -spacing / 2
    pos[:, n:] = faces
    return pos


def _constraint_set(m, shape, spacing, seed):
    """m constraints: off-grid positions, radii 0..4 cells, the last R = 0
    and the first on a grid point; values of order 1."""
    rng = np.random.default_rng(seed)
    box = np.asarray(shape, np.float64) * spacing
    pos = rng.uniform(0.0, 1.0, (m, 3)) * box
    pos[0] = np.round(pos[0] / spacing) * spacing
    scales = rng.uniform(0.0, 4.0, m) * spacing
    scales[-1] = 0.0
    values = rng.normal(0.0, 1.0, m)
    return [(tuple(p), float(v), float(s))
            for p, v, s in zip(pos, values, scales)]


def projection_misses(torch, g, cons, seed):
    """(max |Gamma - value| of the corrected spectrum before the Hermitian
    projection of its self-conjugate kz planes, after it, and of the
    rendered field by measure_constraints) of one constrained render at
    s = 0: a constraint off the grid with R = 0 is not Hermitian on those
    planes' Nyquist rows, and the projection drops that part of it."""
    from randomfield_tpu_torch.models import constrained
    from randomfield_tpu_torch.ops import constraint, threefry, transform

    shape, sp = g.shape, g.grid_spacing
    vals = np.array([c[1] for c in cons])
    p, r, _ = constrained.pack_constraints(cons, shape, sp)
    tables = constraint.axis_tables(p, r, shape, sp, g.device)
    re, im = constrained.unit_hermitian(threefry.as_key(seed), shape, sp,
                                        g.device)
    gamma = constraint.measure(re, im, tables, g.sigmas)
    alpha = constrained._solve(g.constraint_matrix(cons),
                               vals - gamma.cpu().numpy())
    constraint.correct(re, im, tables, alpha, g.sigmas)
    pre = float(np.abs(constraint.measure(re, im, tables).cpu().numpy()
                       - vals).max())
    transform.hermitian_part_reim(re, im, shape[2])
    post = float(np.abs(constraint.measure(re, im, tables).cpu().numpy()
                        - vals).max())
    del re, im
    d = g.generate_constrained_field(seed, cons)
    field = float(np.abs(g.measure_constraints(d, cons) - vals).max())
    del d
    torch.cuda.empty_cache()
    return pre, post, field


# KP's phase-1 checks on each catalog: (window, per-particle weights, the
# shift in cells)
KP_CHECKS = (("cic", False, 0.0), ("cic", True, 0.5), ("tsc", False, 0.5),
             ("tsc", True, 0.0), ("ngp", True, 0.5))


def _catalog_positions(torch, g, catalog):
    """float32 (3, n) positions at 1024^3: ``random``, one a cell at a
    random place (plus particles on faces, at L and below 0), or
    ``Zel'dovich``, the lattice displaced by a render's displacement, in
    lattice order."""
    from randomfield_tpu_torch.models import zeldovich

    if catalog == "random":
        return _particles(torch, HEADLINE, HEADLINE_SPACING, g.device)
    psi = g.generate_displacement(2)
    pos = zeldovich.zeldovich_positions(psi, HEADLINE_SPACING).reshape(3, -1)
    del psi
    torch.cuda.empty_cache()
    return pos


def _check_paint(torch, errs, catalog, pos, wt, window, shift):
    """KP bit-equal to its plain version and to a second call; the
    deposit's folded total equal to the sums' own; KPC on that total
    bit-equal to contrast_plain."""
    from randomfield_tpu_torch.ops import paint

    sp = HEADLINE_SPACING
    order = paint.ORDERS[window]
    s = paint.fixed_point_exponent(paint.total_abs_weight(pos, wt))
    got, total = paint._deposit(pos, HEADLINE, sp, wt, order, shift, s)
    again = paint.deposit(pos, HEADLINE, sp, wt, order, shift, s)
    same = torch.equal(got, again)
    del again
    want = paint.deposit_plain(pos, HEADLINE, sp, wt, order, shift, s)
    equal = torch.equal(got, want)
    folded = int(total) == int(want.sum())
    d, mean = paint._contrast(got, s, total)
    dp, mp = paint.contrast_plain(want, s)
    kpc = torch.equal(d, dp) and mean == mp
    weights = "per particle" if isinstance(wt, torch.Tensor) else wt
    log(f"phase 1 KP {window} {catalog} weights={weights} shift={shift} "
        f"{pos.shape[1]} particles on {HEADLINE}: int64 sums equal to plain "
        f"{equal}, two calls equal {same}, folded total equal {folded}, "
        f"contrast on it equal {kpc} (2^{s} units)")
    if not (equal and same and folded and kpc):
        raise AssertionError(f"KP {window} ({catalog}) disagrees with its "
                             f"plain version")
    errs["KP"] = 0.0  # the int64 sums are equal (checked above)
    errs["KPC"] = max(errs.get("KPC", 0.0), float((d - dp).abs().max()))
    del got, want, d, dp
    torch.cuda.empty_cache()


def phase1_mocks(torch, g, errs):
    """KP, KC and K4L against their plain versions on the card at the 1024^3
    paths' shapes.  KP on two catalogs, 1024^3 particles in random order
    (plus 4096 on faces, at L, below 0) and a 1024^3 Zel'dovich catalog in
    lattice order: NGP, CIC and TSC, scalar and per-particle weights, the
    interlacing shift (KP_CHECKS), the int64 sums bit-equal to the plain
    version's and to a second call, the folded total exact, the contrast
    on it bit-equal.  KC on the scene's sigma grid and a K2F
    unit draw with M = 1, 8, 40 and 64 (in passes) off-grid
    constraints (R = 0 among them),
    s = 0 and 8: MEASURE within KC_MEASURE_RTOL, CORRECT bit-equal.  K4L on
    a render's spectrum after its x and y passes, the lognormal planes' a
    and c, within K4's bar of c2r_tail_plain then expm1."""
    from randomfield_tpu_torch.models import constrained
    from randomfield_tpu_torch.ops import constraint, fft

    dev, sp = g.device, HEADLINE_SPACING
    for catalog in ("random", "Zel'dovich"):
        pos = _catalog_positions(torch, g, catalog)
        w = torch.rand(pos.shape[1], device=dev,
                       generator=torch.Generator(device=dev).manual_seed(3)) * 2
        for window, weighted, shift in KP_CHECKS:
            _check_paint(torch, errs, catalog, pos, w if weighted else 1.0,
                         window, shift * sp)
        del pos, w
        torch.cuda.empty_cache()

    sig = g.sigmas
    for m in KC_COUNTS + KC_BLOCKED[:1]:
        cons = _constraint_set(m, HEADLINE, sp, m)
        p, r, _ = constrained.pack_constraints(cons, HEADLINE, sp)
        tables = constraint.axis_tables(p, r, HEADLINE, sp, dev)
        for s in (0.0, 8.0):
            re, im = constrained.unit_hermitian(5, HEADLINE, sp, dev)
            pr, pi = re.clone(), im.clone()
            got = constraint.measure(re, im, tables, sig, s)
            want = constraint.measure_plain(pr, pi, tables, sig, s)
            scaled = torch.equal(re, pr) and torch.equal(im, pi)
            rel = float((got - want).abs().max()) / max(
                float(want.abs().max()), 1e-300)
            alpha = np.random.default_rng(m).normal(size=m).astype(np.float32)
            constraint.correct(re, im, tables, alpha, sig, s)
            constraint.correct_plain(pr, pi, tables, alpha, sig, s)
            equal = torch.equal(re, pr) and torch.equal(im, pi)
            log(f"phase 1 KC M={m} s={s} {HEADLINE}: measure rel "
                f"{rel:.3e} (bar {KC_MEASURE_RTOL:g}), scaled draws equal "
                f"{scaled}, correction bit-equal {equal}")
            if not (rel <= KC_MEASURE_RTOL and scaled and equal):
                raise AssertionError(f"KC M={m} s={s} disagrees")
            errs["KC"] = max(errs.get("KC", 0.0),
                             float((got - want).abs().max()))
            del re, im, pr, pi
            torch.cuda.empty_cache()

    nx, ny, nz = HEADLINE
    re, im = g._sampled_spectrum(3, 0.0)
    fft.ifft_axis(re, im, 1, nx, ny * (nz // 2 + 1))
    fft.ifft_axis(re, im, nx, ny, nz // 2 + 1)
    wz = g.state.lightcone_weights
    var = 0.5
    a = wz.clone()
    c = (0.5 * (wz.double() ** 2 * var)).float()
    got = fft.c2r_tail_exp(re, im, nz, a, c)
    want = fft.c2r_tail_exp_plain(re, im, nz, a, c)
    check_close(errs, "K4L", f"{HEADLINE} lognormal tail", (got,), (want,))
    del re, im, got, want
    torch.cuda.empty_cache()


def _power_law(shape, spacing, amplitude):
    """The reference tests' low-amplitude spectrum (tests/test_zeldovich.py
    _scaled_default): amplitude A / k over [k_min / 2, 2 k_max], A setting
    sigma(8 Mpc/h) = 0.8288."""
    from randomfield_tpu_torch.ops import grid, power

    kmin, kmax = grid.get_k_bounds(shape, spacing)
    k = np.logspace(np.log10(kmin * 0.5), np.log10(kmax * 2.0), 256)
    kr = np.logspace(-4.5, 2.5, 4096)
    a = (0.8288 / power.sigma8((kr, 1.0 / kr))) ** 2
    return (k, amplitude * a / k)


def phase2_mocks(torch, rft, dev):
    """The reference tests' gates on the card, and each mock path on the
    card against the CPU at 128^3."""
    from randomfield_tpu_torch.models import lognormal, zeldovich
    from randomfield_tpu_torch.ops import power as _power
    from randomfield_tpu_torch.validate import stats

    shape, sp = MOCK_SHAPE, MOCK_SPACING
    # lognormal: P(k) of 8 seeds against the target (5 sigma + 6%), mean 0
    # and min > -1, the per-plane lightcone variance
    gen = lognormal.LognormalGenerator(*shape, sp, device=dev)
    acc, mins, means, planes = [], [], [], []
    for s in range(LOGNORMAL_SEEDS):
        d = gen.generate_delta_field(s, apply_lightcone=False)
        mins.append(float(d.min()))
        means.append(float(d.double().mean()))
        k, p, cnt = stats.calculate_power(d, sp, nbins=10)
        acc.append(p)
        dl = gen.generate_delta_field(s)
        planes.append(dl.double().var(dim=(0, 1)).cpu().numpy())
    p_mean, p_sd = _seed_mean(acc)
    mask = cnt > 4
    target = np.interp(np.log10(k[mask]), np.log10(gen.power.k),
                       gen.power.Pk)
    worst = float(np.max(np.abs(p_mean[mask] - target)
                         / (5.0 * p_sd[mask] + 0.06 * target)))
    pred = np.expm1(np.asarray(gen.growth_function) ** 2 * gen.sigma_g2)
    plane_err = float(np.max(np.abs(np.mean(planes, 0) / pred - 1.0)))
    mean_bar = 4 * np.sqrt(gen.predicted_variance()
                           / (LOGNORMAL_SEEDS * np.prod(shape)))
    log(f"phase 2 lognormal {shape}: P(k) of {LOGNORMAL_SEEDS} seeds vs "
        f"target, max |resid| / (5 sigma + 6%) {worst:.3f}; min {min(mins):.4f}"
        f" > -1; mean {np.mean(means):.3e} (bar {mean_bar:.3e}); per-plane "
        f"lightcone variance vs expm1(D^2 sigma_G^2) max rel {plane_err:.4f} "
        f"(bar 0.25)")
    if not (worst < 1.0 and min(mins) > -1.0 and abs(np.mean(means))
            < mean_bar and plane_err < 0.25):
        raise AssertionError("the lognormal gates failed")

    # Zel'dovich: the displaced lattice recovers linear P(k) at low k; the
    # Kaiser monopole boost and quadrupole (same-seed ratios); interlaced
    # TSC against the field's own P(k)
    table = _power_law(shape, sp, 3e-3)
    g = rft.Generator(*shape, grid_spacing=sp, power=table, device=dev)
    psi = g.generate_displacement(11)
    pos = zeldovich.zeldovich_positions(psi, sp)
    k, p, nm = zeldovich.catalog_power(pos, sp, nbins=12, window="cic")
    ok = np.isfinite(p) & (nm > 60) & (k < 0.5 * np.pi / sp)
    pexp = _power.interpolate_power(
        rft.validate_power(table), torch.as_tensor(k[ok], dtype=torch.float32)
    ).double().numpy()
    resid = p[ok] / pexp - 1.0
    lin = float(np.max(np.abs(resid) / (5.0 * np.sqrt(2.0 / nm[ok]) + 0.1)))
    f = 0.7
    mono, quad = [], []
    for seed in range(1, KAISER_SEEDS + 1):
        psi = g.generate_displacement(seed)
        pr = zeldovich.catalog_power(
            zeldovich.zeldovich_positions(psi, sp), sp, nbins=10,
            window="cic")
        ps = zeldovich.catalog_power_multipoles(
            zeldovich.zeldovich_positions(psi, sp, f=f), sp, nbins=10,
            window="cic")
        ok2 = np.isfinite(pr[1]) & (pr[2] > 30) & (pr[0] < 0.3 * np.pi / sp)
        mono.append(ps[1][0][ok2] / pr[1][ok2])
        quad.append(ps[1][1][ok2] / pr[1][ok2])
    k0 = 1.0 + 2.0 * f / 3.0 + f * f / 5.0
    k2 = 4.0 * f / 3.0 + 4.0 * f * f / 7.0
    m0 = float(np.concatenate(mono).mean()) / k0 - 1.0
    m2 = float(np.concatenate(quad).mean()) / k2 - 1.0
    field = g.generate_delta_field(5, apply_lightcone=False)
    psi = g.generate_displacement(5)
    pos = zeldovich.zeldovich_positions(psi, sp)
    kc, pc, nc = zeldovich.catalog_power(pos, sp, nbins=10, window="tsc",
                                         interlaced=True)
    kf, pf, _ = stats.calculate_power(field, sp, nbins=10)
    okf = np.isfinite(pc) & (nc > 30) & (kc < 0.5 * np.pi / sp)
    tsc = float(np.max(np.abs(pc[okf] / pf[okf] - 1.0)))
    log(f"phase 2 Zel'dovich {shape}: linear P(k) max |resid| / budget "
        f"{lin:.3f}; Kaiser monopole / (1 + 2f/3 + f^2/5) - 1 = {m0:+.4f} "
        f"(bar 0.08), quadrupole / (4f/3 + 4f^2/7) - 1 = {m2:+.4f} (bar "
        f"0.15) over {KAISER_SEEDS} seeds; interlaced TSC catalog P / field "
        f"P max |ratio - 1| {tsc:.4f} (bar 0.15)")
    if not (lin < 1.0 and abs(m0) < 0.08 and abs(m2) < 0.15 and tsc < 0.15):
        raise AssertionError("the Zel'dovich gates failed")
    del psi, pos, field
    torch.cuda.empty_cache()

    # constraints: met exactly at 128^3, the conditional mean and variance,
    # the Wiener MSE against its prediction, the posterior mean = the filter
    g = rft.Generator(*shape, grid_spacing=sp, device=dev)
    cons = _constraint_set(MOCK_CONSTRAINTS, shape, sp, 21)
    vals = np.array([c[1] for c in cons])
    d = g.generate_constrained_field(7, cons, smoothing_length=6.0)
    sat = float(np.max(np.abs(g.measure_constraints(d, cons) - vals)))
    gc = rft.Generator(*COND_SHAPE, grid_spacing=COND_SPACING, device=dev)
    c1 = [((64.0, 64.0, 64.0), 2.0, 30.0)]
    mean_field = gc.constrained_mean_field(c1)
    fields = torch.stack([gc.generate_constrained_field(s, c1)
                          for s in range(COND_SEEDS)])
    sd = np.sqrt(gc.predicted_variance())
    mres = float((fields.mean(0) - mean_field).abs().max())
    probe = (192.0, 128.0, 64.0)
    pi, pj, pk = (int(round(x / COND_SPACING)) for x in probe)
    xi = gc.constraint_matrix(c1 + [(probe, 0.0, 0.0)])
    cond_var = xi[1, 1] - xi[1, 0] ** 2 / xi[0, 0]
    var = float(fields[:, pi, pj, pk].double().var())
    var_bar = 5.0 * cond_var * np.sqrt(2.0 / COND_SEEDS)
    log(f"phase 2 constraints: {MOCK_CONSTRAINTS} at {shape} met within "
        f"{sat:.2e} (bar {CONSTRAINT_BAR:g}); {COND_SEEDS} seeds at "
        f"{COND_SHAPE}: |mean - conditional mean| {mres:.4f} (bar "
        f"{6.0 * sd / np.sqrt(COND_SEEDS):.4f}), probe variance {var:.5f} vs "
        f"conditional {cond_var:.5f} (bar {var_bar:.5f})")
    if not (sat < CONSTRAINT_BAR and mres < 6.0 * sd / np.sqrt(COND_SEEDS)
            and abs(var - cond_var) < var_bar):
        raise AssertionError("the constraint gates failed")
    # s = 0 with the set's R = 0 constraint off the grid: met before the
    # Hermitian projection, and the field misses by what it drops
    pre, post, field = projection_misses(torch, g, cons, 7)
    log(f"phase 2 constraints at s = 0 {shape} (an R = 0 one off the grid):"
        f" corrected spectrum misses {pre:.2e} before the Hermitian "
        f"projection (bar 1e-5), {post:.2e} after it; the field "
        f"{field:.2e} (bar: the projection's, 1e-5)")
    if not (pre <= 1e-5 and abs(field - post) <= 1e-5):
        raise AssertionError("the constraints' miss is not the projection's")
    del fields
    truth = g.generate_delta_field(4, apply_lightcone=False)
    gen_n = torch.Generator(device=dev).manual_seed(0)
    noise_std = 0.5 * float(truth.std())
    data = truth + noise_std * torch.randn(truth.shape, device=dev,
                                           generator=gen_n)
    npow = noise_std ** 2 * sp ** 3
    rec = g.wiener_filter(data, npow)
    mse = float(((rec - truth).double() ** 2).mean())
    pred = g.predicted_posterior_mse(npow)
    post = g.generate_posterior_field(9, data, npow)
    mse_post = float(((post - truth).double() ** 2).mean())
    gc_truth = gc.generate_delta_field(0, apply_lightcone=False)
    cstd = float(gc_truth.std())
    cdata = gc_truth + cstd * torch.randn(gc_truth.shape, device=dev,
                                          generator=gen_n)
    cpow = cstd ** 2 * COND_SPACING ** 3
    crec = gc.wiener_filter(cdata, cpow)
    mean_post = torch.stack([gc.generate_posterior_field(s, cdata, cpow)
                             for s in range(POSTERIOR_SEEDS)]).mean(0)
    scatter = np.sqrt(gc.predicted_posterior_mse(cpow) / POSTERIOR_SEEDS)
    pm = float((mean_post - crec).abs().max())
    log(f"phase 2 Wiener {shape}: MSE {mse:.5f} vs predicted {pred:.5f} "
        f"(bar 20%), posterior MSE / 2 predicted {mse_post / (2 * pred):.4f} "
        f"(bar 1 +- 0.2); posterior mean of {POSTERIOR_SEEDS} seeds vs the "
        f"filter at {COND_SHAPE}: max |d| {pm:.4f} (bar {6 * scatter:.4f})")
    if not (abs(mse - pred) < 0.2 * pred
            and abs(mse_post - 2 * pred) < 0.4 * pred and pm < 6 * scatter):
        raise AssertionError("the Wiener / posterior gates failed")

    # each path's field on the card against the CPU one
    cpu = torch.device("cpu")
    gcpu = rft.Generator(*shape, grid_spacing=sp, device=cpu)
    lcpu = lognormal.LognormalGenerator(*shape, sp, device=cpu)
    dcpu = data.cpu()
    pairs = (
        ("lognormal", lambda: gen.generate_delta_field(3),
         lambda: lcpu.generate_delta_field(3)),
        ("constrained", lambda: g.generate_constrained_field(7, cons),
         lambda: gcpu.generate_constrained_field(7, cons)),
        ("constrained mean", lambda: g.constrained_mean_field(cons),
         lambda: gcpu.constrained_mean_field(cons)),
        ("Wiener", lambda: g.wiener_filter(data, npow),
         lambda: gcpu.wiener_filter(dcpu, npow)),
        ("posterior", lambda: g.generate_posterior_field(9, data, npow),
         lambda: gcpu.generate_posterior_field(9, dcpu, npow)),
    )
    for what, on_card, on_cpu in pairs:
        a, b = on_card().cpu(), on_cpu()
        _, r = rel_err((a,), (b,))
        log(f"phase 2 {what} {shape}: CUDA vs CPU max|d| / max|cpu| {r:.3e} "
            f"(bar {MOCK_SLICE_BAR:g})")
        if not r <= MOCK_SLICE_BAR:
            raise AssertionError(f"{what}: CUDA and CPU disagree")
    psi = gcpu.generate_displacement(6)
    pos = zeldovich.zeldovich_positions(psi, sp, f=0.5)
    got = zeldovich.catalog_power_multipoles(pos.to(dev), sp, window="tsc",
                                             interlaced=True, nbins=16)
    want = zeldovich.catalog_power_multipoles(pos, sp, window="tsc",
                                              interlaced=True, nbins=16)
    r = float(np.max(np.abs(got[1] - want[1])) / np.max(np.abs(want[1])))
    log(f"phase 2 catalog_power_multipoles(tsc, interlaced) {shape}: CUDA vs "
        f"CPU {r:.3e} (bar 1e-5), counts equal "
        f"{np.array_equal(got[2], want[2])}")
    if not (r <= 1e-5 and np.array_equal(got[2], want[2])):
        raise AssertionError("the catalog power on the card disagrees")
    torch.cuda.empty_cache()


def _path(torch, what, fn, least, total):
    """Run one 1024^3 mock path with the launch counts zeroed before it and
    read after it; fail if it skipped a kernel of ``least`` or called
    torch.fft; print its launches, host seconds and peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    require_launches(counts, least, what)
    if counts["torch.fft"]:
        raise AssertionError(f"{what} went through torch.fft")
    for k in KERNEL_ORDER:
        total[k] += counts[k]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"phase 3 main path {what} {HEADLINE}: launches "
        f"{ {k: n for k, n in counts.items() if n} }, torch.fft calls 0; "
        f"{dt:.3f} s on the host clock (first call), peak device memory "
        f"{peak:.3f} GiB")
    return out, peak


def phase3_mocks(torch, rft, dev, card):
    """The mock makers at 1024^3 (2 Mpc/h) through the public API: the
    lognormal render (its transformed spectrum on the card, K2F, K3, K4L),
    the Zel'dovich catalog (displacement, redshift-space positions, the
    interlaced TSC multipoles: KP twice), the constrained field with 8
    constraints checked by measure_constraints, the Wiener filter and the
    posterior sample with white noise.  Returns the launch counts, summed,
    and the peaks."""
    from randomfield_tpu_torch.models import lognormal, zeldovich

    total = dict.fromkeys(KERNEL_ORDER, 0)
    peaks = {}
    sp = HEADLINE_SPACING
    holder = {}

    def lognormal_path():
        holder["ln"] = lognormal.LognormalGenerator(*HEADLINE, sp, device=dev)
        return holder["ln"].generate_delta_field(0)

    d, peaks["lognormal"] = _path(
        torch, "LognormalGenerator(...).generate_delta_field", lognormal_path,
        {"K6": 1, "K3": 4, "K4": 1, "KB": 1, "K2F": 1, "K4L": 1}, total)
    ln = holder.pop("ln")
    info = ln.transform_info
    var = float(d.double().var())
    log(f"phase 3 lognormal {HEADLINE}: sigma_G^2 {ln.sigma_g2:.6f}, "
        f"clipped_fraction {info['clipped_fraction']:.3e}, variance "
        f"{var:.6f} vs predicted (lightcone) "
        f"{float(np.mean(np.expm1(np.asarray(ln.growth_function) ** 2 * ln.sigma_g2))):.6f}"
        f", min {float(d.min()):.4f}, finite {bool(torch.isfinite(d).all())}")
    if not (bool(torch.isfinite(d).all()) and float(d.min()) > -1.0):
        raise AssertionError("the 1024^3 lognormal field is not a density")
    del d, ln
    g = rft.Generator(*HEADLINE, grid_spacing=sp, device=dev)
    f = float(g.cosmology.growth_rate(0.0))

    def zeldovich_path():
        psi = g.generate_displacement(2)
        pos = zeldovich.zeldovich_positions(psi, sp, f=f)
        del psi
        return zeldovich.catalog_power_multipoles(pos, sp, window="tsc",
                                                  interlaced=True,
                                                  nbins=NBINS)

    (k, p_ell, n), peaks["zeldovich"] = _path(
        torch, "generate_displacement -> zeldovich_positions(f) -> "
        "catalog_power_multipoles(tsc, interlaced)", zeldovich_path,
        {"K2F": 1, "KD": 3, "KP": 2, "KPC": 2, "K6": 2, "K3": 4, "KB": 1},
        total)
    low = (n > 100) & np.isfinite(p_ell[0])
    log(f"phase 3 Zel'dovich catalog {HEADLINE}, f = {f:.4f}: P_2 / P_0 at "
        f"the lowest bins {np.round(p_ell[1][low][:4] / p_ell[0][low][:4], 4)}"
        f" (Kaiser 4f/3 + 4f^2/7 over 1 + 2f/3 + f^2/5 = "
        f"{(4 * f / 3 + 4 * f * f / 7) / (1 + 2 * f / 3 + f * f / 5):.4f})")
    if not np.all(np.isfinite(p_ell[:, low])):
        raise AssertionError("the 1024^3 catalog multipoles are not finite")
    torch.cuda.empty_cache()

    cons = _constraint_set(MOCK_CONSTRAINTS, HEADLINE, sp, 8)
    vals = np.array([c[1] for c in cons])
    d, peaks["constrained"] = _path(
        torch, f"generate_constrained_field ({MOCK_CONSTRAINTS} constraints)",
        lambda: g.generate_constrained_field(3, cons),
        {"K2F": 1, "KC": 2, "K3": 2, "K4": 1}, total)
    met, _ = _path(torch, "measure_constraints",
                   lambda: g.measure_constraints(d, cons),
                   {"K6": 1, "K3": 2, "KC": 1}, total)
    err = float(np.max(np.abs(met - vals)))
    log(f"phase 3 constrained {HEADLINE}: constraints met within {err:.2e} "
        f"(bar {CONSTRAINT_BAR:g}), finite {bool(torch.isfinite(d).all())}")
    if not (err < CONSTRAINT_BAR and bool(torch.isfinite(d).all())):
        raise AssertionError("the 1024^3 constrained field misses its "
                             "constraints")
    noise_std = 0.5 * float(d.std())
    gen_n = torch.Generator(device=dev).manual_seed(1)
    data = d.add_(noise_std * torch.randn(d.shape, device=dev,
                                          generator=gen_n))
    npow = noise_std ** 2 * sp ** 3
    rec, peaks["wiener"] = _path(torch, "wiener_filter (white noise)",
                                 lambda: g.wiener_filter(data, npow),
                                 {"K6": 1, "K3": 4, "K4": 1}, total)
    del rec
    post, peaks["posterior"] = _path(
        torch, "generate_posterior_field (white noise)",
        lambda: g.generate_posterior_field(4, data, npow),
        {"K2F": 2, "K6": 1, "K3": 4, "K4": 1}, total)
    if not bool(torch.isfinite(post).all()):
        raise AssertionError("the 1024^3 posterior field is not finite")
    del post, data, d
    torch.cuda.empty_cache()
    return total, peaks


def kc_pass_times(torch, g, re, im, restore, counts, card):
    """Log KC's passes at 1024^3 for each M of ``counts`` on the draws
    ``re``, ``im`` (``restore()`` puts them back): MEASURE with the scale,
    without it, CORRECT, each with the constraints a pass of its plan takes
    where the package has a plan."""
    from randomfield_tpu_torch.models import constrained
    from randomfield_tpu_torch.ops import constraint

    sp, dev, sig = HEADLINE_SPACING, g.device, g.sigmas
    for m in counts:
        cs = _constraint_set(m, HEADLINE, sp, m)
        pm, rm, _ = constrained.pack_constraints(cs, HEADLINE, sp)
        tm = constraint.axis_tables(pm, rm, HEADLINE, sp, dev)
        am = np.ones(m, np.float32)
        t0 = cuda_ms(torch, lambda: constraint.measure(re, im, tm, sig),
                     setup=restore)
        t1 = cuda_ms(torch, lambda: constraint.measure(re, im, tm))
        t2 = cuda_ms(torch, lambda: constraint.correct(re, im, tm, am, sig),
                     setup=restore)
        plan = getattr(constraint, "launch_plan", None)
        tables = "" if plan is None else (
            f" (constraints a pass: measure "
            f"{plan(False, True, *HEADLINE, m)[0]}, correct "
            f"{plan(True, True, *HEADLINE, m)[0]})")
        log(f"phase 4 KC M={m} {HEADLINE}{tables}: measure with the scale "
            f"{t0:.3f} ms, measure {t1:.3f} ms, correct {t2:.3f} ms; both "
            f"passes of a render {t0 + t2:.3f} ms [{card}]")


def kc_times_only(torch, rft, dev, card):
    """``--kc-times``: KC's passes alone (:func:`kc_pass_times` at every M
    of phase 4) with the package beside this script, to set a tree's KC
    against another's on one card."""
    from randomfield_tpu_torch.models import constrained

    g = rft.Generator(*HEADLINE, grid_spacing=HEADLINE_SPACING, device=dev)
    re, im = constrained.unit_hermitian(5, HEADLINE, HEADLINE_SPACING, dev)
    keep = (re.clone(), im.clone())

    def restore():
        re.copy_(keep[0])
        im.copy_(keep[1])

    kc_pass_times(torch, g, re, im, restore, KC_COUNTS + KC_BLOCKED, card)


def phase4_mocks(torch, rft, dev, g, card):
    """Times at 1024^3: KP (CIC, scalar weight, a 1024^3 Zel'dovich
    catalog) beside its plain version and index_add_ of the same int64
    terms (8 calls), and NGP, CIC and TSC on it and on a random catalog, by
    pass; KPC on the deposit's total; KC's
    MEASURE (with the scale, M = 8) and CORRECT beside their plain
    versions; K4L beside c2r_tail_exp_plain and torch.fft.irfft; the stages
    of the lognormal, constrained and posterior renders, and the
    Zel'dovich catalog's.  Returns {K: (ms, plain_ms, library_ms)}."""
    from randomfield_tpu_torch.models import constrained, lognormal
    from randomfield_tpu_torch.models import zeldovich
    from randomfield_tpu_torch.ops import constraint, fft, paint, transform

    sp = HEADLINE_SPACING
    nx, ny, nz = HEADLINE
    out = {}
    pos = _catalog_positions(torch, g, "Zel'dovich")
    s = paint.fixed_point_exponent(paint.total_abs_weight(pos, 1.0))
    k_ms, p_ms, _ = time_kernel(
        torch, "KP deposit cic, Zel'dovich order (all passes)",
        lambda: paint.deposit(pos, HEADLINE, sp, 1.0, 2, 0.0, s),
        lambda: paint.deposit_plain(pos, HEADLINE, sp, 1.0, 2, 0.0, s),
        None, None, HEADLINE, card, plain_reps=1)
    # the library: index_add_ of the same int64 terms, one call a corner
    # and block of KP_LIB_BLOCK particles (their terms held one at a time)
    grid = torch.zeros(nx * ny * nz, dtype=torch.int64, device=dev)
    spacing32 = torch.tensor(sp, dtype=torch.float32, device=dev)
    lib_ms = 0.0
    for lo in range(0, pos.shape[1], KP_LIB_BLOCK):
        u = pos[:, lo:lo + KP_LIB_BLOCK] / spacing32
        for idx, fac in paint.window_terms(u, 2):
            wc = fac[0] * fac[1] * fac[2]
            q = torch.round(wc.double() * 2.0 ** s).long()
            flat = paint._flat(idx, HEADLINE)
            del idx, fac, wc
            lib_ms += cuda_ms(torch, lambda: grid.index_add_(0, flat, q),
                              reps=1)
            del q, flat
        del u
        torch.cuda.empty_cache()
    del grid
    torch.cuda.empty_cache()
    log(f"phase 4 KP library (index_add_ of the same int64 terms: 8 corners "
        f"x {-(-pos.shape[1] // KP_LIB_BLOCK)} blocks of {KP_LIB_BLOCK} "
        f"particles) {HEADLINE}: {lib_ms:.3f} ms [{card}]")
    out["KP"] = (k_ms, p_ms, lib_ms)
    kp_windows(torch, pos, "Zel'dovich", card)
    acc, total = paint._deposit(pos, HEADLINE, sp, 1.0, 2, 0.0, s)
    del pos
    torch.cuda.empty_cache()
    # KPC as paint() runs it: the kernel on the deposit's folded total (one
    # int64 read by the host); beside it, contrast() summing the grid first
    out["KPC"] = time_kernel(
        torch, "KPC contrast on the deposit's total",
        lambda: paint._contrast(acc, s, total),
        lambda: paint.contrast_plain(acc, s), None, None, HEADLINE, card,
        plain_reps=1)
    summed = cuda_ms(torch, lambda: paint.contrast(acc, s))
    log(f"phase 4 KPC contrast(acc, s), the total summed from the grid "
        f"(acc.sum() read by the host) first: {summed:.3f} ms [{card}]")
    del acc, total
    torch.cuda.empty_cache()
    pos = _catalog_positions(torch, g, "random")
    kp_windows(torch, pos, "random", card)
    del pos
    torch.cuda.empty_cache()

    sig = g.sigmas
    cons = _constraint_set(MOCK_CONSTRAINTS, HEADLINE, sp, 8)
    p, r, _ = constrained.pack_constraints(cons, HEADLINE, sp)
    tables = constraint.axis_tables(p, r, HEADLINE, sp, dev)
    re, im = constrained.unit_hermitian(5, HEADLINE, sp, dev)
    keep = (re.clone(), im.clone())

    def restore():
        re.copy_(keep[0])
        im.copy_(keep[1])

    alpha = np.random.default_rng(1).normal(size=MOCK_CONSTRAINTS).astype(
        np.float32)
    m_ms, mp_ms, _ = time_kernel(
        torch, f"KC measure M={MOCK_CONSTRAINTS} (with the scale)",
        lambda: constraint.measure(re, im, tables, sig),
        lambda: constraint.measure_plain(re, im, tables, sig), None, restore,
        HEADLINE, card, plain_reps=1)
    c_ms, cp_ms, _ = time_kernel(
        torch, f"KC correct M={MOCK_CONSTRAINTS}",
        lambda: constraint.correct(re, im, tables, alpha, sig),
        lambda: constraint.correct_plain(re, im, tables, alpha, sig), None,
        restore, HEADLINE, card, plain_reps=1)
    kc_pass_times(torch, g, re, im, restore, KC_COUNTS + KC_BLOCKED, card)
    log(f"phase 4 KC operations of the design, a mode and constraint: "
        f"measure {KC_DESIGN_OPS['measure']} (of them 2 F2F.F64.F32 at a "
        f"quarter of the float64 rate, 3 float64), correct "
        f"{KC_DESIGN_OPS['correct']} float32; the bound counts "
        f"{KC_OPS_PER_MODE_AND_CONSTRAINT} a pass")
    out["KC"] = (m_ms + c_ms, mp_ms + cp_ms, None)
    log(f"phase 4 KC both passes of a render (M={MOCK_CONSTRAINTS}): "
        f"{m_ms + c_ms:.3f} ms, plain {mp_ms + cp_ms:.3f} ms [{card}]")
    del re, im, keep
    torch.cuda.empty_cache()

    spec = g._sampled_spectrum(3, 0.0)
    fft.ifft_axis(spec[0], spec[1], 1, nx, ny * (nz // 2 + 1))
    fft.ifft_axis(spec[0], spec[1], nx, ny, nz // 2 + 1)
    a = g.state.lightcone_weights.clone()
    c = (0.5 * (a.double() ** 2 * 0.5)).float()
    cplx = torch.complex(spec[0], spec[1])
    out["K4L"] = time_kernel(
        torch, "K4L c2r_tail_exp",
        lambda: fft.c2r_tail_exp(spec[0], spec[1], nz, a, c),
        lambda: fft.c2r_tail_exp_plain(spec[0], spec[1], nz, a, c),
        lambda: torch.fft.irfft(cplx, n=nz, dim=-1, norm="forward"), None,
        HEADLINE, card)
    del spec, cplx
    torch.cuda.empty_cache()

    # the stages of the new paths, by CUDA events between the stages
    ln = lognormal.LognormalGenerator(*HEADLINE, sp, device=dev)
    var = ln.gaussian.predicted_variance()
    a_z, c_z = lognormal._plane_terms(var, ln.growth_function, nz, 1.0, dev)
    st = {}

    def lognormal_stages():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        r, i = ln.gaussian._sampled_spectrum(0, 0.0)
        ev[1].record()
        fft.ifft_axis(r, i, 1, nx, ny * (nz // 2 + 1))
        ev[2].record()
        fft.ifft_axis(r, i, nx, ny, nz // 2 + 1)
        ev[3].record()
        fft.c2r_tail_exp(r, i, nz, a_z, c_z)
        ev[4].record()
        torch.cuda.synchronize()
        return [ev[j].elapsed_time(ev[j + 1]) for j in range(4)]

    lognormal_stages()
    rows = np.median([lognormal_stages() for _ in range(TIMING_REPS)], 0)
    total = cuda_ms(torch, lambda: ln.generate_delta_field(0))
    log(f"phase 4 lognormal render {HEADLINE}: {total:.3f} ms = K2F "
        f"{rows[0]:.3f} + K3 x {rows[1]:.3f} + K3 y {rows[2]:.3f} + K4L "
        f"{rows[3]:.3f}; the Gaussian render alone "
        f"{cuda_ms(torch, lambda: ln.gaussian.generate_delta_field(0)):.3f} "
        f"ms [{card}]")
    t0 = time.perf_counter()
    lognormal.transformed_power(ln.power, HEADLINE, sp, device=dev)
    torch.cuda.synchronize()
    log(f"phase 4 transformed_power {HEADLINE}: "
        f"{1e3 * (time.perf_counter() - t0):.1f} ms (host clock) [{card}]")
    del ln
    torch.cuda.empty_cache()

    gram = g._constraint_gram_cached(p, r, 0.0)
    vals = np.array([c[1] for c in cons])

    def constrained_stages():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        rr, ii = constrained.unit_hermitian(3, HEADLINE, sp, dev)
        ev[1].record()
        gm = constraint.measure(rr, ii, tables, sig)
        ev[2].record()
        al = constrained._solve(gram, vals - gm.cpu().numpy())
        ev[3].record()
        constraint.correct(rr, ii, tables, al, sig)
        ev[4].record()
        transform.hermitian_part_reim(rr, ii, nz)
        ev[5].record()
        transform.irfftn_reim(rr, ii, HEADLINE)
        ev[6].record()
        torch.cuda.synchronize()
        return [ev[j].elapsed_time(ev[j + 1]) for j in range(6)]

    constrained_stages()
    rows = np.median([constrained_stages() for _ in range(TIMING_REPS)], 0)
    total = cuda_ms(torch, lambda: g.generate_constrained_field(3, cons))
    t0 = time.perf_counter()
    constrained.constraint_gram(sig, p, r, 0.0, HEADLINE, sp)
    torch.cuda.synchronize()
    gram_ms = 1e3 * (time.perf_counter() - t0)
    log(f"phase 4 constrained render {HEADLINE} (M={MOCK_CONSTRAINTS}): "
        f"{total:.3f} ms = K2F unit draw {rows[0]:.3f} + KC measure "
        f"{rows[1]:.3f} + solve (host) {rows[2]:.3f} + KC correct "
        f"{rows[3]:.3f} + plane projection {rows[4]:.3f} + K3 K3 K4 "
        f"{rows[5]:.3f}; the Gram matrix (once a constraint set) "
        f"{gram_ms:.1f} ms (host clock) [{card}]")
    pre, post, miss = projection_misses(torch, g, cons, 3)
    log(f"phase 4 constrained render {HEADLINE} (M={MOCK_CONSTRAINTS}, "
        f"s = 0): constraints missed by {pre:.2e} before the Hermitian "
        f"projection, {post:.2e} after it, {miss:.2e} by the field")
    ms, peak = timed_peak(torch, lambda: g.generate_constrained_field(
        3, cons), reps=3)
    log(f"phase 4 generate_constrained_field {HEADLINE} "
        f"(M={MOCK_CONSTRAINTS}): {ms:.3f} ms; peak device memory {peak} "
        f"[{card}]")
    field = g.generate_delta_field(4, apply_lightcone=False)
    npow = 0.25 * float(field.var()) * sp ** 3
    for what, fn in (
            ("wiener_filter", lambda: g.wiener_filter(field, npow)),
            ("generate_posterior_field",
             lambda: g.generate_posterior_field(4, field, npow)),
            ("measure_constraints",
             lambda: g.measure_constraints(field, cons))):
        ms, peak = timed_peak(torch, fn, reps=3)
        log(f"phase 4 {what} {HEADLINE}: {ms:.3f} ms; peak device memory "
            f"{peak} [{card}]")
    del field
    torch.cuda.empty_cache()
    f = float(g.cosmology.growth_rate(0.0))
    psi = g.generate_displacement(2)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    pos = zeldovich.zeldovich_positions(psi, sp, f=f)
    ev[1].record()
    d1, _ = zeldovich.paint(pos, HEADLINE, sp, window="tsc")
    ev[2].record()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zeldovich.catalog_power_multipoles(pos, sp, window="tsc",
                                       interlaced=True, nbins=NBINS)
    ev[3].record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    t = [ev[j].elapsed_time(ev[j + 1]) for j in range(3)]
    log(f"phase 4 Zel'dovich catalog {HEADLINE}: positions {t[0]:.3f} ms, "
        f"one TSC painting (deposit + contrast) {t[1]:.3f} ms, "
        f"catalog_power_multipoles(tsc, interlaced) {t[2]:.3f} ms (two "
        f"paintings, two forward transforms, KB), its peak device memory "
        f"{peak / 2**30:.3f} GiB ({base / 2**30:.3f} GiB held before it) "
        f"[{card}]")
    del psi, pos, d1
    torch.cuda.empty_cache()
    return out


def kp_design_bytes(n, dims, order):
    """The bytes KP's passes move for n particles (scalar weight) on a
    grid of ``dims``: the positions read by the count, scatter and deposit
    passes, the int32 index written and read, the tiles' counts (zeroed,
    added, scanned, read), the grid written, the shell scratch written and
    read, and the gather's band cells (a local place below r on some axis)
    read and written."""
    from randomfield_tpu_torch.ops import paint

    r = order - 1
    tiles = int(np.prod(paint.tile_grid(dims)))
    cells = int(np.prod(dims))
    inner = int(np.prod([sum(1 for x in range(d) if x % paint.TILE >= r)
                         for d in dims]))
    return (3 * 12 * n + 2 * 4 * n + 5 * 8 * tiles + 8 * cells
            + 2 * 8 * tiles * paint.shell_slots(dims, order)
            + 2 * 8 * (cells - inner))


def kp_passes(torch, fn):
    """{pass: device ms} of one call of ``fn`` under torch.profiler (its
    kernels' spans by name), or None when the trace holds no device
    activity (as it mostly does this deep into the run; a fresh process
    traces every call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation()
                or e.end_ns() <= e.start_ns()):
            continue
        name = next((k for k in ("count", "scatter", "deposit", "gather")
                     if f"{k}_kernel" in e.name()), "scan and fills")
        out[name] += (e.end_ns() - e.start_ns()) / 1e6
    return {k: round(v, 3) for k, v in out.items()} or None


def kp_windows(torch, pos, catalog, card):
    """Times of KP's NGP, CIC and TSC (the interlacing shift) on one
    catalog at 1024^3, by pass, beside the design's bytes and the bound's."""
    from randomfield_tpu_torch.ops import paint

    sp, n = HEADLINE_SPACING, pos.shape[1]
    s = paint.fixed_point_exponent(paint.total_abs_weight(pos, 1.0))
    bound = 12 * n + 8 * int(np.prod(HEADLINE))
    for window, shift in (("ngp", 0.0), ("cic", 0.0), ("tsc", sp / 2)):
        order = paint.ORDERS[window]

        def run():
            return paint.deposit(pos, HEADLINE, sp, 1.0, order, shift, s)

        passes = kp_passes(torch, run)
        ms = cuda_ms(torch, run)
        design = kp_design_bytes(n, HEADLINE, order)
        log(f"phase 4 KP deposit {window} shift={shift} {catalog} order, "
            f"{n} particles on {HEADLINE}: {ms:.3f} ms (all passes); by "
            f"pass, torch.profiler: {passes}; the design "
            f"moves {design / 1e9:.3f} GB ({1e3 * design / HBM_BYTES_PER_S:.3f}"
            f" ms at the HBM rate), the bound's {bound / 1e9:.3f} GB "
            f"({1e3 * bound / HBM_BYTES_PER_S:.3f} ms); the shell: scratch "
            f"slots gathered on the owner's side, no atomics [{card}]")
        torch.cuda.empty_cache()


def kernel_bounds(g):
    """{K: (bound_ms, bound_by)} at the 1024^3 main paths' shapes: the larger
    of the bytes each kernel must move (inputs read once, outputs written
    once) over the HBM rate and its operations over the float32 rate.  K6
    at the one-rank forward transform's shape, K7 and K8 on one shard of a
    four-rank mesh."""
    nx, ny, nz = HEADLINE
    nzh = nz // 2 + 1
    modes, cells = nx * ny * nzh, nx * ny * nz
    shard = nx * (ny // MESH_RANKS) * nzh
    from randomfield_tpu_torch.ops import fft

    knots = 4 * g.state.table.knots.numel()
    m = nz // 2

    def fft_ops(n, lines):
        return 5.0 * n * np.log2(n) * lines

    work = {  # (bytes, operations)
        "K1": (8 * modes + knots, OPS_PER_MODE["K1"] * modes),
        "K2": (16 * modes + knots, OPS_PER_MODE["K2"] * modes),
        # the lattices written and the knots read; two hashes a mode
        "K2F": (8 * modes + knots, OPS_PER_MODE["K2F"] * modes),
        "K3": (2 * 16 * modes + 4 * (nx + ny),
               fft_ops(nx, ny * nzh) + fft_ops(ny, nx * nzh)),
        "K4": (8 * modes + 4 * cells + 4 * nz + 4 * m,
               fft_ops(m, nx * ny) + 10.0 * m * nx * ny + cells),
        # the knots, k vectors and edges read; the sums written
        "K5": (knots + 4 * (nx + ny + nzh + NBINS + 1) + 24 * NBINS,
               OPS_PER_MODE["K5"] * modes),
        # the field read, the spectrum written, the twiddles; the m-point
        # FFTs and the unfold (8 adds and 8 multiplies per packed mode)
        "K6": (4 * cells + 8 * modes + 8 * m,
               fft_ops(m, nx * ny) + 16.0 * modes),
        "K7": (8 * shard + knots, OPS_PER_MODE["K2F"] * shard),
        "K8": (8 * shard + knots, OPS_PER_MODE["K1"] * shard),
        # both passes of a v4 render: each lattice read and written once
        "K9": (2 * 16 * modes + 4 * (nx + ny),
               fft_ops(nx, ny * nzh) + fft_ops(ny, nzh * nx)),
        # the lattices written, the two planes, the knots and the twiddles
        # read; the draw of each bulk mode and the transform of every line
        "K10": (8 * modes + 16 * nx * ny + knots
                + 8 * fft.pass_twiddles(nx, +1, "cpu").shape[0],
                OPS_PER_MODE["K10"] * modes - K10_DRAW_OPS * 2 * nx * ny),
        # the lattices written and the knots read (KN, K2F fixed); the
        # lattices read and written once (KD)
        "KN": (8 * modes + knots, OPS_PER_MODE["KN"] * modes),
        "K2FX": (8 * modes + knots, OPS_PER_MODE["K2FX"] * modes),
        "KD": (16 * modes, OPS_PER_MODE["KD"] * modes),
        # auto: the spectrum read once, the k vectors and edges; the sums
        # written
        "KB": (8 * modes + 4 * (nx + ny + nzh + NBINS + 1) + 24 * NBINS,
               OPS_PER_MODE["KB"] * modes),
        # its geometry pass: the k vectors and thresholds read, the counts
        # and |k| sums written
        "KBG": (4 * (nx + ny + nzh + NBINS + 1) + 16 * NBINS,
                OPS_PER_MODE["KBG"] * modes),
        # KP (CIC, scalar weight, one particle a cell): the positions read
        # once, the int64 grid written once
        "KP": (12 * cells + 8 * cells, KP_OPS_PER_PARTICLE * cells),
        # KPC: the int64 sums read once, the float32 contrast written once;
        # its float64 operations, counted at the float32 rate's scale
        "KPC": (8 * cells + 4 * cells,
                KPC_FP64_OPS_PER_CELL * cells * FP32_OPS_PER_S
                / FP64_OPS_PER_S),
        # KC, both passes of a render with M constraints: MEASURE reads the
        # draws and the sigma grid and writes the scaled draws, CORRECT reads
        # the spectrum and the sigma grid and writes the spectrum
        "KC": (2 * 20 * modes + 8 * MOCK_CONSTRAINTS * (nx + ny + nzh),
               2 * KC_OPS_PER_MODE_AND_CONSTRAINT * MOCK_CONSTRAINTS * modes),
        # K4L: K4's bytes (and its planes' second array) and operations
        "K4L": (8 * modes + 4 * cells + 8 * nz + 4 * m,
                fft_ops(m, nx * ny) + 10.0 * m * nx * ny
                + K4L_OPS_PER_CELL * cells),
    }
    for what, n, lines in (("x", nx, ny * nzh), ("y", ny, nx * nzh)):
        t_pass = max((16 * modes + 4 * n) / HBM_BYTES_PER_S,
                     fft_ops(n, lines) / FP32_OPS_PER_S)
        log(f"phase 4 K3 bound of the {what} pass alone: {1e3 * t_pass:.4f} ms")
    out = {}
    for k, (nbytes, ops) in work.items():
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
        out[k] = (1e3 * max(t_bytes, t_ops),
                  "bytes" if t_bytes >= t_ops else "operations")
        at = (f"one shard ({nx}, {ny // MESH_RANKS}, {nzh})"
              if k in ("K7", "K8") else f"{HEADLINE}")
        log(f"phase 4 {k} bound at {at}: {nbytes / 1e9:.4f} GB -> "
            f"{1e3 * t_bytes:.4f} ms, {ops / 1e9:.2f} G operations -> "
            f"{1e3 * t_ops:.4f} ms; bound {out[k][0]:.4f} ms by {out[k][1]}")
    return out


def main() -> int:
    import torch

    if sys.argv[1:] not in ([], ["--kc-times"]):
        print("usage: python3 chip_smoke.py [--kc-times]", file=sys.stderr)
        return 2
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

    wall0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # the default phases run with the switch unset; the variants' phases set
    # it around each render
    os.environ.pop(PIPELINE_ENV, None)
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
        if sys.argv[1:] == ["--kc-times"]:
            kc_times_only(torch, rft, dev, card)
            return 0
        phase0_attributes(card)
        phase0_sass(torch, card)
        phase0_mocks(torch, card)

        t0 = time.perf_counter()
        g = rft.Generator(*HEADLINE, grid_spacing=HEADLINE_SPACING, device=dev)
        log(f"phase 0 scene setup {HEADLINE}: {time.perf_counter() - t0:.3f} s "
            f"on the host")
        gp = rft.Generator(*HEADLINE, grid_spacing=HEADLINE_SPACING,
                           device=dev, sampler="pallas")

        errs = {}
        phase1_draw_scale(torch, g, errs)
        torch.cuda.empty_cache()
        phase1_kernels(torch, g, errs)
        torch.cuda.empty_cache()
        phase1_sampler(torch, gp, errs)
        phase1_mesh_kernels(torch, g, gp, errs)
        phase1_staged_kernels(torch, gp, errs)
        gn = rft.Generator(*HEADLINE, grid_spacing=HEADLINE_SPACING,
                           device=dev, sampler="nested")
        phase1_slice(torch, g, gn, errs)
        del gn
        torch.cuda.empty_cache()
        phase1_measure(torch, rft, dev, g, gp, errs)
        torch.cuda.empty_cache()
        phase1_mocks(torch, g, errs)
        torch.cuda.empty_cache()
        phase2_slice(torch, rft, dev)
        phase2_slice_fields(torch, rft, dev)
        phase2_variants(torch, rft, dev)
        phase2_gate(torch, dev)
        phase2_gate(torch, dev, stream="genfft")
        phase2_consistency(torch, rft, dev)
        torch.cuda.empty_cache()
        phase2_measure(torch, rft, dev)
        torch.cuda.empty_cache()
        phase2_mocks(torch, rft, dev)
        torch.cuda.empty_cache()
        launches = dict.fromkeys(KERNEL_ORDER, 0)
        main_paths = [phase3_main(torch, g), phase3_noise(torch, g),
                      phase3_main(torch, gp),
                      phase3_config4(torch, gp, card)[0]]
        torch.cuda.empty_cache()
        main_paths.append(phase3_four_ranks(torch, dev, card))
        mesh = nccl_one_rank_mesh(dev)
        main_paths.append(phase3_one_rank(torch, rft, dev, mesh))
        torch.cuda.empty_cache()
        main_paths.append(phase3_variants(torch, rft, gp, card))
        torch.cuda.empty_cache()
        main_paths.append(phase3_slice(torch, rft, dev, g, card))
        torch.cuda.empty_cache()
        main_paths.append(phase3_measure(torch, rft, dev, g, card))
        torch.cuda.empty_cache()
        mock_launches, mock_peaks = phase3_mocks(torch, rft, dev, card)
        main_paths.append(mock_launches)
        for counts in main_paths:
            for k in KERNEL_ORDER:
                launches[k] += counts[k]
        torch.cuda.empty_cache()
        times = phase4_times(torch, rft, dev, g, gp, card)
        times.update(phase4_mesh(torch, rft, dev, g, gp, mesh, card))
        times.update(phase4_slice(torch, rft, dev, g, card))
        times.update(phase4_measure(torch, rft, dev, g, card))
        torch.cuda.empty_cache()
        times.update(phase4_mocks(torch, rft, dev, g, card))
        bounds = kernel_bounds(g)
        log(f"phase 4 peak device memory of the 1024^3 mock paths (GiB): "
            f"{ {k: round(v, 3) for k, v in mock_peaks.items()} } [{card}]")
        log(f"chip_smoke wall time {time.perf_counter() - wall0:.1f} s "
            f"[{card}]")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    finally:
        from randomfield_tpu_torch.parallel import multihost

        multihost.shutdown()

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
