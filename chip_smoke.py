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
   kernel on the nested stream), K2F's fixed mode and KN's (cuobjdump), and
   the issue-rate time they imply; K2F's spectrum instance held to its
   registers and instructions a mode (K2F_SPECTRUM_SASS), K2F's fixed mode
   below K2FX_SASS_BEFORE a mode, and K5 to its
   (K5_SASS: its binning code, csrc/bins_common.cuh, must not move); the
   registers of KB's eighteen instances (four kinds and the geometry pass;
   the outputs and the read probe) and its launch plans at 1024^3; K4's
   1024^3 instance held to its registers and SASS count (K4_SASS_512) with
   K4L in its template, the registers of KP's, KC's and K4L's instances,
   the shared-memory atomics of KP's deposit instances and what a 64-bit
   atomicAdd on shared memory compiles to; KC MEASURE's loop a kz step
   (its F2F.F64.F32 and float64 instructions) and KC's plans at M = 1, 8,
   40, 64, 128 and 3000 (the constraints a pass takes); the registers of
   KM's and KX's instances, KX's shared memory a block and blocks an SM,
   and KM's launch at 1024^3; KQ's registers, shared memory a block and
   blocks an SM in each mode (isotropic, wedges, Legendre rows) and of its
   sort's passes, and its cell plan for the 2^17-object paths; KH's
   registers and blocks an SM in each of its three passes;
1. ROADMAP F6: K2's amplitude step by step (log10|k|, t, i0, frac, the
   amplitude at s = 0 and 8) over every |k|^2 of the 1024^3 grid through
   the kernels' device functions (scale_sigma.cu's check entry) against
   sigma_steps_plain, equal bit for bit; then
   each hand kernel against its plain PyTorch version on the card, at the
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
   fixed field; the unit normals' largest ulp distance), K2F's fixed mode
   draw_fixed (s = 0 and 8: within the bar of draw_fixed_plain, and equal
   bit for bit to K2 of the plain z / |z| of the plain draws; |c| = sigma
   filter, the paired field the exact negation), the fixed modes'
   device z / |z| (phase.cuh:unit_phase, through sampler.unit_phases) on
   about 10^8 directed and random pairs equal to torch's sqrt and division
   bit for bit, and KD apply_kernel (each kind and component);
   KB bin_spectrum on the forward transforms of two 1024^3 renders (and the
   Kaiser expectation grid): auto, cross, interlaced and grid, each
   isotropic, with ells (0, 2, 4), with nmu = 4 wedges, with the cic
   window and at its most bins (1024 with the multipoles, 256 x 4 wedges),
   counts equal to the plain version's, sums within 1e-10, two calls
   bit-equal, and its geometry pass alone (KBG, on folded lines;
   isotropic, 4 wedges and a (1024, 256, 513) shard) against the plain
   version's counts (exactly) and |k| sums (within 1e-12); K5's block at
   256^3 against its stored digest; the
   threefry and pallas scenes' sigma tables unchanged, the nested tables
   of 512^3 and 1024^3 over one box sharing their knots; KP on 1024^3
   particles in random order (plus particles on faces, at L and below 0)
   and on 1024^3 Zel'dovich positions in lattice order (NGP, CIC, TSC,
   scalar and per-particle weights, the interlacing shift) bit-equal to
   its plain version and to a second call, the deposit's folded total
   equal to the sums' and KPC on it bit-equal, KC (M = 1, 8, 40 and 64, the
   last in two passes; s = 0 and 8) MEASURE within 1e-10 and CORRECT
   bit-equal, K4L within K4's bar; KM (the Minkowski invariants and
   threshold bins) on the nine derivative fields of a smoothed 1024^3
   render (counts equal, sums within 1e-10, two calls bit-equal) and KX
   (lattice extrema) in its peak (with the band mask), minima and void
   modes on the render and on the render with planted voids, equal to
   their plain versions; K2 (s = 0, 8), K2F's spectrum (the plain draws
   times sigma_amplitude) and K2F's fixed mode (draw_fixed_plain) equal to
   their plain versions bit for bit; KQ (pair counts on a cell list) on
   2^17 weighted objects with objects on edges, on faces and coincident:
   auto, isotropic, 10 wedges and the Legendre rows (0, 2, 4) along each
   axis, and against a 2^16-object catalog; on the clustered Zel'dovich
   sample in every mode, a box with 2 cells on z, one cell and a reach
   whose cells the cap limits: equal to the brute pair_sums_plain bit for
   bit, two calls bit-equal, the pairs examined equal to the cell walk's
   own count; KH (jax.random.poisson replayed cell by cell) on the 1024^3
   halo counts of 4 mass bins and on a 256^3 grid of lambda >= 10 (the
   rejection passes) against poisson_counts_plain, the cells that differ
   printed with their tie test (at most 1e-8 of the cells, ties only), and
   KD's 'deriv' and 'recon' kinds bit for bit;
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
   and each mock path on the card against the CPU; the nine morphology
   methods (Minkowski, peaks, minima, the stacked and peak profiles, voids,
   kNN-CDFs; measured and predicted) and a power='halofit' render on the
   card against the CPU at 128^3 (counts, totals, CDFs and catalogs
   equal); the catalog statistics on the card against the CPU (pair counts
   of 3000 objects equal; FKP, marked and velocity statistics at 128^3
   within 2e-5) and the JAX package's gates: uniform catalogs' xi = 0,
   Poisson tracers' xi against the theory, the Kaiser anisotropy of pair
   multipoles, FKP's Poisson-lognormal recovery, the linear marked power
   against its Wick prediction, the seed-direct velocity cross against its
   prediction; the device models on the card against the CPU at 64^3 (the
   halo counts: KH on the CPU's render bit for bit, end to end each
   difference a tie of the two renders' intensities; the galaxies,
   poisson_sample, second_order_density, the tree bispectrum, lensing,
   the multi-tracer pair, reconstruction, the Fisher matrix) and their
   JAX gates (halo counts and halo power at 256^3, galaxies at 256^3,
   sigma_kappa growing with z_source at 512^3, reconstruction's r(k) at
   256^3);
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
   memory; the JAX package's morphology gates at 512^3 (Minkowski v0-v3,
   peaks and minima against BBKS, the peak profile, the underdense
   fraction, a non-overlapping void catalog, the kNN-CDFs of random
   catalogs against the binomial) and the nine morphology methods at
   1024^3 with their launches (KM, KX) and peak memory (Minkowski under 60
   GiB); catalog_correlation and its multipoles of 2^17 Zel'dovich objects
   (KQ), fkp_power (CIC, TSC) and its multipoles of 2^24 Poisson data and
   2^27 randoms, calculate_marked_power, density_velocity_correlation and
   pairwise_velocity at 1024^3, with their launches and peak memory; the
   device models at 1024^3 (halo counts and catalog, galaxies with and
   without RSD, poisson_sample, second_order_density, the tree bispectrum
   at nbins = 8, the lensing maps and E/B power, the multi-tracer pair,
   reconstruction; the Fisher multipoles at 256^3), with their launches
   (KH among them) and peak memory;
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
   geometry (the geometry pass and the data pass) and calculate_power's
   first call for its geometry, the geometry pass alone
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
   and posterior with their peak memory; KM and KX (peaks, the mask, the
   void mode) beside their plain versions, KX beside its read yardstick
   (torch.sum of the same field) and its walk's cells loaded a cell, and
   each morphology method at 1024^3 with the transforms' share of it; KQ
   beside its plain version (in turns) and in its three modes, its plan on
   the Zel'dovich sample (cells, items, occupancy), its stages (the plan's
   host read, the sort, the pair kernel, the check) and its pairs examined
   beside cell_walk_pairs and their components that wrap; the catalog
   paths split into their stages (painting, transforms, binning, KQ); KH
   beside its plain version, on the bins below and at lambda >= 10 apart,
   and the device models' paths; and the whole run's wall time.

The line before the last is a JSON object of the kernels; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

``python3 chip_smoke.py --kc-times`` builds the kernels and logs KC's
passes at every M of phase 4 alone, with the package beside the script:
copied into another checkout, it sets that tree's KC against this one's
on the same card.  ``--kx-times`` does the same for KX: its three modes
at 1024^3 held to their plain versions, timed, beside the read yardstick;
``--kq-times`` for KQ: its phase-0 attributes and plan, its phase-1 checks
and its phase-4 times.
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
    # nested draw, K2F's fixed mode and the derived fields' spectral kernel
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
    # the morphology estimators' XLA work: the Minkowski invariants and
    # their one-hot threshold bins (and :120 _threshold_bins); the 27-cube
    # extrema of the peak counts (and :212 _peak_bins) and of the void
    # finder's candidates (randomfield_tpu/models/voids.py:287)
    "KM": dict(name="minkowski_threshold_sums", route="cuda",
               source="randomfield_tpu_torch/csrc/minkowski.cu",
               replaces="randomfield_tpu/validate/minkowski.py:66"),
    "KX": dict(name="lattice_extrema", route="cuda",
               source="randomfield_tpu_torch/csrc/extrema.cu",
               replaces="randomfield_tpu/validate/peaks.py:202"),
    # the catalogs' pair counts: XLA's chunked minimum-image loop (and :63
    # _dot_rows, its one-hot contraction)
    "KQ": dict(name="pair_counts", route="cuda",
               source="randomfield_tpu_torch/csrc/pair_counts.cu",
               replaces="randomfield_tpu/validate/paircount.py:79"),
    # the device models' Poisson draws: XLA's jax.random.poisson (its
    # Knuth and rejection loops) in the halo scan (and
    # randomfield_tpu/models/zeldovich.py:114 poisson_sample)
    "KH": dict(name="poisson_counts", route="cuda",
               source="randomfield_tpu_torch/csrc/poisson.cu",
               replaces="randomfield_tpu/models/halos.py:155"),
}
KERNEL_ORDER = ("K1", "K2", "K2F", "K3", "K4", "K5", "K6", "K7", "K8", "K9",
                "K10", "KN", "K2FX", "KD", "KB", "KBG", "KP", "KPC", "KC",
                "K4L", "KM", "KX", "KQ", "KH")
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


def check_bit_equal(torch, errs, kid, what, got, want):
    """Fail unless paired float32 tensors are equal bit for bit; logs the
    values that differ and keeps the largest absolute error in errs[kid]."""
    differ = sum(int((g.view(torch.int32) != w.view(torch.int32)).sum())
                 for g, w in zip(got, want))
    a, r = rel_err(got, want)
    errs[kid] = max(errs.get(kid, 0.0), a)
    total = sum(w.numel() for w in want)
    log(f"phase 1 {kid} {what}: {differ} of {total} values differ "
        f"(bit-equal required), max|d| {a:.3e}, rel {r:.3e}")
    if differ:
        raise AssertionError(f"{kid} {what} is not bit-equal to its plain "
                             f"version")


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
# modes, four hashes.  KN's loop holds a quad of rows: four modes, four
# hashes; KNX is its fixed mode (nested_modes_kernel<2>)
SASS_KERNELS = {"K1": ("sample_modes_kernel", 1),
                "K2F": (r"draw_scale_kernelILi0E(?:Lb0E)?E", 2),
                "K5": ("power_bins_kernel", 1),
                "KN": (r"nested_modes_kernelILi0EE", 1),
                "K2FX": (r"draw_scale_kernelILi3ELb0EE", 2),
                "KNX": (r"nested_modes_kernelILi2EE", 1)}
# K2F's spectrum instance (draw_scale_kernel<0, false>, the one a 1024^3
# render runs): its registers and hot SASS instructions a mode as built for
# sm_90a since its x-row-pair walk; the other modes of the same template
# must not move them.  (NVVM's code for it depends on the rest of the
# file: it took 54 registers, the same 363 a mode, while the fixed mode
# called __fsqrt_rn and __fdiv_rn, and takes 48 without them, as with no
# fixed mode at all.  Rounding log10|k| and t apart (sigma_common.cuh,
# ROADMAP F6) took 363.0 to 364.0: the product and the difference that
# one FFMA did before.)
K2F_SPECTRUM_SASS = (48, 364.0)
# K2F's fixed instance's hot SASS a mode while its modulus was __fsqrt_rn
# and two __fdiv_rn, each with its range test and slow-path branch; since
# phase.cuh's unit_phase (their fast paths alone, one shared reciprocal) it
# must stay below it
K2FX_SASS_BEFORE = 404.0
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
    regs, hot = counts["K2FX"][0], counts["K2FX"][4]
    log(f"phase 0 K2F fixed instance: {regs} registers, {hot:.1f} hot "
        f"instructions a mode; below {K2FX_SASS_BEFORE:.1f}, its count with "
        f"__fsqrt_rn and two __fdiv_rn [{card}]")
    if not hot < K2FX_SASS_BEFORE:
        raise AssertionError("K2F's fixed mode issues no fewer instructions "
                             "than with __fsqrt_rn and __fdiv_rn")
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
    # K2's amplitude rounds each step as sigma_amplitude does (ROADMAP F6):
    # the same float32 products of the same inputs, so bit for bit
    for s in (0.0, 8.0):
        a, b = re.clone(), im.clone()
        sampler.scale_sigma(a, b, table, g.shape, g.grid_spacing, s,
                            gain=RENDER_GAIN)
        c, d = re.clone(), im.clone()
        sampler.scale_sigma_plain(c, d, table, g.shape, g.grid_spacing, s,
                                  gain=RENDER_GAIN)
        torch.cuda.synchronize()
        check_bit_equal(torch, errs, "K2", f"{tuple(re.shape)} s={s}",
                        (a, b), (c, d))
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


SIGMA_STEPS = ("lk", "t", "i0", "frac", "amp")
# x planes a step of the sigma-step check (bounds its temporaries)
SIGMA_STEP_PLANES = 64


def phase1_sigma_steps(torch, g):
    """ROADMAP F6: K2's amplitude on the card step by step over every |k|^2
    of the 1024^3 scene ``g`` (as sigma_amplitude sums it), through the
    kernels' own device functions (sampler.sigma_steps, csrc/scale_sigma.cu's
    check entry) against the plain version's steps (sigma_steps_plain):
    log10|k|, t, i0, frac and the amplitude at s = 0 and 8 with the render's
    gain.  Logs how many values of each step differ and the first step that
    parts; fails unless every step is equal bit for bit."""
    from randomfield_tpu_torch.ops import sampler

    table, shape, sp = g.state.table, g.shape, g.grid_spacing
    c = sampler._constants(table, shape, sp)
    differ = dict.fromkeys(SIGMA_STEPS, 0)
    differ["amp s=8"] = 0
    n = 0
    for x0 in range(0, shape[0], SIGMA_STEP_PLANES):
        m = min(SIGMA_STEP_PLANES, shape[0] - x0)
        kx, ky, kz = sampler._axis_k(c, shape, x0, m, 0, shape[1], g.device)
        ksq = (kx * kx)[:, None, None] + (ky * ky)[None, :, None]
        ksq = ksq + (kz * kz)[None, None, :]
        n += ksq.numel()
        for s_, keys in ((0.0, SIGMA_STEPS), (8.0, ("amp",))):
            got = sampler.sigma_steps(table, ksq, s_, RENDER_GAIN)
            want = sampler.sigma_steps_plain(table, ksq, s_, RENDER_GAIN)
            for k in keys:
                a, b = got[k], want[k]
                if a.dtype == torch.float32:
                    a, b = a.view(torch.int32), b.view(torch.int32)
                differ[k if s_ == 0.0 else "amp s=8"] += int((a != b).sum())
        del ksq, got, want
    parted = [k for k in SIGMA_STEPS if differ[k]]
    log(f"phase 1 F6 K2's amplitude step by step over the {n} |k|^2 of "
        f"{shape}: values that differ from the plain version {differ}; "
        f"first step that parts: {parted[0] if parted else 'none'}")
    if any(differ.values()):
        raise AssertionError(f"K2's amplitude parts from sigma_amplitude at "
                             f"{parted[0] if parted else 'the filter'}")


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
        check_bit_equal(torch, errs, "K2F", f"{tuple(got.shape)} s={s_} vs "
                        f"the plain draws times sigma_amplitude",
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
    from randomfield_tpu_torch.ops import extrema, minkowski

    minkowski.KM_LAUNCHES = extrema.KX_LAUNCHES = 0
    from randomfield_tpu_torch.ops import paircount

    paircount.KQ_LAUNCHES = paircount.KQ_SORT_LAUNCHES = 0
    from randomfield_tpu_torch.ops import poisson

    poisson.KH_LAUNCHES = 0


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
            "KD": derived.KD_LAUNCHES, **mock_counts(), **morph_counts(),
            **catalog_counts(), **models_counts()}


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


# the device z / |z| against torch's: each of the 2^23 normals of the
# canonical stream paired with UNIT_PHASE_ROLLS others (rolled copies) and
# with itself, its negation, +-0 and its sqrt(2) multiple and 0 (a
# self-conjugate mode), the four signed zero pairs, and UNIT_PHASE_RANDOM
# random pairs of components 0 or of magnitude in [2^-24, 2^4), random
# mantissas and signs
UNIT_PHASE_ROLLS = 8
UNIT_PHASE_RANDOM = 2**25
UNIT_PHASE_BATCH = 2**24


def unit_phase_pairs(torch, dev):
    """Yield the check's (re, im) batches, float32 vectors on ``dev``."""
    from randomfield_tpu_torch.ops import threefry

    n = threefry._normal_from_bits(
        torch.arange(2**23, dtype=torch.int64, device=dev) << 9)
    zero = torch.zeros_like(n)
    sqrt2 = torch.tensor(1.4142135623730951, dtype=torch.float32, device=dev)
    yield n, zero
    yield n, -zero
    yield n * sqrt2, zero
    yield n, n
    yield n, -n
    for k in range(1, UNIT_PHASE_ROLLS + 1):
        yield n, torch.roll(n, 977 * k * k)
    z = torch.tensor([0.0, -0.0], dtype=torch.float32, device=dev)
    yield z.repeat(2), z.repeat_interleave(2)
    gen = torch.Generator(device=dev).manual_seed(11)
    for _ in range(UNIT_PHASE_RANDOM // UNIT_PHASE_BATCH):
        pair = []
        for _ in range(2):
            mant = torch.randint(0, 2**23, (UNIT_PHASE_BATCH,), generator=gen,
                                 device=dev)
            expo = torch.randint(127 - 24, 127 + 4, (UNIT_PHASE_BATCH,),
                                 generator=gen, device=dev)
            sign = torch.randint(0, 2, (UNIT_PHASE_BATCH,), generator=gen,
                                 device=dev)
            word = (sign << 31) | (expo << 23) | mant
            # one component in 64 is 0
            word = torch.where(mant % 64 == 0, sign << 31, word)
            pair.append(torch.where(word >= 2**31, word - 2**32, word)
                        .to(torch.int32).view(torch.float32))
        yield pair[0], pair[1]


def phase1_unit_phase(torch, dev):
    """phase.cuh:unit_phase (sampler.unit_phases) against the plain z / |z|
    (sample.unit_phase: torch's sqrt and division) on the card, bit for
    bit, over the pairs of :func:`unit_phase_pairs`."""
    from randomfield_tpu_torch.ops import sample, sampler

    pairs = differ = 0
    for re, im in unit_phase_pairs(torch, dev):
        pad = -re.numel() % 4096
        re = torch.cat([re, re.new_ones(pad)]).view(-1, 4096)
        im = torch.cat([im, im.new_zeros(pad)]).view(-1, 4096)
        got_re, got_im = sampler.unit_phases(re, im)
        want_re, want_im = sample.unit_phase(re.clone(), im.clone())
        same = ((got_re.view(torch.int32) == want_re.view(torch.int32))
                & (got_im.view(torch.int32) == want_im.view(torch.int32)))
        differ += int((~same).sum())
        pairs += re.numel() - pad
    torch.cuda.synchronize()
    log(f"phase 1 K2FX/KN unit_phase over {pairs} directed and random pairs "
        f"vs torch's sqrt and division: {differ} differ")
    if differ:
        raise AssertionError(f"phase.cuh:unit_phase differs from torch on "
                             f"{differ} pairs")


def phase1_slice(torch, g, gn, errs):
    """KN, K2F's fixed mode and KD vs their plain versions on the card at
    the 1024^3 shapes and tables of the threefry scene ``g`` and the nested
    scene ``gn``: KN's bits exact, its spectrum (s = 0, 8), unit normals and
    fixed field (s = 0, 8) within the K1 bar, the paired field the exact
    negation; phase.cuh:unit_phase on its check pairs equal to torch's;
    K2F fixed (s = 0, 8) within the bar of its plain version and equal bit
    for bit to K2 (scale_sigma) of the plain z / |z| of the plain draws,
    |c| = sigma filter, the paired field the exact negation; KD in each
    kind and component (and the 2LPT diagonals) within the bar."""
    from randomfield_tpu_torch.ops import derived, sample, sampler, threefry

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
        if mode == "unit":
            # r cos and r sin of the kernel's sincos_turn against torch's
            # cos and sin: the ulps a unit normal moved, and the share of
            # normals that moved
            moved = float((got != want).double().mean())
            log(f"phase 1 KN unit normals vs plain: largest distance "
                f"{max_ulps(torch, got, want)} ulps, {moved:.3e} of them "
                f"not bit-equal")
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

    phase1_unit_phase(torch, g.device)
    t, shape, sp = g.state.table, g.shape, g.grid_spacing
    key = threefry.key_from_seed(seed)
    for s_ in (0.0, 8.0):
        got = sampler.draw_fixed(seed, t, shape, sp, s_)
        want = sampler.draw_fixed_plain(seed, t, shape, sp, s_)
        torch.cuda.synchronize()
        check_bit_equal(torch, errs, "K2FX", f"{tuple(got.shape)} s={s_} vs "
                        f"draw_fixed_plain", (got[0], got[1]),
                        (want[0], want[1]))
        del want
        # the modulus exactly: the plain z / |z| (torch's sqrt and division)
        # of the plain Hermitian draws, times K2's amplitude (scale_sigma)
        re, im = sample.unit_phase(*sample._hermitian_draws(key, shape,
                                                            g.device, False))
        sampler.scale_sigma(re, im, t, shape, sp, s_, gain=1.0)
        torch.cuda.synchronize()
        same = torch.equal(got[0], re) and torch.equal(got[1], im)
        log(f"phase 1 K2FX s={s_}: K2 of the plain z / |z| of the plain "
            f"draws {'= fixed bit for bit' if same else 'DIFFERS'}")
        if not same:
            raise AssertionError("K2F's fixed mode is not the plain z / |z| "
                                 "scaled by K2 bit for bit")
        del re, im
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
# KBG's |k| sums against the plain version's: float32 |k| of the same modes
# added in float64 in another order (the folded lines' multiplicities are
# exact)
KBG_SUM_RTOL = 1e-12
KB_KINDS = ("auto", "cross", "interlaced", "grid")
KB_OUTPUTS = {"isotropic": {}, "ells (0, 2, 4)": dict(ells=(0, 2, 4)),
              "nmu = 4 wedges": dict(nmu=4), "window cic": dict(order=2)}
# KB at its most bins (binning.MAX_BINS; the shared memory's budget)
KB_MAX_OUTPUTS = {"ells (0, 2, 4), 1024 bins": dict(ells=(0, 2, 4),
                                                    nbins=1024),
                  "nmu = 4 wedges, 256 x 4 bins": dict(nmu=4, nbins=256)}
# K5's float64 block at 256^3 (pallas, seed 3, NBINS bins, no smoothing):
# the sha256 of its bytes as the kernel computes it since its sigma
# interpolation rounds log10|k| and t apart (sigma_common.cuh, ROADMAP F6:
# some amplitudes moved by an ulp, and the digest with them); K5's
# registers and hot SASS instructions a mode, which must not move either
# (169.5 before F6, one instruction more a pair of modes since)
K5_DIGEST_SHAPE, K5_DIGEST_SPACING, K5_DIGEST_SEED = (256, 256, 256), 8.0, 3
K5_DIGEST = "f2fa1b02f01d3a8381e64306a1d36045352f6ec951302065605d29a346b27646"
K5_SASS = (48, 170.0)
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
    # counts and |k| sums: counts equal, sums within KBG_SUM_RTOL; on the
    # whole grid (x and y folded) and on one slab shard (x alone)
    ny = HEADLINE[1]
    shard = ny // MESH_RANKS
    for what, nmu, y_off, ny_loc in (
            ("isotropic", 0, 0, ny), ("nmu = 4 wedges", 4, 0, ny),
            (f"isotropic, the shard ({HEADLINE[0]}, {shard}, "
             f"{HEADLINE[2] // 2 + 1}) at y_off {shard}", 0, shard, shard)):
        edges, _ = stats.bin_setup(HEADLINE, spacing, NBINS)
        binning._geometry.cache_clear()
        got = kb_geometry(edges, nmu, dev, y_off, ny_loc)
        want = kb_geometry_plain(torch, grid[:, y_off:y_off + ny_loc], edges,
                                 nmu, y_off)
        counts = torch.equal(got[0], want[0])
        rel = float((got[1] - want[1]).abs().max() / want[1].abs().max())
        errs["KBG"] = max(errs.get("KBG", 0.0),
                          float((got - want).abs().max()))
        log(f"phase 1 KB geometry pass {what} {HEADLINE}: counts "
            f"{'equal' if counts else 'DIFFER'}, |k| sums rel {rel:.3e} "
            f"(bar {KBG_SUM_RTOL:g})")
        if not (counts and rel <= KBG_SUM_RTOL):
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


def kb_geometry(edges, nmu, dev, y_off=0, ny_loc=None):
    """float64 (2, nb): KB's geometry pass (counts, |k| sums by key) of
    the 1024^3 grid's isotropic bins (``nmu`` 0) or wedges, over the ky
    rows [y_off, y_off + ny_loc) (all by default), kept by binning after
    its first call for the geometry."""
    from randomfield_tpu_torch.ops import binning

    return binning._geometry(HEADLINE, float(HEADLINE_SPACING),
                             np.asarray(edges, np.float64).tobytes(), y_off,
                             ny_loc or HEADLINE[1], int(nmu), 2, str(dev))


def kb_geometry_plain(torch, lattice, edges, nmu, y_off=0):
    """:func:`kb_geometry` in plain PyTorch: the counts and |k| sums of
    binning.mode_terms (whose value of ``lattice``, the ky rows from
    ``y_off``, it drops), x-slab by x-slab, by binning.line_sums."""
    from randomfield_tpu_torch.ops import binning

    nb = (len(edges) - 1) * max(1, nmu)
    out = torch.zeros((2, nb + 1), dtype=torch.float64, device=lattice.device)
    for x0 in range(0, HEADLINE[0], 16):
        x1 = min(HEADLINE[0], x0 + 16)
        km, idx, w, _ = binning.mode_terms(
            "grid", (lattice,), HEADLINE, HEADLINE_SPACING, edges, x0, x1,
            y_off, nmu=nmu or None)
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
    # a one-shot call: its geometry not kept, so KBG runs too
    first = cuda_ms(torch, lambda: stats.calculate_power(field, sp, NBINS),
                    setup=binning._geometry.cache_clear)
    log(f"phase 4 calculate_power {HEADLINE}, a first call for the geometry "
        f"(KBG, then KB): {first:.3f} ms; the geometry kept {total:.3f} ms "
        f"[{card}]")
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


def _path(torch, what, fn, least, total, seconds=None):
    """Run one 1024^3 mock path with the launch counts zeroed before it and
    read after it; fail if it skipped a kernel of ``least`` or called
    torch.fft; print its launches, host seconds (kept in ``seconds[what]``
    when given) and peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if seconds is not None:
        seconds[what] = dt
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


# ---- the morphology estimators: KM (Minkowski) and KX (lattice extrema) ---------

# the 1024^3 morphology field: a render smoothed over 4 cells, so lattice
# maxima track continuum ones (validate/peaks.py); its units are the
# predicted sigma0
MORPH_SMOOTHING = 8.0
KM_NBINS = 24
# KM vs plain: the same float32 invariants, summed in float64 in another
# order (per-thread slots and block partials vs index_add_), relative to
# the largest |sum| of each quantity; counts exactly
KM_SUM_RTOL = 1e-10
PEAK_NBINS, PEAK_RANGE = 14, (-2.0, 5.0)
# the void ladder (Mpc/h) and threshold of the 1024^3 paths (about 2000
# voids in the morphology field: the greedy acceptance on the host is
# quadratic in the catalog), and the planted voids of phase 1: (center
# cell, radius in cells, depth below the threshold)
VOID_RADII = (8.0, 12.0, 16.0, 24.0, 32.0)
VOID_THRESHOLD = -1.5
PLANTED_VOIDS = (((100, 200, 300), 12, 3.0), ((700, 40, 1000), 9, 2.5),
                 ((512, 900, 16), 15, 3.5))
KNN_RADII = (4.0, 8.0, 12.0)
# the 1024^3 kNN paths' catalog: a tracer every 64 cells
KNN_TRACERS = 1 << 24
# CUDA vs the port on the CPU at 128^3: u and the counts are the same
# numbers on both sides, the derivative fields and shells come from two
# float32 FFT libraries (v1-v3 and the profiles within these of their
# largest value), the predictions are float64 on both
MORPH_SLICE = ((128, 128, 128), 16.0, 48.0)
MORPH_V_BAR = 1e-4
PROFILE_BAR = 1e-5
PREDICTION_BAR = 1e-9
# the JAX package's gates (tests/test_minkowski.py, test_peaks.py,
# test_profiles.py, test_voids.py, test_knn.py) at 512^3: its peak gate's
# spacing and smoothing, one seed (the volume of 150 of its 96^3 seeds)
MORPH_GATE = ((512, 512, 512), 4.0, 14.0)
MINKOWSKI_GATE_TOLS = (0.03, 0.06, 0.15, 0.18)
KNN_GATE = ((256, 256, 256), 2.0, 400_000, (2.0, 4.0, 6.0), (1, 2, 3), 4)
MINKOWSKI_PEAK_GIB = 60.0
# operations a voxel, counted from the kernels' source.  KM: the invariants
# (63: 3 squares, |g|^2 and tr A 4, g.A.g 15, g.cof(A).g 34, the square
# root, the test, two products and two divisions 7), the edge search (10
# over 25 edges) and the slot adds (a count and three conversions, 4), and
# three float64 adds counted at the float32 rate's scale.  KX (peaks): the
# division and the 26 comparisons of the 27-cube
KM_OPS_PER_VOXEL = 63 + 10 + 4
KM_FP64_ADDS = 3
KX_OPS_PER_VOXEL = 1 + 26
# KX (voids): the key's product and difference, the 26 comparisons, in
# float64
KX_VOID_FP64_OPS_PER_VOXEL = 2 + 26


def morph_counts():
    from randomfield_tpu_torch.ops import extrema, minkowski

    return {"KM": minkowski.KM_LAUNCHES, "KX": extrema.KX_LAUNCHES}


def kx_attributes(card):
    """Each KX instance's registers, shared memory a block and blocks an SM
    (the peak instance at PEAK_NBINS bins)."""
    from randomfield_tpu_torch.ops import extrema

    for what, voids, mask in (("peaks", False, False),
                              ("peaks with the mask", False, True),
                              ("voids", True, False)):
        regs, blocks, threads, smem = extrema.kernel_attributes(
            voids, PEAK_NBINS, mask)
        log(f"phase 0 KX {what}: {regs} registers a thread, {smem} bytes of "
            f"shared memory a block, {blocks} blocks an SM of {threads} "
            f"threads [{card}]")
        if regs <= 0 or blocks <= 0:
            raise AssertionError(f"KX {what} takes no block an SM")


def phase0_morphology(card):
    """The registers of KM's and KX's instances, KX's shared memory and
    blocks an SM, and KM's launch at 1024^3 with 24 bins."""
    from randomfield_tpu_torch.ops import _build, minkowski

    regs = res_usage(_build.library_path(), _build.cuda_tool("cuobjdump"))
    wanted = {"minkowski_bins_kernel": "KM bins",
              "minkowski_total_kernel": "KM block partials' sum",
              "peaks_kernel": "KX peaks", "voids_kernel": "KX voids"}
    found = {what: r for f, r in regs.items() for frag, what in wanted.items()
             if frag in f}
    log(f"phase 0 KM and KX registers a thread: {found} [{card}]")
    missing = sorted(set(wanted.values()) - set(found))
    if missing:
        raise AssertionError(f"KM's or KX's instances are missing: {missing}")
    kx_attributes(card)
    threads, blocks, smem = minkowski.launch_plan(KM_NBINS,
                                                  int(np.prod(HEADLINE)))
    log(f"phase 0 KM plan at {HEADLINE}, {KM_NBINS} bins: {blocks} blocks of "
        f"{threads} threads, {smem} bytes of shared memory a block [{card}]")
    if threads == 0:
        raise AssertionError("KM takes no launch at 24 bins")


def _morph_field(torch, g, seed):
    """(the 1024^3 morphology render, its predicted sigma0)."""
    field = g.generate_delta_field(seed, smoothing_length=MORPH_SMOOTHING,
                                   apply_lightcone=False)
    return field, float(np.sqrt(g.predicted_variance(MORPH_SMOOTHING)))


def _minkowski_edges(nbins=KM_NBINS, nu_max=3.0):
    nu = np.linspace(-nu_max, nu_max, nbins)
    dnu = nu[1] - nu[0]
    return np.concatenate([nu - 0.5 * dnu, [nu[-1] + 0.5 * dnu]])


def _plant_voids(torch, field):
    """The field with PLANTED_VOIDS set to -depth inside their radius (a
    one-cell deeper spike at the center), in place."""
    n = field.shape
    for center, r, depth in PLANTED_VOIDS:
        o = torch.arange(-r, r + 1, device=field.device)
        ox, oy, oz = torch.meshgrid(o, o, o, indexing="ij")
        inside = (ox * ox + oy * oy + oz * oz) < r * r
        idx = [((c + a[inside]) % m) for c, a, m in zip(center, (ox, oy, oz),
                                                        n)]
        field[idx[0], idx[1], idx[2]] = -depth
        field[center] = -depth - 1e-3
    return field


def phase1_morphology(torch, g, errs):
    """KM and KX against their plain versions at 1024^3 on the main path's
    inputs: KM on the nine derivative fields of a smoothed render (counts
    equal, sums within KM_SUM_RTOL, two calls bit-equal); KX's peaks (with
    the height band's mask) and minima on the render, and its peaks, minima
    and void candidates on the render with planted voids and its R_v grid:
    equal to the plain versions and bit-equal across two calls."""
    from randomfield_tpu_torch.models import voids
    from randomfield_tpu_torch.ops import extrema
    from randomfield_tpu_torch.ops import minkowski as km
    from randomfield_tpu_torch.validate import minkowski as mk

    field, s0 = _morph_field(torch, g, 11)
    u = extrema.unit_field(field, s0)
    derivs = mk.derivative_fields(u, HEADLINE_SPACING)
    edges = _minkowski_edges()
    got = km.threshold_sums(u, derivs, edges)
    again = km.threshold_sums(u, derivs, edges)
    want = km.threshold_sums_plain(u, derivs, edges)
    counts = torch.equal(got[0], want[0])
    rel = max(float((got[1][q] - want[1][q]).abs().max()
                    / want[1][q].abs().max()) for q in range(3))
    bit = torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    errs["KM"] = float((got[1] - want[1]).abs().max())
    log(f"phase 1 KM threshold_sums {HEADLINE} nbins={KM_NBINS}: counts "
        f"{'equal' if counts else 'DIFFER'} ({int(got[0].sum())} voxels in "
        f"the bins and tail), sums rel {rel:.3e} (bar {KM_SUM_RTOL:g}), two "
        f"calls {'bit-equal' if bit else 'DIFFERENT'}")
    if not (counts and bit and rel <= KM_SUM_RTOL):
        raise AssertionError("KM disagrees with its plain version")
    del u, derivs, got, again, want
    torch.cuda.empty_cache()
    pedges = np.linspace(*PEAK_RANGE, PEAK_NBINS + 1)

    def check_peaks(what, delta):
        for mode, sign, band in (("peaks", 1.0, (1.0, None)),
                                 ("minima", -1.0, None)):
            got = extrema.peak_counts(delta, s0, pedges, sign, band)
            again = extrema.peak_counts(delta, s0, pedges, sign, band)
            want = extrema.peak_counts_plain(delta, s0, pedges, sign, band)
            same = all((a is None and b is None) or torch.equal(a, b)
                       for a, b in zip(got, want))
            bit = all((a is None and b is None) or torch.equal(a, b)
                      for a, b in zip(got, again))
            log(f"phase 1 KX {mode} on {what} {HEADLINE}: total "
                f"{int(got[1])}, counts {got[0].tolist()}"
                f"{', the nu >= 1 mask' if band else ''}: "
                f"{'equal to' if same else 'DIFFER from'} the plain version, "
                f"two calls {'bit-equal' if bit else 'DIFFERENT'}")
            if not (same and bit):
                raise AssertionError(f"KX {mode} on {what} disagrees")

    check_peaks("the render", field)
    _plant_voids(torch, field)
    check_peaks("the render with planted voids", field)
    rv = voids.void_radius_grid(field, HEADLINE_SPACING, VOID_RADII,
                                VOID_THRESHOLD)
    got = extrema.void_candidates(rv, field)
    again = extrema.void_candidates(rv, field)
    want = extrema.void_candidates_plain(rv, field)
    same = np.array_equal(got, want) and np.array_equal(got, again)
    planted = [int(np.ravel_multi_index(c, HEADLINE))
               for c, _, _ in PLANTED_VOIDS]
    found = bool(np.isin(planted, got).all())
    log(f"phase 1 KX void candidates {HEADLINE}, radii {VOID_RADII} "
        f"threshold {VOID_THRESHOLD}: {got.size} candidates, "
        f"{'equal to' if same else 'DIFFER from'} the plain version and "
        f"across two calls; the planted centers "
        f"{'among them' if found else 'MISSING'}")
    if not (same and found):
        raise AssertionError("KX's void mode disagrees")
    errs["KX"] = 0.0
    del field, rv
    torch.cuda.empty_cache()


def _close(got, want, bar):
    """(within, error): max |got - want| over max |want| (NaNs, empty bins,
    in the same places)."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if g.shape != w.shape or not np.array_equal(np.isnan(g), np.isnan(w)):
        return False, float("inf")
    ok = ~np.isnan(w)
    err = float(np.abs(g[ok] - w[ok]).max() / np.abs(w[ok]).max())
    return err <= bar, err


def phase2_morphology(torch, rft, dev):
    """The nine morphology methods and a power='halofit' render on the card
    against the port on the CPU at 128^3: counts, peak totals, kNN-CDFs and
    void catalogs equal (the catalog also from the CPU's R_v grid through
    KX), v1-v3, the profiles and the predictions within their bars."""
    from randomfield_tpu_torch.models import voids
    from randomfield_tpu_torch.ops import paint
    from randomfield_tpu_torch.validate import knn

    shape, sp, sm = MORPH_SLICE
    gd = rft.Generator(*shape, grid_spacing=sp, device=dev)
    gc = rft.Generator(*shape, grid_spacing=sp, device="cpu")
    dc = gc.generate_delta_field(5, smoothing_length=sm, apply_lightcone=False)
    d = dc.to(dev)
    s0 = float(np.sqrt(gc.predicted_variance(sm)))
    w = (dc > s0).to(torch.float32)
    rng = np.random.default_rng(6)
    pos = torch.as_tensor(rng.uniform(0.0, shape[0] * sp,
                                      size=(3, 60_000)).astype(np.float32))
    radii = tuple(4 * sp * f for f in (1.0, 1.5, 2.0, 3.0))
    nu = np.linspace(-3.0, 3.0, 13)
    checks = [  # (what, on the card, on the CPU, bars: None = equal)
        ("calculate_minkowski",
         lambda g, f, w_: g.calculate_minkowski(f, sigma0=s0),
         (None, None, MORPH_V_BAR, MORPH_V_BAR, MORPH_V_BAR)),
        ("predicted_minkowski",
         lambda g, f, w_: g.predicted_minkowski(nu, sm), (PREDICTION_BAR,) * 4),
        ("calculate_peaks",
         lambda g, f, w_: g.calculate_peaks(f, sigma0=s0), (None,) * 3),
        ("minima_statistics",
         lambda g, f, w_: voids.minima_statistics(f, sp, sigma0=s0),
         (None,) * 3),
        ("predicted_peaks",
         lambda g, f, w_: g.predicted_peaks(smoothing_length=sm),
         (None, PREDICTION_BAR, PREDICTION_BAR)),
        ("calculate_stacked_profile",
         lambda g, f, w_: g.calculate_stacked_profile(f, w_, 16),
         (PROFILE_BAR, PROFILE_BAR, None)),
        ("calculate_peak_profile",
         lambda g, f, w_: g.calculate_peak_profile(f, 1.0, None, 16, sm),
         (PROFILE_BAR, PROFILE_BAR, None, PROFILE_BAR, PROFILE_BAR)),
        ("predicted_peak_profile",
         lambda g, f, w_: g.predicted_peak_profile(1.5, 1.0, 16, sm),
         (PROFILE_BAR, PROFILE_BAR)),
        ("find_voids",
         lambda g, f, w_: g.find_voids(f, radii, threshold=-0.1), (None,) * 2),
        ("calculate_knn_cdf",
         lambda g, f, w_: (g.calculate_knn_cdf(
             paint.deposit(pos.to(f.device), shape, sp, order=1)
             .to(torch.float32), radii),), (None,)),
        ("knn_cdf_positions",
         lambda g, f, w_: (knn.knn_cdf_positions(pos.to(f.device), shape, sp,
                                                 radii),), (None,)),
    ]
    for what, fn, bars in checks:
        reset_counts()
        got = fn(gd, d, w.to(dev))
        torch.cuda.synchronize()
        counts = read_counts()
        want = fn(gc, dc, w)
        errs_ = []
        for a, b, bar in zip(got, want, bars):
            if bar is None:
                ok, err = np.array_equal(np.asarray(a), np.asarray(b)), 0.0
            else:
                ok, err = _close(a, b, bar)
            errs_.append(err)
            if not ok:
                raise AssertionError(f"CUDA {what} disagrees with the CPU: "
                                     f"{err:.3e} (bar {bar})")
        log(f"phase 2 morphology {what} {shape}: CUDA vs CPU "
            f"{['equal' if b is None else f'{e:.2e}' for e, b in zip(errs_, bars)]}"
            f", launches { {k: n for k, n in counts.items() if n} }")
    pos_v, rv_v = gd.find_voids(d, radii, threshold=-0.1)
    log(f"phase 2 morphology find_voids {shape}: {len(rv_v)} voids, largest "
        f"{rv_v[:3].tolist()} Mpc/h")
    rv = voids.void_radius_grid(dc, sp, radii, -0.1)
    got = voids.voids_from_radius(rv.to(dev), d, sp)
    want = voids.voids_from_radius(rv, dc, sp)
    same = all(np.array_equal(a, b) for a, b in zip(got, want))
    log(f"phase 2 morphology the catalog of the CPU's R_v grid through KX: "
        f"{'equal' if same else 'DIFFERENT'} ({len(got[1])} voids)")
    if not same or len(got[1]) == 0:
        raise AssertionError("KX's catalog of one R_v grid differs")
    hd = rft.Generator(*shape, grid_spacing=sp, device=dev, power="halofit")
    hc = rft.Generator(*shape, grid_spacing=sp, device="cpu", power="halofit")
    same_table = (np.array_equal(hd.power.k, hc.power.k)
                  and np.array_equal(hd.power.Pk, hc.power.Pk))
    _, r = rel_err((hd.generate_delta_field(3).cpu(),),
                   (hc.generate_delta_field(3),))
    log(f"phase 2 power='halofit' {shape}: tables "
        f"{'equal' if same_table else 'DIFFERENT'}, render CUDA vs CPU rel "
        f"{r:.3e} (bar {SLICE_BAR:g}), predicted variance "
        f"{hd.predicted_variance():.6g} (eh98 "
        f"{rft.Generator(*shape, grid_spacing=sp, device=dev, power='eh98').predicted_variance():.6g})")
    if not (same_table and r <= SLICE_BAR):
        raise AssertionError("the halofit render disagrees")


def phase3_morphology(torch, rft, dev, g, card):
    """The JAX package's morphology gates on the card at 512^3, then the
    nine methods at 1024^3 through the public API, each with the launch
    counts set to 0 before it and read after it (none through torch.fft)
    and its peak device memory.  Returns the launch counts, summed."""
    from randomfield_tpu_torch.models import voids
    from randomfield_tpu_torch.ops import paint
    from randomfield_tpu_torch.validate import knn, peaks

    shape, sp, sm = MORPH_GATE
    g5 = rft.Generator(*shape, grid_spacing=sp, device=dev)
    s0sq, s1sq, s2sq = peaks.bbks_moments(g5.power, shape, sp, sm, device=dev)
    s0 = float(np.sqrt(s0sq))
    d = g5.generate_delta_field(1, smoothing_length=sm, apply_lightcone=False)
    nu, *meas = g5.calculate_minkowski(d, nbins=13, sigma0=s0)
    theory = g5.predicted_minkowski(nu, smoothing_length=sm)
    res = [float(np.abs(m - t).max() / np.abs(t).max())
           for m, t in zip(meas, theory)]
    log(f"phase 3 gate Minkowski v0..v3 {shape} s={sm}: max|meas - pred| / "
        f"max|pred| {[f'{r:.4f}' for r in res]} (bars {MINKOWSKI_GATE_TOLS})")
    if not all(r < t for r, t in zip(res, MINKOWSKI_GATE_TOLS)):
        raise AssertionError("the Minkowski gate failed")
    nu_p, exp_counts, exp_total = g5.predicted_peaks(smoothing_length=sm)
    # one seed: 4 Poisson sigma and the JAX gate's 12% systematic a bin;
    # the minima of delta are the peaks of -delta, their bins reflected
    budget = 4.0 * np.sqrt(np.maximum(exp_counts, 1.0)) + 0.12 * exp_counts
    for what, (nu_m, counts, total), want, bud in (
            ("peaks", g5.calculate_peaks(d, sigma0=s0), exp_counts, budget),
            ("minima", voids.minima_statistics(d, sp, sigma0=s0),
             exp_counts[::-1], budget[::-1])):
        worst = float(np.max(np.abs(counts - want) / bud))
        ok = abs(total / exp_total - 1.0) < 0.10 and worst < 1.0
        log(f"phase 3 gate {what} {shape}: total {total} (BBKS "
            f"{exp_total:.1f}, {total / exp_total - 1.0:+.4f}), worst bin at "
            f"{worst:.3f} of its budget")
        if not ok:
            raise AssertionError(f"the {what} gate failed")
    r, prof, npk, nub, xbb = g5.calculate_peak_profile(
        d, nu_min=1.0, nbins=16, smoothing_length=sm)
    _, pred = g5.predicted_peak_profile(nub, xbb, 16, sm)
    resid = float(np.abs(prof - pred).max() / s0)
    log(f"phase 3 gate peak profile {shape}: {npk} peaks nu >= 1, nu_bar "
        f"{nub:.4f}, x_bar {xbb:.4f}, max|meas - BBKS| / sigma0 {resid:.4f} "
        f"(bar 0.04)")
    if not resid < 0.04:
        raise AssertionError("the peak profile gate failed")
    # the prediction is of an unsmoothed render (the JAX gate's R and t)
    frac = voids.underdense_fraction(g5.generate_delta_field(
        2, apply_lightcone=False), sp, 8.0, -0.4)
    pfrac = voids.predicted_underdense_fraction(g5.power, shape, sp, 8.0,
                                                -0.4, device=dev)
    log(f"phase 3 gate underdense fraction {shape} R=8 t=-0.4 (unsmoothed "
        f"render): {frac:.5f} against {pfrac:.5f} (bar 0.02)")
    if not (0.05 < pfrac < 0.95 and abs(frac - pfrac) < 0.02):
        raise AssertionError("the underdense fraction gate failed")
    pos, rv = g5.find_voids(d, VOID_RADII, threshold=-0.5)
    box = shape[0] * sp
    overlap = 0
    for i in range(len(rv)):
        dv = np.abs(pos[i + 1:] - pos[i])
        dv = np.minimum(dv, box - dv)
        overlap += int((np.sqrt((dv**2).sum(axis=1)) < rv[i] - 1e-9).sum())
    log(f"phase 3 gate void catalog {shape}: {len(rv)} voids, radii sorted "
        f"{bool(np.all(np.diff(rv) <= 0))}, {overlap} centers inside a larger "
        f"void")
    if overlap or len(rv) < 3 or not np.all(np.diff(rv) <= 0):
        raise AssertionError("the void catalog gate failed")
    del d, g5
    torch.cuda.empty_cache()
    kshape, ksp, ntr, kradii, ks, ncat = KNN_GATE
    pred = knn.random_knn_cdf(ntr, kshape, ksp, kradii, ks)
    gen = torch.Generator(device=dev).manual_seed(12)
    acc = [knn.knn_cdf_positions(
        torch.rand((3, ntr), generator=gen, device=dev) * (kshape[0] * ksp),
        kshape, ksp, kradii, ks) for _ in range(ncat)]
    mean = np.mean(acc, axis=0)
    sd = np.std(acc, axis=0, ddof=1) / np.sqrt(ncat)
    worst = float((np.abs(mean - pred) / (5.0 * sd + 5e-3)).max())
    log(f"phase 3 gate kNN-CDF of {ncat} random catalogs of {ntr} at {kshape}: "
        f"worst |mean - binomial| at {worst:.3f} of its budget (5 sd + 5e-3); "
        f"CDF_1 {mean[0].round(5).tolist()} vs {pred[0].round(5).tolist()}")
    if not worst < 1.0:
        raise AssertionError("the kNN gate failed")
    knn._ball_spectrum.cache_clear()
    torch.cuda.empty_cache()

    total = dict.fromkeys(KERNEL_ORDER, 0)
    field, s0 = _morph_field(torch, g, 7)
    n_rad = len(VOID_RADII)
    peaks_gib = {}

    def run(what, fn, least):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        require_launches(counts, least, what)
        if counts["torch.fft"]:
            raise AssertionError(f"{what} went through torch.fft")
        for k in KERNEL_ORDER:
            total[k] += counts[k]
        peaks_gib[what] = peak / 2**30
        log(f"phase 3 main path {what} {HEADLINE}: launches "
            f"{ {k: n for k, n in counts.items() if n} }, torch.fft calls 0; "
            f"peak device memory {peak / 2**30:.3f} GiB "
            f"({(peak - base) / 2**30:.3f} above the {base / 2**30:.3f} held) "
            f"[{card}]")
        return out

    out = run("calculate_minkowski", lambda: g.calculate_minkowski(
        field, sigma0=s0), {"KM": 1, "K6": 1, "K3": 20, "K4": 9})
    if not (np.isfinite(np.stack(out[1:])).all()
            and abs(out[1][KM_NBINS // 2 - 1] + out[1][KM_NBINS // 2] - 1.0)
            < 0.05):
        raise AssertionError("the 1024^3 Minkowski functionals are off")
    if run("calculate_peaks", lambda: g.calculate_peaks(field, sigma0=s0),
           {"KX": 1})[2] <= 0:
        raise AssertionError("no peaks at 1024^3")
    # the stack's weight and the kNN paths' count grid, after the paths
    # that do not read them
    weight = (field > s0).to(torch.float32)
    counts_grid = paint.deposit(
        torch.rand((3, KNN_TRACERS), generator=gen, device=dev)
        * (HEADLINE[0] * HEADLINE_SPACING), HEADLINE, HEADLINE_SPACING,
        order=1).to(torch.float32)
    for what, fn, least in (
            ("predicted_minkowski", lambda: g.predicted_minkowski(
                np.linspace(-3, 3, KM_NBINS), MORPH_SMOOTHING), {}),
            ("minima_statistics", lambda: voids.minima_statistics(
                field, HEADLINE_SPACING, sigma0=s0), {"KX": 1}),
            ("predicted_peaks", lambda: g.predicted_peaks(
                smoothing_length=MORPH_SMOOTHING), {}),
            ("calculate_stacked_profile", lambda: g.calculate_stacked_profile(
                field, weight), {"K6": 2, "K3": 6, "K4": 1}),
            ("calculate_peak_profile", lambda: g.calculate_peak_profile(
                field, 1.0, None, 24, MORPH_SMOOTHING),
             {"KX": 1, "K6": 3, "K3": 10, "K4": 2}),
            ("predicted_peak_profile", lambda: g.predicted_peak_profile(
                1.5, 1.0, 24, MORPH_SMOOTHING), {"K3": 4, "K4": 2}),
            ("find_voids", lambda: g.find_voids(field, VOID_RADII,
                                                VOID_THRESHOLD),
             {"KX": 1, "K6": 1, "K3": 2 + 2 * n_rad, "K4": n_rad}),
            ("calculate_knn_cdf", lambda: g.calculate_knn_cdf(
                counts_grid, KNN_RADII),
             {"K6": 1 + len(KNN_RADII), "K4": len(KNN_RADII)})):
        run(what, fn, least)
    knn._ball_spectrum.cache_clear()
    if not peaks_gib["calculate_minkowski"] < MINKOWSKI_PEAK_GIB:
        raise AssertionError("the 1024^3 Minkowski measurement peaks at "
                             f"{peaks_gib['calculate_minkowski']:.3f} GiB")
    del field, weight, counts_grid
    torch.cuda.empty_cache()
    return total, peaks_gib


def phase4_morphology(torch, rft, dev, g, card):
    """Times at 1024^3: KM and KX (peaks, and the void mode) beside their
    plain versions, each of the nine methods (median of 5 after a warm-up)
    with the transforms' share of it.  Returns {"KM": ..., "KX": ...}."""
    from randomfield_tpu_torch.models import voids
    from randomfield_tpu_torch.ops import extrema, paint, transform
    from randomfield_tpu_torch.ops import minkowski as km
    from randomfield_tpu_torch.validate import knn
    from randomfield_tpu_torch.validate import minkowski as mk

    sp = HEADLINE_SPACING
    field, s0 = _morph_field(torch, g, 7)
    u = extrema.unit_field(field, s0)
    edges = _minkowski_edges()
    t_deriv = cuda_ms(torch, lambda: mk.derivative_fields(u, sp))
    derivs = mk.derivative_fields(u, sp)
    km_ms, km_plain, _ = time_kernel(
        torch, f"KM threshold_sums nbins={KM_NBINS}",
        lambda: km.threshold_sums(u, derivs, edges),
        lambda: km.threshold_sums_plain(u, derivs, edges), None, None,
        HEADLINE, card, plain_reps=1)
    del u, derivs
    torch.cuda.empty_cache()
    rv = voids.void_radius_grid(field, sp, VOID_RADII, VOID_THRESHOLD)
    kx_ms, kx_plain, ncand = kx_times(torch, field, s0, rv, card)
    del rv
    torch.cuda.empty_cache()
    t_fwd = cuda_ms(torch, lambda: transform.rfftn(field))
    re, im = transform.rfftn(field)
    spec = (re.clone(), im.clone())
    t_inv = cuda_ms(torch, lambda: transform.irfftn_reim(re, im, HEADLINE),
                    setup=lambda: (re.copy_(spec[0]), im.copy_(spec[1])))
    del re, im, spec
    torch.cuda.empty_cache()
    log(f"phase 4 transforms {HEADLINE}: forward (K6, K3 y, K3 x) "
        f"{t_fwd:.3f} ms, inverse (K3 x, K3 y, K4) {t_inv:.3f} ms; the nine "
        f"derivative fields of the Minkowski measurement (a forward, nine "
        f"multiplies and inverses) {t_deriv:.3f} ms [{card}]")
    weight = (field > s0).to(torch.float32)
    gen = torch.Generator(device=dev).manual_seed(13)
    counts_grid = paint.deposit(
        torch.rand((3, KNN_TRACERS), generator=gen, device=dev)
        * (HEADLINE[0] * sp), HEADLINE, sp, order=1).to(torch.float32)
    n_rad, n_knn = len(VOID_RADII), len(KNN_RADII)
    methods = (  # (what, call, the transform time inside it)
        ("calculate_minkowski", lambda: g.calculate_minkowski(
            field, sigma0=s0), t_deriv),
        ("predicted_minkowski", lambda: g.predicted_minkowski(
            np.linspace(-3, 3, KM_NBINS), MORPH_SMOOTHING), 0.0),
        ("calculate_peaks", lambda: g.calculate_peaks(field, sigma0=s0), 0.0),
        ("predicted_peaks", lambda: g.predicted_peaks(
            smoothing_length=MORPH_SMOOTHING), 0.0),
        ("calculate_stacked_profile", lambda: g.calculate_stacked_profile(
            field, weight), 2 * t_fwd + t_inv),
        ("calculate_peak_profile", lambda: g.calculate_peak_profile(
            field, 1.0, None, 24, MORPH_SMOOTHING), 3 * t_fwd + 2 * t_inv),
        ("predicted_peak_profile", lambda: g.predicted_peak_profile(
            1.5, 1.0, 24, MORPH_SMOOTHING), 2 * t_inv),
        ("find_voids", lambda: g.find_voids(field, VOID_RADII,
                                            VOID_THRESHOLD),
         t_fwd + n_rad * t_inv),
        ("calculate_knn_cdf", lambda: g.calculate_knn_cdf(
            counts_grid, KNN_RADII), t_fwd + n_knn * t_inv),
    )
    for what, fn, t_tr in methods:
        ms = cuda_ms(torch, fn)
        log(f"phase 4 {what} {HEADLINE}: {ms:.3f} ms; transforms {t_tr:.3f} "
            f"ms ({100 * t_tr / ms:.1f}%)"
            + (f"; {ncand} void candidates" if what == "find_voids" else "")
            + f" [{card}]")
    knn._ball_spectrum.cache_clear()
    del field, weight, counts_grid
    torch.cuda.empty_cache()
    return {"KM": (km_ms, km_plain, None),
            "KX": (kx_ms, kx_plain, None)}, ncand


def kx_times(torch, field, s0, rv, card):
    """KX's three modes on ``field`` beside their plain versions (the peak
    mode in turns, the others the kernel's median of 5 and the plain
    version once), and the read yardstick: torch.sum of the same field,
    one read of it as PyTorch's reduction streams it, beside the cells the
    kernel's walk loads a cell.  Returns (peak ms, its plain ms, the
    number of void candidates)."""
    from randomfield_tpu_torch.ops import extrema

    shape = tuple(field.shape)
    pedges = np.linspace(*PEAK_RANGE, PEAK_NBINS + 1)
    kx_ms, kx_plain, _ = time_kernel(
        torch, f"KX peaks nbins={PEAK_NBINS}",
        lambda: extrema.peak_counts(field, s0, pedges),
        lambda: extrema.peak_counts_plain(field, s0, pedges), None, None,
        shape, card, plain_reps=1)
    ncand = extrema.void_candidates(rv, field).size
    for what, kernel, plain in (
            ("KX peaks with the nu >= 1 mask",
             lambda: extrema.peak_counts(field, s0, pedges, 1.0, (1.0, None)),
             lambda: extrema.peak_counts_plain(field, s0, pedges, 1.0,
                                               (1.0, None))),
            (f"KX void candidates ({ncand})",
             lambda: extrema.void_candidates(rv, field),
             lambda: extrema.void_candidates_plain(rv, field))):
        k_ms = cuda_ms(torch, kernel)
        p_ms = cuda_ms(torch, plain, reps=1)
        log(f"phase 4 {what} at {shape}: kernel {k_ms:.3f} ms, plain "
            f"{p_ms:.3f} ms [{card}]")
    nbytes = 4 * field.numel()
    t_sum = cuda_ms(torch, lambda: torch.sum(field))
    factor = getattr(extrema, "read_factor", None)
    design = ("" if factor is None else
              f"; the walk loads {factor(shape):.4f} cells a cell "
              f"({factor(shape, 'voids'):.4f} in the void mode)")
    log(f"phase 4 KX read yardstick at {shape}: torch.sum of the field "
        f"{t_sum:.3f} ms ({nbytes / t_sum / 1e9:.3f} TB/s; the HBM rate "
        f"{1e3 * nbytes / HBM_BYTES_PER_S:.3f} ms){design} [{card}]")
    return kx_ms, kx_plain, ncand


def kx_times_only(torch, rft, dev, card):
    """``--kx-times``: KX's three modes at 1024^3 on phase 4's field, held
    to their plain versions and timed (:func:`kx_times`), with the package
    beside this script, to set a tree's KX against another's on one
    card."""
    from randomfield_tpu_torch.models import voids
    from randomfield_tpu_torch.ops import extrema

    if hasattr(extrema, "kernel_attributes"):
        kx_attributes(card)
    g = rft.Generator(*HEADLINE, grid_spacing=HEADLINE_SPACING, device=dev)
    field, s0 = _morph_field(torch, g, 7)
    rv = voids.void_radius_grid(field, HEADLINE_SPACING, VOID_RADII,
                                VOID_THRESHOLD)
    pedges = np.linspace(*PEAK_RANGE, PEAK_NBINS + 1)
    for sign, band in ((1.0, None), (1.0, (1.0, None)), (-1.0, None)):
        got = extrema.peak_counts(field, s0, pedges, sign, band)
        want = extrema.peak_counts_plain(field, s0, pedges, sign, band)
        if not all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(got, want)):
            raise AssertionError(f"KX sign {sign} band {band} disagrees")
    if not np.array_equal(extrema.void_candidates(rv, field),
                          extrema.void_candidates_plain(rv, field)):
        raise AssertionError("KX's void mode disagrees")
    log(f"--kx-times: KX's peaks, mask, minima and void candidates equal "
        f"to their plain versions at {HEADLINE}")
    kx_times(torch, field, s0, rv, card)


# ---- the catalog statistics: KQ (pair counts), FKP, marked and velocity ----------

# the 1024^3 pair-count paths: 2^17 objects of the Zel'dovich catalog (2^16
# for the cross catalog of phase 1), 30 linear bins to 150 Mpc/h, 10 |mu|
# wedges, the even multipoles; the box is the scene's 2048 Mpc/h
PAIR_OBJECTS = 1 << 17
PAIR_CROSS = 1 << 16
PAIR_EDGES = np.linspace(0.0, 150.0, 31)
PAIR_NMU = 10
PAIR_ELLS = (0, 2, 4)
# FKP at 1024^3: about 2^24 data objects as the per-cell Poisson counts of
# a render (their nonzero cells), 2^27 uniform randoms
FKP_DATA = 1 << 24
FKP_RANDOMS = 1 << 27
# the marked power of the 1024^3 paths (the JAX package's defaults: the
# White mark, delta_s = 0.25)
MARK_R, MARK_P = 10.0, 2.0
# CUDA vs the CPU at 128^3: the same KP sums, KQ sums and KB bins on both
# sides, spectra from two float32 FFT libraries
CATALOG_SLICE = ((128, 128, 128), 16.0)
CATALOG_SLICE_BAR = 2e-5
# the uniform-catalog gate: tests/test_paircount.py:98's 4000 objects in a
# box of 100 Mpc/h, here 2^17 in a box of 1000
PAIR_GATE = (1 << 17, 1000.0)
# operations a pair, counted from csrc/pair_counts.cu: each pair examined
# takes three minimum-image components (a subtract and the |d| <= box / 2
# test: 6), r^2 (three multiplies, two adds: 5) and the range test (2); a
# component that wraps (|d| > box / 2) adds the division, rint, multiply
# and subtract (4); a pair in range adds the edge search (5 over 30 bins),
# w w, the square root, w w r and two conversions (5 more), and two or
# three shared adds.  The bound charges the first count only to the pairs
# that a walk over neighbouring cells of side >= r_max must examine, and
# the second to their components that wrap (cell_walk_pairs), the design
# KQ's cell list follows.
KQ_OPS_PER_PAIR = 13
KQ_OPS_PER_WRAP = 4
KQ_OPS_PER_PAIR_IN_RANGE = 12


def cell_walk_pairs(torch, pos, box, r_max):
    """(ordered pairs, their components that wrap) that a cell list
    examines for pairs within ``r_max``: the box cut into nc^3 periodic
    cells of side box / nc >= r_max, each object against the objects of its
    27 neighbouring cells.  The coordinates are wrapped into [0, box] (a
    walk may wrap them first); a component wraps where the two cells lie
    on the box's opposite faces on that axis, which with nc >= 4 is exactly
    where |d| > box / 2 on the wrapped coordinates."""
    nc = int(box // r_max)
    if nc < 4:
        raise ValueError(f"cell_walk_pairs counts nc >= 4 cells an axis, "
                         f"not {nc}")
    c = (torch.remainder(pos, box) * (nc / box)).floor().long().clamp(0, nc - 1)
    flat = (c[:, 0] * nc + c[:, 1]) * nc + c[:, 2]
    counts = torch.bincount(flat, minlength=nc ** 3).view(nc, nc, nc)

    def near(axes):
        out = counts
        for a in axes:
            out = sum(torch.roll(out, o, a) for o in (-1, 0, 1))
        return out

    examined = int((counts * near((0, 1, 2))).sum())
    wrapped = 0
    for a in range(3):
        side = near([b for b in range(3) if b != a])
        wrapped += int((counts.select(a, 0) * side.select(a, nc - 1)).sum()
                       + (counts.select(a, nc - 1) * side.select(a, 0)).sum())
    return examined, wrapped


def catalog_counts():
    from randomfield_tpu_torch.ops import paircount

    return {"KQ": paircount.KQ_LAUNCHES,
            "KQ sort": paircount.KQ_SORT_LAUNCHES}


def phase0_catalogs(card):
    """KQ's registers a thread, shared memory a block and blocks an SM for
    each mode of its pair kernel (isotropic, PAIR_NMU wedges, the PAIR_ELLS
    rows) and for its sort's passes, and its plan for the 1024^3 paths'
    catalog (cells per axis, rows a work item, the items' bound)."""
    from randomfield_tpu_torch.ops import paircount as pc

    nbins = len(PAIR_EDGES) - 1
    for what, mode, nmu, n_ells in (("isotropic", 0, 1, 0),
                                    (f"{PAIR_NMU} wedges", 1, PAIR_NMU, 0),
                                    (f"ells {PAIR_ELLS}", 2, 1,
                                     len(PAIR_ELLS)),
                                    *((f"sort pass {k}", k, 1, 0)
                                      for k in pc.SORT_PASSES)):
        regs, blocks, threads, smem = pc.kernel_attributes(mode, nbins, nmu,
                                                           n_ells)
        log(f"phase 0 KQ {what}: {regs} registers a thread, {smem} bytes of "
            f"shared memory a block, {blocks} blocks an SM of {threads} "
            f"threads [{card}]")
        if regs <= 0 or blocks <= 0:
            raise AssertionError(f"KQ {what} takes no block an SM")
    box = HEADLINE[0] * HEADLINE_SPACING
    plan = pc.launch_plan(PAIR_OBJECTS, PAIR_OBJECTS, (box,) * 3,
                          float(np.float32(PAIR_EDGES[-1] ** 2)), box, nbins)
    log(f"phase 0 KQ plan for {PAIR_OBJECTS} x {PAIR_OBJECTS} objects in "
        f"[0, {box:g}), {nbins} bins to {PAIR_EDGES[-1]:g}: {plan.cells} "
        f"cells, {plan.rows} rows a work item, at most {plan.max_items} "
        f"items, {plan.copies} histograms of {plan.slots} sums a block "
        f"[{card}]")


def _pair_rows(torch, n, dev, seed, weighted=True, box3=None):
    """float32 (n, 4) rows of a uniform catalog in the 1024^3 scene's box
    (or ``box3``), with weights in [0.5, 1.5) (or 1), and objects exactly
    on integer edges (a line 5 Mpc/h apart), on the box's faces and
    coincident."""
    from randomfield_tpu_torch.ops import paircount as pc

    box3 = box3 or (HEADLINE[0] * HEADLINE_SPACING,) * 3
    box = box3[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos = torch.rand((n, 3), generator=gen, device=dev) * torch.tensor(
        box3, device=dev)
    pos[:30] = torch.tensor([100.0, 200.0, 300.0], device=dev)
    pos[:30, 1] += 5.0 * torch.arange(30, device=dev)
    pos[30:34] = torch.tensor([[0.0, 7.0, 9.0], [box, 7.0, 9.0],
                               [box / 2, 7.0, 9.0], [0.0, box / 2, 0.0]],
                              device=dev)
    pos[34:40] = pos[40:46]
    w = (torch.rand(n, generator=gen, device=dev) + 0.5 if weighted
         else torch.ones(n, device=dev))
    return pc.pack(pos, w)


def phase1_catalogs(torch, g, errs):
    """KQ against its plain version on the card at the 1024^3 paths'
    catalog sizes: 2^17 weighted objects (with objects on edges, on faces
    and coincident) auto, isotropic, PAIR_NMU wedges and the PAIR_ELLS rows
    along each axis; against a 2^16-object second catalog; the clustered
    Zel'dovich sample of phase 4 (real and redshift space) in every mode; a
    (2048, 2048, 400) box, 2 cells on z; one cell (the last edge at box /
    2); a reach of 2 Mpc/h, whose cells the cap limits.  The sums equal bit
    for bit, two calls bit-equal, and the pairs examined equal to the cell
    walk's own count (expected_pairs of the plain cell_counts), below every
    pair where the cells allow it."""
    from randomfield_tpu_torch.ops import paircount as pc

    dev = g.device
    box = (HEADLINE[0] * HEADLINE_SPACING,) * 3
    rows1 = _pair_rows(torch, PAIR_OBJECTS, dev, 21)
    rows2 = _pair_rows(torch, PAIR_CROSS, dev, 22)
    cases = [("auto isotropic", rows1, rows1, 0, 1, (), 2),
             (f"auto {PAIR_NMU} wedges", rows1, rows1, 1, PAIR_NMU, (), 2)]
    cases += [(f"auto ells {PAIR_ELLS} along axis {a}", rows1, rows1, 2, 1,
               PAIR_ELLS, a) for a in range(3)]
    cases += [("cross isotropic", rows1, rows2, 0, 1, (), 2),
              (f"cross {PAIR_NMU} wedges", rows1, rows2, 1, PAIR_NMU, (), 1),
              (f"cross ells {PAIR_ELLS}", rows1, rows2, 2, 1, PAIR_ELLS, 0)]
    cases = [(what, a, b, box, PAIR_EDGES, *rest)
             for what, a, b, *rest in cases]
    real, redshift = _zeldovich_sample(torch, g, dev)
    gen = torch.Generator(device=dev).manual_seed(23)
    zw = torch.rand(PAIR_OBJECTS, generator=gen, device=dev) + 0.5
    zreal, zred = pc.pack(real, zw), pc.pack(redshift, zw)
    del real, redshift
    cases += [("Zel'dovich isotropic", zreal, zreal, box, PAIR_EDGES, 0, 1,
               (), 2),
              (f"Zel'dovich redshift {PAIR_NMU} wedges", zred, zred, box,
               PAIR_EDGES, 1, PAIR_NMU, (), 2),
              (f"Zel'dovich redshift ells {PAIR_ELLS}", zred, zred, box,
               PAIR_EDGES, 2, 1, PAIR_ELLS, 2)]
    thin = (box[0], box[1], 400.0)
    slab = _pair_rows(torch, PAIR_CROSS, dev, 24, box3=thin)
    whole = _pair_rows(torch, PAIR_CROSS // 2, dev, 25)
    near = _pair_rows(torch, PAIR_OBJECTS, dev, 26)
    half = PAIR_OBJECTS // 2
    jitter = torch.rand((half, 3), generator=gen, device=dev) * 1.5
    near[half:, :3] = near[:half, :3] + jitter
    cases += [(f"box {thin}, 2 cells on z, {PAIR_NMU} wedges", slab, slab,
               thin, PAIR_EDGES, 1, PAIR_NMU, (), 2),
              (f"one cell (edges to {box[0] / 2:g}), ells {PAIR_ELLS}",
               whole, whole, box, np.linspace(0.0, box[0] / 2, 31), 2, 1,
               PAIR_ELLS, 0),
              ("reach 2 Mpc/h, cells capped, isotropic", near, near, box,
               np.linspace(0.0, 2.0, 11), 0, 1, (), 2)]
    for what, one, other, b3, edges, mode, nmu, ells, los in cases:
        edges2 = torch.as_tensor((edges ** 2).astype(np.float32))
        s = pc.fixed_point_exponent(one.shape[0], other.shape[0], 1.5, 1.5,
                                    edges[-1], ells)
        args = (one, other, b3, edges2, s, mode, nmu, ells, los)
        got, seen = pc.pair_sums(*args)
        again, _ = pc.pair_sums(*args)
        want, _ = pc.pair_sums_plain(*args)
        same, bit = torch.equal(got, want), torch.equal(got, again)
        plan = pc._plan_of(one, other, torch.tensor(b3, device=dev),
                           edges2.to(dev), mode, nmu, len(ells))
        walk = pc.expected_pairs(pc.cell_counts(one, plan),
                                 pc.cell_counts(other, plan), plan.cells)
        n_pairs = one.shape[0] * other.shape[0]
        log(f"phase 1 KQ {what}, {one.shape[0]} x {other.shape[0]}, cells "
            f"{plan.cells}: {int(seen)} pairs examined (the walk's "
            f"{walk}, {100 * walk / n_pairs:.3f}% of {n_pairs}), "
            f"{float(got[0].sum()) * 2.0 ** -s:.6e} weighted pairs in "
            f"range; sums {'equal to' if same else 'DIFFER from'} the plain "
            f"version, two calls {'bit-equal' if bit else 'DIFFERENT'}")
        if not (same and bit and int(seen) == walk
                and (walk < n_pairs or plan.cells == (1, 1, 1))
                and int(got[0].sum()) > 0):
            raise AssertionError(f"KQ {what} disagrees with its plain version")
        del got, again, want
    errs["KQ"] = 0.0
    torch.cuda.empty_cache()


def phase2_catalogs(torch, rft, dev):
    """Each new device function on the card against the same call on the
    CPU (their plain versions) at 128^3 and a few thousand objects, then the
    JAX package's own gates on the card: uniform catalogs give xi = 0
    within Poisson error, Poisson tracers' xi against the theory of the
    mock, the Kaiser anisotropy of redshift-space pair multipoles, FKP's
    Poisson-lognormal recovery, the linear marked power against its Wick
    prediction and the seed-direct velocity cross against its prediction."""
    from randomfield_tpu_torch.models import lognormal, zeldovich
    from randomfield_tpu_torch.ops import power as _power
    from randomfield_tpu_torch.validate import fkp, marked, paircount
    from randomfield_tpu_torch.validate import stats, velocity

    shape, sp = CATALOG_SLICE
    box = shape[0] * sp
    rng = np.random.default_rng(31)
    pos = rng.random((3000, 3)) * box
    pos2 = rng.random((2000, 3)) * box
    w = rng.random(3000) + 0.5
    edges = np.geomspace(8.0, 0.5 * box, 12)
    for what, fn in (
            ("catalog_correlation", lambda d: paircount.catalog_correlation(
                pos, box, edges, weights=w, device=d)),
            ("catalog_correlation wedges", lambda d:
             paircount.catalog_correlation(pos, box, edges, positions2=pos2,
                                           nmu=5, device=d)),
            ("catalog_correlation_multipoles", lambda d:
             paircount.catalog_correlation_multipoles(pos, box, edges,
                                                      weights=w, device=d))):
        got, want = fn(dev), fn("cpu")
        same = all(np.array_equal(a, b, equal_nan=True)
                   for a, b in zip(got, want))
        log(f"phase 2 {what} of {len(pos)} objects on the card vs the CPU: "
            f"{'equal' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"{what} on the card differs from the CPU")
    gc = rft.Generator(*shape, grid_spacing=sp, device="cpu")
    d_cpu = gc.generate_delta_field(5, apply_lightcone=False)
    v_cpu = gc.generate_velocity(5)
    d_dev, v_dev = d_cpu.to(dev), v_cpu.to(dev)
    counts = zeldovich.poisson_sample(d_cpu, 2e-3, sp, seed=6)
    lat = zeldovich.lagrangian_positions(shape, sp, device="cpu").reshape(3, -1)
    data = lat[:, counts.reshape(-1) > 0]
    dw = counts.reshape(-1)[counts.reshape(-1) > 0]
    rand = torch.as_tensor(rng.random((3, 200_000)) * box, dtype=torch.float32)
    calls = {
        "fkp_power cic": lambda d: fkp.fkp_power(
            data.to(d), rand.to(d), sp, shape, data_weights=dw.to(d),
            data_are_counts=True, nbins=16).p,
        "fkp_power_multipoles tsc interlaced": lambda d:
            np.stack(list(fkp.fkp_power_multipoles(
                data.to(d), rand.to(d), sp, shape, data_weights=dw.to(d),
                data_are_counts=True, nbins=16, window="tsc",
                interlaced=True).p.values())),
        "calculate_marked_power": lambda d: marked.calculate_marked_power(
            d_cpu.to(d), sp, nbins=16, R=MARK_R, p=MARK_P)[1],
        "predicted_linear_marked_power": lambda d:
            marked.predicted_linear_marked_power(gc.power, shape, sp, 0.6,
                                                 R=MARK_R, nbins=16,
                                                 device=d)[1],
        "density_velocity_correlation": lambda d:
            velocity.density_velocity_correlation(
                d_cpu.to(d), v_cpu.to(d), sp, nbins=16)[1],
        "pairwise_velocity": lambda d: velocity.pairwise_velocity(
            d_cpu.to(d), v_cpu.to(d), sp, nbins=16)[1],
        "predicted_pairwise_velocity": lambda d:
            velocity.predicted_pairwise_velocity(gc.power, shape, sp,
                                                 nbins=16, device=d)[1],
    }
    for what, fn in calls.items():
        ok, err = _close(fn(dev), fn("cpu"), CATALOG_SLICE_BAR)
        log(f"phase 2 {what} at {shape} on the card vs the CPU: max|d| / "
            f"max {err:.3e} (bar {CATALOG_SLICE_BAR:g})")
        if not ok:
            raise AssertionError(f"{what} on the card differs from the CPU")
    del d_dev, v_dev
    torch.cuda.empty_cache()

    # tests/test_paircount.py:98 at 32x its objects: uniform catalogs give
    # xi = 0 within 5 Poisson sigma, auto and cross
    n, ubox = PAIR_GATE
    upos = torch.rand((n, 3), device=dev) * ubox
    uedges = np.geomspace(10.0, 150.0, 9)
    _, xi, dd = paircount.catalog_correlation(upos, ubox, uedges)
    _, xi2, dd2 = paircount.catalog_correlation(
        upos, ubox, uedges, positions2=torch.rand((n // 2, 3), device=dev)
        * ubox)
    z_auto = float(np.max(np.abs(xi) / (2.0 / np.sqrt(dd))))
    z_cross = float(np.max(np.abs(xi2) * np.sqrt(dd2)))
    log(f"phase 2 gate uniform xi ({n} objects, box {ubox:g}): worst |xi| at "
        f"{z_auto:.3f} (auto) and {z_cross:.3f} (cross) Poisson sigma (bar 5)")
    if not (z_auto < 5.0 and z_cross < 5.0):
        raise AssertionError("the uniform-catalog xi gate failed")
    # :129 (marked slow there): Poisson tracers of 4 lognormal renders,
    # jittered in their cells, against the target's theory xi
    ng, gsp = 32, 4.0
    lg = lognormal.LognormalGenerator(ng, ng, ng, grid_spacing=gsp,
                                      device=dev)
    tedges = np.geomspace(6.0, 50.0, 8)
    gen = torch.Generator(device=dev).manual_seed(3)
    xis = []
    for seed in range(4):
        c = zeldovich.poisson_sample(lg.generate_delta_field(seed), 0.004,
                                     gsp, seed=seed)
        idx = torch.nonzero(c > 0).to(torch.float32)
        reps = c[c > 0].to(torch.int64)
        cells = torch.repeat_interleave(idx, reps, dim=0)
        tpos = (cells + torch.rand(cells.shape, generator=gen, device=dev)) * gsp
        r, xi_t, _ = paircount.catalog_correlation(tpos, ng * gsp, tedges)
        xis.append(xi_t)
    xi_mean = np.mean(xis, axis=0)
    xi_sd = np.std(xis, axis=0, ddof=1) / np.sqrt(len(xis))
    xi_th = np.asarray(_power.power_to_correlation(lg.power, np.asarray(r)))
    budget = 5 * xi_sd + 0.1 * np.abs(xi_th) + 0.01 * np.abs(xi_th).max()
    frac = float(np.max(np.abs(xi_mean - xi_th) / budget))
    log(f"phase 2 gate tracer xi (4 lognormal renders at {ng}^3): worst "
        f"bin at {frac:.3f} of its budget")
    if not frac < 1.0:
        raise AssertionError("the tracer xi gate failed")
    # :168: the redshift-space quadrupole below the real-space one
    gz = rft.Generator(ng, ng, ng, grid_spacing=gsp, device=dev)
    kedges = np.geomspace(10.0, 60.0, 6)
    q2r, q2z = [], []
    for seed in range(3):
        psi = gz.generate_displacement(seed)
        sel = torch.as_tensor(np.random.default_rng(seed).choice(
            ng ** 3, 3000, replace=False), device=dev)
        for f_, acc in ((0.0, q2r), (0.8, q2z)):
            p3 = zeldovich.zeldovich_positions(psi, gsp, f=f_).reshape(3, -1)
            acc.append(paircount.catalog_correlation_multipoles(
                p3[:, sel].T, ng * gsp, kedges, ells=(0, 2))[1][1])
    q2r, q2z = np.mean(q2r, axis=0), np.mean(q2z, axis=0)
    log(f"phase 2 gate Kaiser pair multipoles: mean xi_2 real "
        f"{q2r.mean():+.5f}, redshift {q2z.mean():+.5f} (redshift < real - "
        f"0.005 and < 0)")
    if not (q2z.mean() < q2r.mean() - 0.005 and q2z.mean() < 0):
        raise AssertionError("the Kaiser pair-multipole gate failed")
    # tests/test_fkp.py:147: FKP of Poisson counts against dense Poisson
    # randoms tracks catalog_power of the same counts; its box at 32^3 (the
    # card's kernels take nz / 2 >= 16)
    fs, fsp = (32, 32, 32), 4.0
    lgf = lognormal.LognormalGenerator(*fs, grid_spacing=fsp, device=dev)
    fc = zeldovich.poisson_sample(lgf.generate_delta_field(11), 2e-3, fsp,
                                  seed=12).reshape(-1)
    rc = zeldovich.poisson_sample(torch.zeros(fs, device=dev), 2e-2, fsp,
                                  seed=13).reshape(-1)
    flat = zeldovich.lagrangian_positions(fs, fsp, device=dev).reshape(3, -1)
    res = fkp.fkp_power(flat, flat, fsp, fs, data_weights=fc,
                        randoms_weights=rc, data_are_counts=True,
                        randoms_are_counts=True)
    _, p_c, _ = zeldovich.catalog_power(flat, fsp, shape=fs, weights=fc)
    good = (res.n_modes > 8) & np.isfinite(p_c) & (res.k < np.pi / fsp)
    rel = np.abs(res.p[good] - p_c[good]) / np.abs(
        np.where(np.abs(p_c) > 0, p_c, 1.0)[good])
    volume = float(np.prod(fs)) * fsp ** 3
    log(f"phase 2 gate FKP Poisson-lognormal: median |P_fkp - P_cat| / "
        f"|P_cat| {float(np.median(rel)):.4f} (bar 0.25), shot "
        f"{res.shot_noise:.2f} > V / N {volume / float(fc.sum()):.2f}")
    if not (np.median(rel) < 0.25
            and res.shot_noise > volume / float(fc.sum())):
        raise AssertionError("the FKP Poisson-lognormal gate failed")
    # tests/test_marked.py:69: 8 linear-marked renders against the Wick
    # prediction, and the eps^2 term visible
    gm = rft.Generator(ng, ng, ng, grid_spacing=gsp, device=dev)
    eps, mR = 0.6, 8.0
    _, p_pred, cnt = marked.predicted_linear_marked_power(
        gm.power, gm.shape, gsp, eps, R=mR, nbins=10, device=dev)
    _, p_plain, _ = marked.predicted_linear_marked_power(
        gm.power, gm.shape, gsp, 0.0, R=mR, nbins=10, device=dev)
    acc = [stats.calculate_power(marked.linear_marked_field(
        gm.generate_delta_field(s, apply_lightcone=False), gsp, eps, R=mR),
        gsp, nbins=10)[1] for s in range(8)]
    m = cnt > 0
    resid = np.abs(np.mean(acc, axis=0) - p_pred)[m]
    budget = (5.0 * np.std(acc, axis=0, ddof=1)[m] / np.sqrt(8)
              + 1e-4 * np.nanmax(np.abs(p_pred)))
    shift = float((np.abs(p_pred - p_plain) / np.abs(p_plain))[m].max())
    log(f"phase 2 gate linear marked power (8 renders at {ng}^3): worst bin "
        f"at {float((resid / budget).max()):.3f} of its budget, the eps^2 "
        f"term moves it {shift:.3f} (bar 0.05)")
    if not ((resid < budget).all() and shift > 0.05):
        raise AssertionError("the marked-power Wick gate failed")
    # tests/test_velocity.py:40 (marked slow there): psi_r of 60 seeds
    # against its exact expectation, and infall; 32^3 at 6 Mpc/h, the box
    # of its 24^3 at 8 (the card's kernels take powers of two)
    vs, vsp = (32, 32, 32), 6.0
    gv = rft.Generator(*vs, grid_spacing=vsp, power="eh98", device=dev)
    psis = []
    for seed in range(60):
        _, psi, vcounts = velocity.density_velocity_correlation(
            gv.generate_delta_field(seed, apply_lightcone=False),
            gv.generate_velocity(seed), vsp, nbins=10)
        psis.append(psi)
    psis = np.asarray(psis)
    _, psi_pred, _ = velocity.predicted_density_velocity_correlation(
        gv.power, vs, vsp, gv.cosmology, nbins=10, device=dev)
    good = vcounts > 0
    resid = np.abs(psis.mean(axis=0) - psi_pred)[good]
    allow = (5.0 * psis.std(axis=0, ddof=1)[good] / np.sqrt(len(psis))
             + 1e-3 * np.max(np.abs(psi_pred[good])))
    log(f"phase 2 gate seed-direct velocity cross (60 renders at {vs}): "
        f"worst bin at {float((resid / allow).max()):.3f} of its allowance, "
        f"innermost psi_r {psi_pred[good][0]:.3f} (predicted) and "
        f"{psis.mean(axis=0)[good][0]:.3f} km/s")
    if not ((resid < allow).all() and psi_pred[good][0] < 0
            and psis.mean(axis=0)[good][0] < 0):
        raise AssertionError("the seed-direct velocity gate failed")
    torch.cuda.empty_cache()


def _fkp_catalogs(torch, g, dev):
    """The 1024^3 FKP paths' catalogs: the cells with Poisson counts of a
    render at nbar = FKP_DATA / V (their centres and counts), and
    FKP_RANDOMS uniform randoms."""
    from randomfield_tpu_torch.models import zeldovich

    n = HEADLINE[0]
    box = n * HEADLINE_SPACING
    counts = zeldovich.poisson_sample(
        g.generate_delta_field(8, apply_lightcone=False), FKP_DATA / box ** 3,
        HEADLINE_SPACING, seed=9).reshape(-1)
    cells = torch.nonzero(counts > 0).reshape(-1)
    weights = counts[cells]
    del counts
    idx = torch.stack([cells // (n * n), (cells // n) % n, cells % n])
    data = (idx.to(torch.float32) + 0.5) * HEADLINE_SPACING
    gen = torch.Generator(device=dev).manual_seed(10)
    randoms = torch.rand((3, FKP_RANDOMS), generator=gen, device=dev) * box
    return data, weights, randoms


def _zeldovich_sample(torch, g, dev):
    """(real-space, redshift-space) (PAIR_OBJECTS, 3) positions: a uniform
    subsample (with replacement) of the 1024^3 Zel'dovich catalog of seed
    2, f the scene's growth rate."""
    from randomfield_tpu_torch.models import zeldovich

    sp = HEADLINE_SPACING
    psi = g.generate_displacement(2)
    gen = torch.Generator(device=dev).manual_seed(12)
    sel = torch.randint(0, psi[0].numel(), (PAIR_OBJECTS,), generator=gen,
                        device=dev)
    out = []
    for f_ in (0.0, float(g.cosmology.growth_rate(0.0))):
        pos = zeldovich.zeldovich_positions(psi, sp, f=f_).reshape(3, -1)
        out.append(pos[:, sel].T.contiguous())
        del pos
    del psi
    torch.cuda.empty_cache()
    return out


def phase3_catalogs(torch, rft, dev, g, card):
    """The slice's main paths through the public API, each with the launch
    counts set to 0 before it and read after it (none through torch.fft)
    and its peak device memory: catalog_correlation and its multipoles of
    2^17 Zel'dovich objects (the multipoles in redshift space),
    fkp_power (CIC and TSC) and its multipoles at 1024^3,
    calculate_marked_power at 1024^3, density_velocity_correlation and
    pairwise_velocity at 1024^3.  Returns the launch counts, summed, and
    the peaks."""
    from randomfield_tpu_torch.validate import fkp, marked, paircount
    from randomfield_tpu_torch.validate import velocity

    total = dict.fromkeys(KERNEL_ORDER, 0)
    peaks = {}
    sp = HEADLINE_SPACING
    box = HEADLINE[0] * sp
    real, redshift = _zeldovich_sample(torch, g, dev)
    (r, xi, dd), peaks["catalog_correlation"] = _path(
        torch, f"catalog_correlation ({PAIR_OBJECTS} Zel'dovich objects)",
        lambda: paircount.catalog_correlation(real, box, PAIR_EDGES),
        {"KQ": 1, "KQ sort": 1}, total)
    log(f"phase 3 catalog_correlation: xi at r = {np.round(r[:4], 2)} "
        f"{np.round(xi[:4], 4)}; {float(dd.sum()):.0f} pairs in range")
    if not (np.isfinite(xi[1:]).all() and xi[1] > 0):
        raise AssertionError("the 1024^3 catalog xi is off")
    (r, xl, dd), peaks["catalog_correlation_multipoles"] = _path(
        torch, f"catalog_correlation_multipoles ({PAIR_OBJECTS} "
        f"redshift-space objects, ells {PAIR_ELLS})",
        lambda: paircount.catalog_correlation_multipoles(
            redshift, box, PAIR_EDGES, ells=PAIR_ELLS),
        {"KQ": 1, "KQ sort": 1}, total)
    log(f"phase 3 catalog_correlation_multipoles: xi_0, xi_2 at r = "
        f"{np.round(r[2:6], 2)}: {np.round(xl[0][2:6], 4)}, "
        f"{np.round(xl[1][2:6], 4)}")
    if not np.isfinite(xl[:, 1:]).all():
        raise AssertionError("the 1024^3 catalog multipoles are not finite")
    del real, redshift
    data, dw, randoms = _fkp_catalogs(torch, g, dev)
    log(f"phase 3 FKP catalogs: {data.shape[1]} data cells holding "
        f"{int(dw.sum())} objects, {randoms.shape[1]} randoms")
    for window in ("cic", "tsc"):
        res, peaks[f"fkp_power {window}"] = _path(
            torch, f"fkp_power ({window})", lambda: fkp.fkp_power(
                data, randoms, sp, HEADLINE, data_weights=dw,
                data_are_counts=True, window=window, nbins=NBINS),
            {"KP": 2, "K6": 1, "K3": 2, "KB": 1}, total)
        log(f"phase 3 fkp_power {window}: alpha {res.alpha:.6f}, I22 "
            f"{res.i22:.6e}, shot {res.shot_noise:.3f}, P at the lowest "
            f"k {np.round(res.p[:4], 1)}")
        live = res.n_modes > 0
        if not (np.isfinite(res.p[live]).all() and res.p[live][0] > 0):
            raise AssertionError(f"the 1024^3 FKP spectrum ({window}) is off")
    res, peaks["fkp_power_multipoles"] = _path(
        torch, "fkp_power_multipoles (cic)", lambda: fkp.fkp_power_multipoles(
            data, randoms, sp, HEADLINE, data_weights=dw,
            data_are_counts=True, nbins=NBINS),
        {"KP": 2, "K6": 1, "K3": 2, "KB": 1}, total)
    if not all(np.isfinite(v[res.n_modes > 0]).all()
               for v in res.p.values()):
        raise AssertionError("the 1024^3 FKP multipoles are not finite")
    del data, dw, randoms
    torch.cuda.empty_cache()
    field = g.generate_delta_field(7, apply_lightcone=False)
    (k, pm, n), peaks["calculate_marked_power"] = _path(
        torch, f"calculate_marked_power (R = {MARK_R}, p = {MARK_P})",
        lambda: marked.calculate_marked_power(field, sp, nbins=NBINS,
                                              R=MARK_R, p=MARK_P),
        {"K6": 2, "K3": 6, "K4": 1, "KB": 1}, total)
    if not (np.isfinite(pm[n > 0]).all() and (pm[n > 0] > 0).all()):
        raise AssertionError("the 1024^3 marked power is off")
    vel = g.generate_velocity(7)
    (r, psi, c), peaks["density_velocity_correlation"] = _path(
        torch, "density_velocity_correlation",
        lambda: velocity.density_velocity_correlation(field, vel, sp),
        {"K6": 4, "K3": 14, "K4": 3}, total)
    (r, v12, c), peaks["pairwise_velocity"] = _path(
        torch, "pairwise_velocity",
        lambda: velocity.pairwise_velocity(field, vel, sp),
        {"K6": 5, "K3": 18, "K4": 4}, total)
    log(f"phase 3 velocity: psi_r at r = {np.round(r[:4], 1)} "
        f"{np.round(psi[:4], 3)} km/s, v12 {np.round(v12[:4], 3)} km/s")
    live = c > 0
    if not (np.isfinite(psi[live]).all() and np.isfinite(v12[live]).all()
            and psi[live][0] < 0 and v12[live][0] < 0):
        raise AssertionError("the 1024^3 velocity statistics are off")
    del field, vel
    torch.cuda.empty_cache()
    return total, peaks


def kq_times(torch, g, dev, card):
    """KQ at 1024^3 (CUDA events, median of 5 after a warm-up) on the 2^17
    Zel'dovich sample: beside its plain version (in turns), in its other
    modes, its plan, its stages and catalog_correlation(_multipoles).
    Returns (ms, plain ms, the pairs in range of the timed launch, the
    pairs a cell list would examine for it and their components that wrap
    (cell_walk_pairs))."""
    from randomfield_tpu_torch.ops import _build, paircount as pc
    from randomfield_tpu_torch.validate import paircount

    box = HEADLINE[0] * HEADLINE_SPACING
    real, redshift = _zeldovich_sample(torch, g, dev)
    ones = torch.ones(PAIR_OBJECTS, device=dev)
    rows = pc.pack(real, ones)
    edges2 = torch.as_tensor((PAIR_EDGES ** 2).astype(np.float32))
    nbins = len(PAIR_EDGES) - 1
    s = pc.fixed_point_exponent(PAIR_OBJECTS, PAIR_OBJECTS, 1.0, 1.0,
                                PAIR_EDGES[-1])
    b3 = (box,) * 3
    kq_ms, kq_plain, _ = time_kernel(
        torch, f"KQ pair_sums isotropic {PAIR_OBJECTS} auto, {nbins} bins",
        lambda: pc.pair_sums(rows, rows, b3, edges2, s),
        lambda: pc.pair_sums_plain(rows, rows, b3, edges2, s), None, None,
        (PAIR_OBJECTS, 4), card, plain_reps=1)
    in_range = int(pc.pair_sums(rows, rows, b3, edges2, s)[0][0].sum()) >> s
    examined, wrapped = cell_walk_pairs(torch, real, box, PAIR_EDGES[-1])
    # the cell list's plan on this catalog and KQ's stages alone
    seen = int(pc.pair_sums(rows, rows, b3, edges2, s)[1])
    lib, stream = _build.library(), _build.current_stream(rows)
    box_t, edges_t = torch.tensor(b3, device=dev), edges2.to(dev)
    plan = pc._plan_of(rows, rows, box_t, edges_t, 0, 1, 0)
    counts = pc.cell_counts(rows, plan)
    items = int(pc.item_ends(counts, plan.rows)[-1])
    log(f"phase 4 KQ plan on the Zel'dovich sample: {plan.cells} cells, "
        f"{PAIR_OBJECTS / counts.numel():.1f} objects a cell on average, "
        f"{int(counts.max())} at most, {int((counts == 0).sum())} empty; "
        f"{items} work items of at most {plan.rows} rows (bound "
        f"{plan.max_items}); {seen} pairs examined by the kernel, "
        f"{examined} by cell_walk_pairs (the bound's count), {wrapped} of "
        f"their components wrap [{card}]")
    t_plan = cuda_ms(torch, lambda: pc._plan_of(rows, rows, box_t, edges_t,
                                                0, 1, 0))
    t_sort = cuda_ms(torch, lambda: pc._sort(rows, plan, lib, stream))
    one = pc._sort(rows, plan, lib, stream)
    scratch = torch.zeros(plan.slots + 2, dtype=torch.int64, device=dev)
    t_pairs = cuda_ms(torch, lambda: pc._pairs(
        one, one, plan, edges_t, s, 0, 1, (), 2, scratch, lib, stream),
        setup=scratch.zero_)
    t_check = cuda_ms(torch, lambda: (pc._expected(
        one[2], one[2], plan.cells) - scratch[plan.slots]).item())
    log(f"phase 4 KQ stages (isotropic): the plan's host read {t_plan:.3f} "
        f"ms, the sort (count pass, cumsum, scatter pass) {t_sort:.3f}, the "
        f"item cells and the pair kernel {t_pairs:.3f}, the check "
        f"(expected_pairs of the sort's counts and the read) {t_check:.3f}; "
        f"pair_sums {kq_ms:.3f} [{card}]")
    del one, scratch, counts
    zrows = pc.pack(redshift, ones)
    for what, mode, nmu, ells in ((f"{PAIR_NMU} wedges", 1, PAIR_NMU, ()),
                                  (f"ells {PAIR_ELLS}", 2, 1, PAIR_ELLS)):
        se = pc.fixed_point_exponent(PAIR_OBJECTS, PAIR_OBJECTS, 1.0, 1.0,
                                     PAIR_EDGES[-1], ells)
        ms = cuda_ms(torch, lambda: pc.pair_sums(zrows, zrows, b3, edges2, se,
                                                 mode, nmu, ells))
        log(f"phase 4 KQ {what} on the redshift-space sample: {ms:.3f} ms "
            f"[{card}]")
    t_corr = cuda_ms(torch, lambda: paircount.catalog_correlation(
        real, box, PAIR_EDGES))
    t_poles = cuda_ms(torch, lambda: paircount.catalog_correlation_multipoles(
        redshift, box, PAIR_EDGES, ells=PAIR_ELLS))
    log(f"phase 4 catalog_correlation of {PAIR_OBJECTS}: {t_corr:.3f} ms (KQ "
        f"{kq_ms:.3f}, {100 * kq_ms / t_corr:.1f}%); the multipoles "
        f"{t_poles:.3f} ms; {in_range} pairs in range of {PAIR_OBJECTS ** 2}, "
        f"{seen} ({100 * seen / PAIR_OBJECTS ** 2:.3f}%) examined by KQ, "
        f"{examined} ({100 * examined / PAIR_OBJECTS ** 2:.3f}%) in the 27 "
        f"neighbouring cells of side >= {PAIR_EDGES[-1]:g} [{card}]")
    del real, redshift, rows, zrows
    torch.cuda.empty_cache()
    return kq_ms, kq_plain, in_range, (examined, wrapped)


def kq_times_only(torch, rft, dev, card):
    """``--kq-times``: KQ alone, with the package beside this script, to
    set a tree's KQ against another's on one card: its attributes and plan
    (:func:`phase0_catalogs`), its checks against its plain version
    (:func:`phase1_catalogs`) and its times (:func:`kq_times`)."""
    phase0_catalogs(card)
    g = rft.Generator(*HEADLINE, grid_spacing=HEADLINE_SPACING, device=dev)
    phase1_catalogs(torch, g, {})
    kq_times(torch, g, dev, card)


def phase4_catalogs(torch, rft, dev, g, card):
    """Times at 1024^3 (CUDA events, median of 5 after a warm-up): KQ
    (:func:`kq_times`); each path of phase 3 and its stages (painting,
    transforms, binning, KQ).  Returns ({"KQ": (ms, plain ms, None)}, the
    pairs in range of the timed launch, the pairs a cell list would examine
    for it and their components that wrap)."""
    from randomfield_tpu_torch.ops import paint
    from randomfield_tpu_torch.ops import transform
    from randomfield_tpu_torch.validate import fkp, fourier, marked
    from randomfield_tpu_torch.validate import velocity

    sp = HEADLINE_SPACING
    kq_ms, kq_plain, in_range, examined = kq_times(torch, g, dev, card)

    data, dw, randoms = _fkp_catalogs(torch, g, dev)
    w_d = dw.to(torch.float32)
    s_d = paint.fixed_point_exponent(float(dw.sum()))
    s_r = paint.fixed_point_exponent(float(randoms.shape[1]))
    def prepare():
        return fkp._prepare(data, randoms, sp, HEADLINE, dw, 1.0, None, None,
                            0.0, dev, data_are_counts=True)

    cats = prepare()
    f = fkp._painted_field(cats, sp, HEADLINE, paint.ORDERS["cic"])
    t_prep = cuda_ms(torch, prepare)
    for window in ("cic", "tsc"):
        order = paint.ORDERS[window]
        t_all = cuda_ms(torch, lambda: fkp.fkp_power(
            data, randoms, sp, HEADLINE, data_weights=dw,
            data_are_counts=True, window=window, nbins=NBINS))
        t_paint_d = cuda_ms(torch, lambda: paint.deposit(
            data, HEADLINE, sp, w_d, order, 0.0, s_d))
        t_paint_r = cuda_ms(torch, lambda: paint.deposit(
            randoms, HEADLINE, sp, 1.0, order, 0.0, s_r))
        t_field = cuda_ms(torch, lambda: fkp._painted_field(
            cats, sp, HEADLINE, order))
        t_fwd = cuda_ms(torch, lambda: transform.rfftn(f))
        t_power = cuda_ms(torch, lambda: fourier.calculate_power(
            f, sp, nbins=NBINS, window=window))
        log(f"phase 4 fkp_power {window} {HEADLINE}: {t_all:.3f} ms; the "
            f"weights' sums {t_prep:.3f}, the field {t_field:.3f} (painting "
            f"data {t_paint_d:.3f} + randoms {t_paint_r:.3f}, the rest the "
            f"float64 difference), calculate_power {t_power:.3f} (transform "
            f"{t_fwd:.3f}, binning {t_power - t_fwd:.3f}) [{card}]")
    t_inter = cuda_ms(torch, lambda: fkp.fkp_power(
        data, randoms, sp, HEADLINE, data_weights=dw, data_are_counts=True,
        interlaced=True, nbins=NBINS))
    log(f"phase 4 fkp_power cic interlaced {HEADLINE}: {t_inter:.3f} ms "
        f"[{card}]")
    t_poles = cuda_ms(torch, lambda: fkp.fkp_power_multipoles(
        data, randoms, sp, HEADLINE, data_weights=dw, data_are_counts=True,
        nbins=NBINS))
    log(f"phase 4 fkp_power_multipoles cic {HEADLINE}: {t_poles:.3f} ms "
        f"[{card}]")
    del data, dw, w_d, randoms, f, cats
    torch.cuda.empty_cache()

    field = g.generate_delta_field(7, apply_lightcone=False)
    t_all = cuda_ms(torch, lambda: marked.calculate_marked_power(
        field, sp, nbins=NBINS, R=MARK_R, p=MARK_P))
    t_smooth = cuda_ms(torch, lambda: marked.smooth_field(field, sp, MARK_R))
    t_fwd = cuda_ms(torch, lambda: transform.rfftn(field))
    re, im = transform.rfftn(field)
    spec = (re.clone(), im.clone())
    t_inv = cuda_ms(torch, lambda: transform.irfftn_reim(re, im, HEADLINE),
                    setup=lambda: (re.copy_(spec[0]), im.copy_(spec[1])))
    del re, im, spec
    t_power = cuda_ms(torch, lambda: fourier.calculate_power(field, sp,
                                                             nbins=NBINS))
    log(f"phase 4 calculate_marked_power {HEADLINE}: {t_all:.3f} ms; "
        f"smoothing {t_smooth:.3f} (forward {t_fwd:.3f}, inverse {t_inv:.3f}, "
        f"the window multiply the rest), the mark "
        f"{t_all - t_smooth - t_power:.3f}, calculate_power {t_power:.3f} "
        f"(binning {t_power - t_fwd:.3f}) [{card}]")
    vel = g.generate_velocity(7)
    t_psi = cuda_ms(torch, lambda: velocity.density_velocity_correlation(
        field, vel, sp))
    t_v12 = cuda_ms(torch, lambda: velocity.pairwise_velocity(field, vel, sp))
    t_tr = 4 * t_fwd + 3 * t_inv
    log(f"phase 4 density_velocity_correlation {HEADLINE}: {t_psi:.3f} ms; "
        f"transforms (4 forward, 3 inverse) {t_tr:.3f} "
        f"({100 * t_tr / t_psi:.1f}%), the cross products, projection and r "
        f"binning the rest; pairwise_velocity {t_v12:.3f} ms [{card}]")
    del field, vel
    torch.cuda.empty_cache()
    return {"KQ": (kq_ms, kq_plain, None)}, in_range, examined


# ---- the device models: halos and HOD (KH), SPT, lensing, forecasts,
# multi-tracer fields, reconstruction -------------------------------------

HALO_BINS = 4
MODELS_SEED = 5
# phase 2: each model's CUDA output against its CPU output
MODEL_SLICE = ((64, 64, 64), 16.0)
MODEL_SLICE_BAR = 1e-5
# the tree bispectrum on the card against the CPU at MODEL_SLICE, relative
# a triple: the sound tree reads 4.3e-4 (a triple of few closed triads,
# whose float32 sums cancel; 3.5e-7 on every triple of 1e6 triads or more)
# and the tree without the Hermitian projection of its syntheses 8.8e-3
# (scripts/tree_bispectrum_residual.py)
TREE_TRIPLE_BAR = 2e-3
# KH's key tables held to the default one: the threads derive every
# subkey past the first KH_SHORT_TABLES[i] of each chain
KH_SHORT_TABLES = (0, 3)
# the lambda >= 10 grid of phase 1 (the linear form; the rejection passes)
KH_REJECTION = ((256, 256, 256), 20.0)
# phase 3's statistical gates
HALO_GATE = ((256, 256, 256), 4.0, 4)
GALAXY_GATE = ((256, 256, 256), 4.0, 3)
LENSING_GATE = ((512, 512, 512), 4.0, (0.2, 0.4, 0.7))
RECON_GATE = ((256, 256, 256), 5.0)
# phase 4: the tree bispectrum's bins, the forecasting grid
TREE_NBINS = 8
FISHER_SHAPE = (256, 256, 256)
# KH's operations (counted from csrc/poisson.cu), each fused multiply-add
# of XLA's float32 function one float32 operation (one FFMA; the kernel's
# float64 emulation of it is its own cost, not the function's): a (cell,
# bin) forms lambda (the exponent's multiply-add and the exp: 14 float32
# and integer operations and 8 multiply-adds) and a Knuth iteration hashes
# its counter (74, as OPS_PER_MODE counts Threefry), makes the uniform (2),
# takes XLA's log (13 and 10 multiply-adds) and adds (1)
KH_OPS_PER_CELL_BIN = 14 + 8
KH_OPS_PER_ITERATION = 74 + 2 + 13 + 10 + 1
# a rejection step (two hashes and uniforms, k's float32 arithmetic with
# its multiply-add and the acceptance tests; the log and lgamma only where
# those do not decide), counted once a cell of each bin whose intensity
# reaches 10 (the first pass) and once a cell at or above 10 (the replay):
# the least this data needs
KH_OPS_PER_REJECTION_STEP = 2 * 76 + 12 + 1


def models_counts():
    from randomfield_tpu_torch.ops import poisson

    return {"KH": poisson.KH_LAUNCHES}


def phase0_models(card):
    """KH's registers a thread and blocks an SM, each of its three passes."""
    from randomfield_tpu_torch.ops import poisson

    for mode, what in enumerate(("Knuth", "first acceptance", "replay")):
        regs, blocks, threads = poisson.kernel_attributes(mode)
        log(f"phase 0 KH {what} pass: {regs} registers a thread, {blocks} "
            f"blocks an SM of {threads} threads [{card}]")
        if regs <= 0 or blocks <= 0:
            raise AssertionError(f"KH {what} takes no block an SM")


def _halo_keys(hg, seed):
    from randomfield_tpu_torch.models import halos

    return halos.halo_keys(seed, hg.nbar.size)


def _halo_args(hg):
    return dict(form="lognormal", lam0=hg.nbar * hg._cell_volume,
                bias=hg.bias, sigma_g2=hg.lognormal.sigma_g2)


def _kh_check(torch, errs, what, g, keys, kw, plain_chunk=1 << 26):
    """KH against its plain version on the card on the same field, bit for
    bit, with the default key table and with each of KH_SHORT_TABLES; the
    first differing cells are logged with both counts and the intensity.
    Returns (kernel counts, plain ms)."""
    from randomfield_tpu_torch.ops import poisson

    got = poisson.poisson_counts(g, keys, **kw)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = torch.empty_like(got)
    for b, key in enumerate(keys):
        lam = poisson.intensity(g, kw["form"], b, kw.get("lam0"),
                                kw.get("bias"), kw.get("sigma_g2", 0.0),
                                kw.get("scale", 1.0))
        want[b] = poisson.poisson_plain(key, lam, chunk=plain_chunk)
        del lam
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    diff = torch.nonzero(got != want)
    for b, *cell in diff[:20].tolist():
        lam = poisson.intensity(g[tuple(cell)].reshape(1).cpu(), kw["form"],
                                b, kw.get("lam0"), kw.get("bias"),
                                kw.get("sigma_g2", 0.0), kw.get("scale", 1.0))
        log(f"phase 1 KH {what}: cell {(b, *cell)} kernel "
            f"{int(got[(b, *cell)])}, plain {int(want[(b, *cell)])}, lambda "
            f"{float(lam):.9g}")
    errs["KH"] = max(errs.get("KH", 0.0), float(
        (got - want).abs().max()) if len(diff) else 0.0)
    log(f"phase 1 KH {what}: {len(diff)} of {got.numel()} counts differ "
        f"from the plain version (bit-equal required); {int(got.sum())} "
        f"counts in all; plain {plain_ms:.1f} ms")
    if len(diff):
        raise AssertionError(f"KH {what} disagrees with its plain version")
    short = torch.empty_like(want)
    for table in KH_SHORT_TABLES:
        poisson.poisson_counts(g, keys, out=short, table=table, **kw)
        ndiff = sum(int(torch.count_nonzero(s != w))
                    for s, w in zip(short, want))
        log(f"phase 1 KH {what}, key table {table}: {ndiff} counts differ "
            f"from the plain version (bit-equal required)")
        if ndiff:
            raise AssertionError(f"KH {what} with a key table of {table} "
                                 f"disagrees with its plain version")
    del short
    return got, plain_ms


def phase1_models(torch, hg, errs):
    """KH against its plain version on the card: the halo counts of the
    1024^3 main path (HALO_BINS mass bins on one Gaussian render) and a
    lambda >= 10 grid through the linear form (the rejection passes); KD's
    'deriv' and 'recon' kinds on the 1024^3 lattices, bit for bit.
    Returns the plain version's ms on the halo counts."""
    from randomfield_tpu_torch.ops import derived, threefry

    dev = hg.device
    g = hg.lognormal.gaussian.generate_delta_field(
        MODELS_SEED, apply_lightcone=False)
    counts, plain_ms = _kh_check(torch, errs, f"halo counts {HEADLINE}, "
                                 f"{HALO_BINS} bins", g,
                                 _halo_keys(hg, MODELS_SEED), _halo_args(hg))
    log(f"phase 1 KH halo counts per bin {counts.sum((1, 2, 3)).tolist()}, "
        f"expected {np.round(hg.expected_counts(), 1).tolist()}")
    del g, counts
    torch.cuda.empty_cache()
    shape, scale = KH_REJECTION
    gen = torch.Generator(device=dev).manual_seed(3)
    delta = 0.6 * torch.randn(shape, generator=gen, device=dev)
    got, _ = _kh_check(torch, errs, f"linear form {shape}, lambda = "
                       f"{scale:g} (1 + delta)", delta,
                       [threefry.key_from_seed(9 ^ 0x5EEDC0DE)],
                       dict(form="linear", scale=scale))
    log(f"phase 1 KH linear form: {int((got >= 10).sum())} counts >= 10 of "
        f"{got.numel()}")
    del delta, got
    torch.cuda.empty_cache()
    nzh = HEADLINE[2] // 2 + 1
    re = torch.randn((HEADLINE[0], HEADLINE[1], nzh), generator=gen,
                     device=dev)
    im = torch.randn_like(re)
    for kind, comp, pref, los in (("deriv", 0, 1e-9, 2),
                                  ("recon", 2, (1e-9, 1.5, 0.7, 10.0), 1)):
        a = derived.apply_kernel(re.clone(), im.clone(), HEADLINE,
                                 HEADLINE_SPACING, kind, comp, pref,
                                 los_axis=los)
        b = derived.apply_kernel_plain(re.clone(), im.clone(), HEADLINE,
                                       HEADLINE_SPACING, kind, comp, pref,
                                       los_axis=los)
        check_bit_equal(torch, errs, "KD", f"{kind} {comp}", a, b)
        del a, b
    del re, im
    torch.cuda.empty_cache()
    return plain_ms


def _close_to(what, got, want, bar):
    got = got.cpu().numpy() if hasattr(got, "cpu") else np.asarray(got)
    want = want.cpu().numpy() if hasattr(want, "cpu") else np.asarray(want)
    r = float(np.nanmax(np.abs(got.astype(np.float64) - want))
              / np.nanmax(np.abs(want)))
    log(f"phase 2 models {what} on the card vs the CPU: rel {r:.3e} (bar "
        f"{bar:g})")
    if not r <= bar:
        raise AssertionError(f"{what} on the card disagrees with the CPU")


def phase2_models(torch, rft, dev):
    """Each model on the card against the CPU at MODEL_SLICE: the halo
    counts (KH on the CPU's Gaussian render equal to the CPU counts bit
    for bit; end to end, each differing cell a tie of the two renders'
    intensities), the galaxy catalog, poisson_sample, second_order_density,
    the tree bispectrum, lensing, the multi-tracer pair, reconstruction
    and the Fisher matrix."""
    from randomfield_tpu_torch.models import (fisher, halos, hod, lensing,
                                              multitracer, reconstruction,
                                              spt, zeldovich)
    from randomfield_tpu_torch.ops import poisson

    shape, sp = MODEL_SLICE
    seed = MODELS_SEED
    hg = {d: halos.HaloGenerator(*shape, sp, device=d, mmin=1e12)
          for d in (dev, "cpu")}
    keys = _halo_keys(hg["cpu"], seed)
    g_cpu = hg["cpu"].lognormal.gaussian.generate_delta_field(
        seed, apply_lightcone=False)
    c_cpu = hg["cpu"].generate_halo_counts(seed)
    same_g = poisson.poisson_counts(g_cpu.to(dev), keys,
                                    **_halo_args(hg["cpu"])).cpu()
    log(f"phase 2 models KH on the CPU render: "
        f"{int((same_g != c_cpu).sum())} of {c_cpu.numel()} counts differ "
        f"(bit-equal required)")
    if not torch.equal(same_g, c_cpu):
        raise AssertionError("KH on the CPU render differs from the CPU")
    c_dev = hg[dev].generate_halo_counts(seed).cpu()
    g_card = hg[dev].lognormal.gaussian.generate_delta_field(
        seed, apply_lightcone=False).cpu()
    diff = torch.nonzero(c_dev != c_cpu)
    for b, *cell in diff.tolist():
        for h, g, c in ((hg[dev], g_card, c_dev), (hg["cpu"], g_cpu, c_cpu)):
            lam = poisson.intensity(g, "lognormal", b, **{
                k: v for k, v in _halo_args(h).items() if k != "form"})
            if int(poisson.poisson_plain(keys[b], lam)[tuple(cell)]) != \
                    int(c[(b, *cell)]):
                raise AssertionError("a halo count differs from KH at its "
                                     "own intensity")
    log(f"phase 2 models halo counts {shape}: {len(diff)} of "
        f"{c_cpu.numel()} differ between the card and the CPU, each a tie "
        f"of the two renders' intensities (max |g| diff "
        f"{float((g_card - g_cpu).abs().max()):.3e})")
    if len(diff) > 1e-3 * c_cpu.numel():
        raise AssertionError("too many halo counts differ")
    hd = {d: hod.HODGenerator(*shape, sp, device=d) for d in (dev, "cpu")}
    gal = {d: hd[d].generate_galaxy_catalog(seed) for d in (dev, "cpu")}
    same = (gal[dev][0].shape == gal["cpu"][0].shape
            and np.array_equal(gal[dev][0], gal["cpu"][0]))
    log(f"phase 2 models galaxy catalog: {gal[dev][0].shape[0]} galaxies on "
        f"the card, {gal['cpu'][0].shape[0]} on the CPU, "
        f"{'equal' if same else 'not equal (their halo counts differ)'}")
    if not same and not len(torch.nonzero(
            hd[dev].halos.generate_halo_counts(seed).cpu()
            != hd["cpu"].halos.generate_halo_counts(seed))):
        raise AssertionError("equal halo counts gave other galaxies")
    rng = np.random.default_rng(2)
    delta = torch.as_tensor(0.4 * rng.standard_normal(shape),
                            dtype=torch.float32)
    a = zeldovich.poisson_sample(delta.to(dev), 0.05, sp, seed=seed).cpu()
    b = zeldovich.poisson_sample(delta, 0.05, sp, seed=seed)
    log(f"phase 2 models poisson_sample: {int((a != b).sum())} of "
        f"{a.numel()} differ (bit-equal required)")
    if not torch.equal(a, b):
        raise AssertionError("poisson_sample on the card differs")
    _close_to("second_order_density", spt.second_order_density(
        delta.to(dev), sp), spt.second_order_density(delta, sp),
        MODEL_SLICE_BAR)
    power = rft.load_default_power()
    tb = [spt.predicted_tree_bispectrum(power, shape, sp, nbins=4, device=d)
          for d in (dev, "cpu")]
    if not np.array_equal(tb[0][1], tb[1][1]):
        raise AssertionError("the tree bispectrum's triples differ")
    rel = np.abs(tb[0][2] - tb[1][2]) / np.where(tb[1][2] != 0,
                                                 np.abs(tb[1][2]), 1.0)
    worst = tuple(int(v) for v in tb[1][1][rel.argmax()])
    log(f"phase 2 models predicted_tree_bispectrum on the card vs the CPU: "
        f"rel {rel.max():.3e} at triple {worst} of {len(rel)} (bar "
        f"{TREE_TRIPLE_BAR:g} a triple)")
    if not rel.max() <= TREE_TRIPLE_BAR:
        raise AssertionError("the tree bispectrum on the card disagrees "
                             "with the CPU")
    kap = [lensing.convergence_map(delta.to(d), "Planck13", sp, 0.5)
           for d in (dev, "cpu")]
    _close_to("convergence_map", kap[0], kap[1], MODEL_SLICE_BAR)
    shear = [lensing.convergence_to_shear(k, sp) for k in kap]
    for i in range(2):
        _close_to(f"convergence_to_shear gamma{i + 1}", shear[0][i],
                  shear[1][i], MODEL_SLICE_BAR)
    noisy = [lensing.add_shape_noise(*s, 0.05, seed) for s in shear]
    _close_to("add_shape_noise", noisy[0][0], noisy[1][0], MODEL_SLICE_BAR)
    peb = [lensing.shear_power_eb(*s, sp) for s in noisy]
    _close_to("shear_power_eb (E)", peb[0][1], peb[1][1], MODEL_SLICE_BAR)
    _close_to("shear_power_eb (B)", peb[0][2], peb[1][2], MODEL_SLICE_BAR)
    mt = [multitracer.MultiTracerGenerator(*shape, sp, device=d)
          .generate_fields(seed) for d in (dev, "cpu")]
    for i in range(2):
        _close_to(f"multitracer field {i + 1}", mt[0][i], mt[1][i],
                  MODEL_SLICE_BAR)
    rec = [reconstruction.reconstruct_field(delta.to(d), sp, bias=1.5,
                                            f=0.5) for d in (dev, "cpu")]
    _close_to("reconstruct_field delta_rec", rec[0][0], rec[1][0],
              MODEL_SLICE_BAR)
    _close_to("reconstruct_field psi_hat", rec[0][1], rec[1][1],
              MODEL_SLICE_BAR)
    fm = []
    for d in (dev, "cpu"):
        model, theta = fisher.make_kaiser_model(
            power, shape, sp, params=("bias", "f", "sigma_fog"),
            fixed={"f": 0.5, "sigma_fog": 2.0}, device=d)
        fm.append(fisher.fisher_matrix_multipoles(model, theta, shape, sp,
                                                  nbins=16))
    _close_to("fisher_matrix_multipoles", fm[0], fm[1], MODEL_SLICE_BAR)


def _gate(what, ok, detail):
    log(f"phase 3 models gate {what}: {detail} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the {what} gate failed: {detail}")


def phase3_model_gates(torch, rft, dev):
    """The JAX package's statistical gates on the card: the halo counts'
    ensemble mean per bin against expected_counts and the halo power
    against predicted_halo_power (HALO_GATE), the galaxies against
    expected_galaxies (GALAXY_GATE), sigma_kappa growing with z_source
    (LENSING_GATE), reconstruction raising r(k) with the initial field in
    the quasi-linear band (RECON_GATE)."""
    from randomfield_tpu_torch.models import (halos, hod, lensing,
                                              reconstruction, zeldovich)
    from randomfield_tpu_torch.validate import stats

    shape, sp, nseeds = HALO_GATE
    hg = halos.HaloGenerator(*shape, sp, device=dev)
    totals, acc = [], []
    nbar_cell = hg.nbar[0] * sp ** 3
    for s in range(nseeds):
        c = hg.generate_halo_counts(s)
        totals.append(c.sum((1, 2, 3)).double().cpu().numpy())
        dh = (c[0].double() / nbar_cell - 1.0).float()
        acc.append(stats.calculate_power(dh, sp, nbins=16)[1])
        del c, dh
    totals = np.array(totals)
    mean, expect = totals.mean(0), hg.expected_counts()
    sig = totals.std(0, ddof=1) / np.sqrt(nseeds)
    _gate(f"halo counts {shape} ({nseeds} seeds)",
          bool(np.all(np.abs(mean - expect) < 5 * sig + 0.05 * expect)),
          f"mean {np.round(mean, 1).tolist()}, expected "
          f"{np.round(expect, 1).tolist()}")
    p_hat = np.mean(acc, axis=0)
    _, p_exp, cnt = hg.predicted_halo_power(0, nbins=16)
    good = cnt > 8
    sig = p_exp * np.sqrt(2.0 / (nseeds * np.maximum(cnt, 1)))
    resid = np.abs(p_hat[good] - p_exp[good])
    _gate("halo power (bin 0)", bool(np.all(
        resid < 5 * sig[good] + 0.1 * p_exp[good])),
        f"max resid / (5 sigma + 0.1 P) "
        f"{float(np.max(resid / (5 * sig[good] + 0.1 * p_exp[good]))):.3f}")
    del hg
    torch.cuda.empty_cache()
    shape, sp, nseeds = GALAXY_GATE
    hd = hod.HODGenerator(*shape, sp, device=dev)
    totals = [hd.generate_galaxy_catalog(s)[0].shape[0]
              for s in range(nseeds)]
    mean, expect = float(np.mean(totals)), hd.expected_galaxies()
    sig = np.std(totals, ddof=1) / np.sqrt(nseeds)
    _gate(f"galaxies {shape} ({nseeds} seeds)",
          abs(mean - expect) < 5 * sig + 0.05 * expect,
          f"mean {mean:.1f}, expected {expect:.1f}")
    del hd
    torch.cuda.empty_cache()
    shape, sp, zs = LENSING_GATE
    g = rft.Generator(*shape, grid_spacing=sp, device=dev)
    d = g.generate_delta_field(3)
    s = []
    for z in zs:
        k = lensing.convergence_map(d, g.cosmology, sp, z_source=z)
        s.append(float(k.std()))
        if not abs(float(k.mean())) < 5.0 * s[-1] / np.sqrt(k.numel()) + 1e-6:
            raise AssertionError("the convergence map's mean is off")
    _gate(f"sigma_kappa {shape}", s[0] < s[1] < s[2],
          f"at z_source {zs}: {np.round(s, 6).tolist()}")
    del g, d
    torch.cuda.empty_cache()
    shape, sp = RECON_GATE
    g = rft.Generator(*shape, grid_spacing=sp, device=dev)
    lin = g.generate_delta_field(11, apply_lightcone=False)
    psi = g.generate_displacement(11)
    q = zeldovich.lagrangian_positions(shape, sp, device=dev)
    evolved, _ = zeldovich.paint(q + psi, shape, sp, window="cic")
    del q, psi
    rec, _ = reconstruction.reconstruct_field(evolved, sp, smoothing=10.0)

    def cross_r(a, b):
        k, pab, c = stats.calculate_cross_power(a, b, sp, nbins=20)
        _, paa, _ = stats.calculate_power(a, sp, nbins=20)
        _, pbb, _ = stats.calculate_power(b, sp, nbins=20)
        return k, np.where(c > 0, pab / np.sqrt(np.maximum(paa * pbb, 1e-30)),
                           np.nan), c

    k, r_ev, c = cross_r(evolved, lin)
    _, r_rec, _ = cross_r(rec, lin)
    ql = (k > 0.25) & (k < 0.6) & (c > 50)
    linear = (k < 0.15) & (c > 8)
    _gate(f"reconstruction {shape}", bool(
        ql.sum() >= 2 and np.nanmean(r_rec[ql]) > np.nanmean(r_ev[ql]) + 0.01
        and np.all(r_rec[linear] > 0.95)),
        f"quasi-linear r {np.nanmean(r_ev[ql]):.4f} -> "
        f"{np.nanmean(r_rec[ql]):.4f}, linear min "
        f"{float(np.min(r_rec[linear])):.4f}")
    del g, lin, evolved, rec
    torch.cuda.empty_cache()


def phase3_models(torch, rft, dev, hg, hd, card):
    """The slice's main paths at 1024^3 through the public API, each with
    the launch counts set to 0 before it and read after it (none through
    torch.fft), its host seconds and its peak device memory.  Returns the
    launch counts, summed, the peaks and the host seconds (the time of the
    host-bound paths: the catalogs, the tree bispectrum, the forecast)."""
    from randomfield_tpu_torch.models import (fisher, lensing, multitracer,
                                              reconstruction, spt, zeldovich)

    total = dict.fromkeys(KERNEL_ORDER, 0)
    peaks, seconds = {}, {}
    sp, seed = HEADLINE_SPACING, MODELS_SEED
    render = {"K2F": 1, "K3": 2, "K4": 1}
    counts, peaks["generate_halo_counts"] = _path(
        torch, f"generate_halo_counts ({HALO_BINS} bins)",
        lambda: hg.generate_halo_counts(seed), {**render, "KH": 1}, total, seconds)
    log(f"phase 3 halo counts per bin {counts.sum((1, 2, 3)).tolist()}, "
        f"expected {np.round(hg.expected_counts(), 1).tolist()}")
    del counts
    (pos, mass), peaks["generate_halo_catalog"] = _path(
        torch, "generate_halo_catalog", lambda: hg.generate_halo_catalog(seed),
        {**render, "KH": 1}, total, seconds)
    if not (np.isfinite(pos).all() and (mass > 0).all()):
        raise AssertionError("the 1024^3 halo catalog is off")
    del pos, mass
    for rsd in (False, True):
        least = ({"K2F": 2, "K3": 4, "K4": 2, "KH": 1, "KD": 1} if rsd
                 else {**render, "KH": 1})
        (pos, cen), peaks[f"generate_galaxy_catalog rsd={rsd}"] = _path(
            torch, f"generate_galaxy_catalog (rsd={rsd})",
            lambda: hd.generate_galaxy_catalog(seed, rsd=rsd), least, total, seconds)
        log(f"phase 3 galaxies (rsd={rsd}): {pos.shape[0]} "
            f"({int(cen.sum())} centrals), expected "
            f"{hd.expected_galaxies():.0f}")
        del pos, cen
    delta = hg.lognormal.gaussian.generate_delta_field(seed)
    d2, peaks["second_order_density"] = _path(
        torch, "second_order_density", lambda: spt.second_order_density(
            delta, sp), {"K6": 1, "K3": 26, "K4": 12, "KD": 12}, total, seconds)
    if not bool(torch.isfinite(d2).all()):
        raise AssertionError("the 1024^3 second-order density is not finite")
    del d2
    counts, peaks["poisson_sample"] = _path(
        torch, "poisson_sample", lambda: zeldovich.poisson_sample(
            delta, 2e-3, sp, seed), {"KH": 1}, total, seconds)
    del counts
    kappa, peaks["convergence_map"] = _path(
        torch, "convergence_map", lambda: lensing.convergence_map(
            delta, hg.cosmology, sp, 0.5), {}, total, seconds)
    (g1, g2), peaks["convergence_to_shear"] = _path(
        torch, "convergence_to_shear", lambda: lensing.convergence_to_shear(
            kappa, sp), {"K3": 6}, total, seconds)
    _, peaks["shear_power_eb"] = _path(
        torch, "shear_power_eb", lambda: lensing.shear_power_eb(g1, g2, sp),
        {"K3": 4}, total, seconds)
    del kappa, g1, g2
    mt = multitracer.MultiTracerGenerator(*HEADLINE, sp, device=dev)
    fields, peaks["multitracer generate_fields"] = _path(
        torch, "multitracer generate_fields", lambda: mt.generate_fields(
            seed), {"K2F": 2, "K2": 2, "K3": 4, "K4": 2}, total, seconds)
    del fields, mt
    (rec, psi), peaks["reconstruct_field"] = _path(
        torch, "reconstruct_field", lambda: reconstruction.reconstruct_field(
            delta, sp, bias=1.5, f=0.5), {"K6": 1, "K3": 8, "K4": 3, "KD": 3,
                                          "KP": 2, "KPC": 2}, total, seconds)
    del rec, psi, delta
    torch.cuda.empty_cache()
    (_, tri, b, ntri), peaks[f"predicted_tree_bispectrum nbins={TREE_NBINS}"] \
        = _path(torch, f"predicted_tree_bispectrum (nbins = {TREE_NBINS})",
                lambda: spt.predicted_tree_bispectrum(
                    hg._power, HEADLINE, sp,
                    nbins=TREE_NBINS, device=dev), {"K3": 2, "K4": 1}, total, seconds)
    log(f"phase 3 tree bispectrum: {len(tri)} triples, B at the first "
        f"{np.round(b[:3], 1).tolist()}")
    if not np.isfinite(b).all():
        raise AssertionError("the 1024^3 tree bispectrum is not finite")
    model, theta = fisher.make_kaiser_model(
        hg._power, FISHER_SHAPE, 8.0,
        params=("bias", "f", "sigma_fog"), fixed={"f": 0.5, "sigma_fog": 2.0},
        device=dev)
    fm, peaks["fisher_matrix_multipoles 256^3"] = _path(
        torch, f"fisher_matrix_multipoles {FISHER_SHAPE}",
        lambda: fisher.fisher_matrix_multipoles(model, theta, FISHER_SHAPE,
                                                8.0), {}, total, seconds)
    log(f"phase 3 Fisher matrix {FISHER_SHAPE}: diag "
        f"{np.round(np.diag(fm), 1).tolist()}")
    if not (np.isfinite(fm).all() and (np.diag(fm) > 0).all()):
        raise AssertionError("the Fisher matrix is off")
    torch.cuda.empty_cache()
    return total, peaks, seconds


def phase4_models(torch, rft, dev, hg, seconds, plain_ms, card):
    """Times at 1024^3 (CUDA events, median after a warm-up) and peak device
    memory: KH alone beside phase 1's plain time, on the bins below 10 and
    on the bin whose intensity reaches 10 apart (the rejection passes);
    generate_halo_counts, second_order_density, the lensing paths, the
    multi-tracer pair and reconstruction; the host-bound paths (the
    catalogs, the tree bispectrum, the forecast) with phase 3's host
    seconds.  Returns ({"KH": (ms, plain ms, None)}, (KH's Knuth iterations
    in the timed launch, the least rejection steps its data needs))."""
    from randomfield_tpu_torch.models import (lensing, multitracer,
                                              reconstruction, spt)
    from randomfield_tpu_torch.ops import poisson

    sp, seed = HEADLINE_SPACING, MODELS_SEED
    g = hg.lognormal.gaussian.generate_delta_field(seed,
                                                   apply_lightcone=False)
    g_cells = g.numel()
    keys, kw = _halo_keys(hg, seed), _halo_args(hg)
    out = torch.empty((HALO_BINS, *HEADLINE), dtype=torch.int32, device=dev)
    kh_ms = cuda_ms(torch, lambda: poisson.poisson_counts(g, keys, out=out,
                                                          **kw))
    cells = g.numel() * HALO_BINS
    lam_kw = {k: v for k, v in kw.items() if k != "form"}
    live, high = 0, []
    for b in range(HALO_BINS):
        lam = poisson.intensity(g, "lognormal", b, **lam_kw)
        live += int((lam > 0).sum())
        high.append(int((lam >= 10).sum()))
        del lam
    iterations = int(out.sum(dtype=torch.int64)) + live
    log(f"phase 4 KH {HEADLINE}, {HALO_BINS} bins: {kh_ms:.3f} ms (plain "
        f"{plain_ms:.1f} ms, phase 1); {iterations} Knuth iterations over "
        f"{cells} (cell, bin) pairs; cells with lambda >= 10 per bin {high} "
        f"[{card}]")
    for what, bins in (("bins without lambda >= 10", [
            b for b in range(HALO_BINS) if not high[b]]), (
            "bins with lambda >= 10", [b for b in range(HALO_BINS)
                                       if high[b]])):
        if not bins:
            continue
        sub = {k: (np.asarray(v)[bins] if k in ("lam0", "bias") else v)
               for k, v in kw.items()}
        ms = cuda_ms(torch, lambda: poisson.poisson_counts(
            g, [keys[b] for b in bins], **sub))
        log(f"phase 4 KH {what} {bins}: {ms:.3f} ms [{card}]")
    del g, out
    torch.cuda.empty_cache()
    times = {"KH": (kh_ms, plain_ms, None)}
    ms, peak = timed_peak(torch, lambda: hg.generate_halo_counts(seed))
    log(f"phase 4 generate_halo_counts {HEADLINE}: {ms:.3f} ms, peak {peak} "
        f"[{card}]")
    delta = hg.lognormal.gaussian.generate_delta_field(seed)
    kappa = lensing.convergence_map(delta, hg.cosmology, sp, 0.5)
    g1, g2 = lensing.convergence_to_shear(kappa, sp)
    mt = multitracer.MultiTracerGenerator(*HEADLINE, sp, device=dev)
    for what, fn in (
            ("second_order_density", lambda: spt.second_order_density(
                delta, sp)),
            ("convergence_map + convergence_to_shear", lambda:
             lensing.convergence_to_shear(lensing.convergence_map(
                 delta, hg.cosmology, sp, 0.5), sp)),
            ("shear_power_eb", lambda: lensing.shear_power_eb(g1, g2, sp)),
            ("multitracer generate_fields", lambda: mt.generate_fields(seed)),
            ("reconstruct_field", lambda: reconstruction.reconstruct_field(
                delta, sp, bias=1.5, f=0.5))):
        ms, peak = timed_peak(torch, fn)
        log(f"phase 4 {what} {HEADLINE}: {ms:.3f} ms, peak {peak} [{card}]")
    del delta, kappa, g1, g2, mt
    torch.cuda.empty_cache()
    for what, dt in seconds.items():
        if any(w in what for w in ("catalog", "bispectrum", "fisher")):
            log(f"phase 4 {what} {HEADLINE}: {dt:.3f} s (phase 3's first "
                f"call, host clock) [{card}]")
    flagged = sum(1 for h in high if h)
    return times, (iterations, flagged * g_cells + sum(high))


def kh_bound(iterations, rejection_steps):
    """(bytes, operations) of KH at 1024^3 with HALO_BINS bins: g read once
    and the int32 counts written once; the intensity a (cell, bin),
    ``iterations`` Knuth iterations and ``rejection_steps`` rejection
    steps, all float32 and integer operations."""
    cells = HEADLINE[0] * HEADLINE[1] * HEADLINE[2]
    nbytes = 4 * cells + 4 * HALO_BINS * cells
    ops = (KH_OPS_PER_CELL_BIN * cells * HALO_BINS
           + KH_OPS_PER_ITERATION * iterations
           + KH_OPS_PER_REJECTION_STEP * rejection_steps)
    return nbytes, ops


def kernel_bounds(g, kx_candidates, kq_in_range, kq_examined, kh_work):
    """{K: (bound_ms, bound_by)} at the 1024^3 main paths' shapes: the larger
    of the bytes each kernel must move (inputs read once, outputs written
    once) over the HBM rate and its operations over the float32 rate.  K6
    at the one-rank forward transform's shape, K7 and K8 on one shard of a
    four-rank mesh; KX's mask and void modes as "KX mask" and "KX voids"
    (the void mode with phase 4's ``kx_candidates``); KQ on phase 4's
    PAIR_OBJECTS auto count, ``kq_in_range`` of its pairs in range and
    ``kq_examined``, the pairs that a cell list examines and their
    components that wrap (cell_walk_pairs); KH on the halo counts of phase
    4 (:func:`kh_bound` of ``kh_work``, its Knuth iterations and rejection
    steps)."""
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
        # KM: u and the nine derivative fields read once, the edges; the
        # sums written; its float64 adds at the float32 rate's scale
        "KM": (40 * cells + 4 * (KM_NBINS + 1) + 32 * KM_NBINS,
               (KM_OPS_PER_VOXEL + KM_FP64_ADDS * FP32_OPS_PER_S
                / FP64_OPS_PER_S) * cells),
        # KX (calculate_peaks' peak mode): the field read once, the edges,
        # the counts written
        "KX": (4 * cells + 4 * (PEAK_NBINS + 1) + 8 * (PEAK_NBINS + 1),
               KX_OPS_PER_VOXEL * cells),
        # its mask: the peak mode's bytes and the uint8 mask written
        "KX mask": (5 * cells + 4 * (PEAK_NBINS + 1) + 8 * (PEAK_NBINS + 1),
                    KX_OPS_PER_VOXEL * cells),
        # its void mode: rv and delta read once, the count and the
        # candidates' indices written; its float64 operations at the
        # float32 rate's scale
        "KX voids": (8 * cells + 8 + 8 * kx_candidates,
                     KX_VOID_FP64_OPS_PER_VOXEL * cells * FP32_OPS_PER_S
                     / FP64_OPS_PER_S),
        # KQ (isotropic auto): the catalog's rows read once (twice: both
        # sides of the pairs), the edges, the sums written; its operations
        # on the pairs a cell list examines, on their components that wrap
        # and on the pairs in range
        "KQ": (2 * 16 * PAIR_OBJECTS + 4 * len(PAIR_EDGES)
               + 16 * (len(PAIR_EDGES) - 1),
               KQ_OPS_PER_PAIR * kq_examined[0]
               + KQ_OPS_PER_WRAP * kq_examined[1]
               + KQ_OPS_PER_PAIR_IN_RANGE * kq_in_range),
        "KH": kh_bound(*kh_work),
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

    if sys.argv[1:] not in ([], ["--kc-times"], ["--kx-times"],
                            ["--kq-times"]):
        print("usage: python3 chip_smoke.py [--kc-times | --kx-times | "
              "--kq-times]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs one CUDA card", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import randomfield_tpu_torch as rft
        from randomfield_tpu_torch.models import halos, hod
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
        if sys.argv[1:] == ["--kx-times"]:
            kx_times_only(torch, rft, dev, card)
            return 0
        if sys.argv[1:] == ["--kq-times"]:
            kq_times_only(torch, rft, dev, card)
            return 0
        phase0_attributes(card)
        phase0_sass(torch, card)
        phase0_mocks(torch, card)
        t0 = time.perf_counter()
        phase0_morphology(card)
        morph_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase0_catalogs(card)
        catalog_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase0_models(card)
        models_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        g = rft.Generator(*HEADLINE, grid_spacing=HEADLINE_SPACING, device=dev)
        log(f"phase 0 scene setup {HEADLINE}: {time.perf_counter() - t0:.3f} s "
            f"on the host")
        gp = rft.Generator(*HEADLINE, grid_spacing=HEADLINE_SPACING,
                           device=dev, sampler="pallas")

        errs = {}
        phase1_sigma_steps(torch, g)
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
        t0 = time.perf_counter()
        phase1_morphology(torch, g, errs)
        morph_s += time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        phase1_catalogs(torch, g, errs)
        catalog_s += time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        hg = halos.HaloGenerator(*HEADLINE, HEADLINE_SPACING, device=dev)
        kh_plain_ms = phase1_models(torch, hg, errs)
        models_s += time.perf_counter() - t0
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
        t0 = time.perf_counter()
        phase2_morphology(torch, rft, dev)
        morph_s += time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        phase2_catalogs(torch, rft, dev)
        catalog_s += time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        phase2_models(torch, rft, dev)
        torch.cuda.empty_cache()
        phase3_model_gates(torch, rft, dev)
        models_s += time.perf_counter() - t0
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
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        morph_launches, morph_peaks = phase3_morphology(torch, rft, dev, g,
                                                        card)
        morph_s += time.perf_counter() - t0
        main_paths.append(morph_launches)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        catalog_launches, catalog_peaks = phase3_catalogs(torch, rft, dev, g,
                                                          card)
        catalog_s += time.perf_counter() - t0
        main_paths.append(catalog_launches)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        hd = hod.HODGenerator(*HEADLINE, HEADLINE_SPACING, device=dev)
        model_launches, model_peaks, model_seconds = phase3_models(
            torch, rft, dev, hg, hd, card)
        models_s += time.perf_counter() - t0
        main_paths.append(model_launches)
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
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        morph_times, kx_candidates = phase4_morphology(torch, rft, dev, g,
                                                       card)
        times.update(morph_times)
        morph_s += time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        catalog_times, kq_in_range, kq_examined = phase4_catalogs(
            torch, rft, dev, g, card)
        times.update(catalog_times)
        catalog_s += time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model_times, kh_work = phase4_models(
            torch, rft, dev, hg, model_seconds, kh_plain_ms, card)
        times.update(model_times)
        models_s += time.perf_counter() - t0
        bounds = kernel_bounds(g, kx_candidates, kq_in_range, kq_examined,
                               kh_work)
        log(f"phase 4 peak device memory of the 1024^3 mock paths (GiB): "
            f"{ {k: round(v, 3) for k, v in mock_peaks.items()} } [{card}]")
        log(f"phase 4 peak device memory of the 1024^3 morphology methods "
            f"(GiB): { {k: round(v, 3) for k, v in morph_peaks.items()} } "
            f"[{card}]")
        log(f"chip_smoke morphology phases (KM, KX; phases 0-4) wall time "
            f"{morph_s:.1f} s [{card}]")
        log(f"phase 4 peak device memory of the 1024^3 catalog paths (GiB): "
            f"{ {k: round(v, 3) for k, v in catalog_peaks.items()} } "
            f"[{card}]")
        log(f"chip_smoke catalog phases (KQ, FKP, marked, velocity; phases "
            f"0-4) wall time {catalog_s:.1f} s [{card}]")
        log(f"phase 4 peak device memory of the 1024^3 model paths (GiB): "
            f"{ {k: round(v, 3) for k, v in model_peaks.items()} } [{card}]")
        log(f"chip_smoke model phases (KH, halos, HOD, SPT, lensing, Fisher, "
            f"multi-tracer, reconstruction; phases 0-4) wall time "
            f"{models_s:.1f} s [{card}]")
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
