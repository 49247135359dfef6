#!/usr/bin/env python3
"""Smoke run of randomfield_tpu_torch on one CUDA card: build, check, time.

Run from the repository root on a machine with one NVIDIA GPU (H100):

    python3 chip_smoke.py

It needs PyTorch with CUDA, nvcc (the kernels are built from
randomfield_tpu_torch/csrc at first use) and numpy; it never imports JAX
or the randomfield_tpu package.  Phases, any failure of which exits
non-zero with no result line:

0. the card's name and power limit (nvidia-smi), CUDA version, kernel build;
1. each hand kernel (K2 scale_sigma, K3 fft_axis, K4 c2r_tail) against its
   plain PyTorch version on the card: at the exact shapes, table and
   weights the 1024^3 main path gives it, and over a sweep of lengths;
2. the slice at 128^3: CUDA render vs the CPU render (plain versions) at
   the same seed, which the CPU tests hold to the JAX package;
3. the main path at 1024^3, through the public API: determinism, finite
   values, variance vs predicted_variance, and the kernels' launch counts;
4. times (CUDA events, median after warm-up) of renders at 512^3 and
   1024^3, of each stage of a 1024^3 render, of each kernel beside its
   plain version; the device's idle share during a 1024^3 render
   (torch.profiler) and the render's peak device memory.

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

KERNELS = {
    "K2": dict(name="scale_sigma", route="cuda",
               source="randomfield_tpu_torch/csrc/scale_sigma.cu",
               replaces="randomfield_tpu/ops/pallas_sampler.py:491"),
    "K3": dict(name="fft_axis", route="cuda",
               source="randomfield_tpu_torch/csrc/fft_axis.cu",
               replaces="randomfield_tpu/ops/pallas_fft.py:135"),
    "K4": dict(name="c2r_tail", route="cuda",
               source="randomfield_tpu_torch/csrc/c2r_tail.cu",
               replaces="randomfield_tpu/ops/pallas_fft.py:338"),
}
# relative bars (max|kernel - plain| / max|plain|): float32 rounding of a
# scale (K2) and of a log2(n)-stage FFT against cuFFT's (K3, and K4 as the
# c2r tail test of the JAX package's tests/test_pallas_fft.py)
BARS = {"K2": 2e-6, "K3": 2e-6, "K4": 5e-6}
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


def reset_counts():
    from randomfield_tpu_torch.ops import fft, sampler

    sampler.K2_LAUNCHES = fft.K3_LAUNCHES = fft.K4_LAUNCHES = 0


def read_counts():
    from randomfield_tpu_torch.ops import fft, sampler

    return {"K2": sampler.K2_LAUNCHES, "K3": fft.K3_LAUNCHES,
            "K4": fft.K4_LAUNCHES}


def phase2_slice(torch, rft, dev):
    """CUDA render vs CPU (plain) render at 128^3, seed 7."""
    shape, spacing, seed = (128, 128, 128), 16.0, 7
    g_dev = rft.Generator(*shape, grid_spacing=spacing, device=dev)
    g_cpu = rft.Generator(*shape, grid_spacing=spacing, device="cpu")
    for s in (0.0, 20.0):
        reset_counts()
        got = g_dev.generate_delta_field(seed, smoothing_length=s)
        torch.cuda.synchronize()
        counts = read_counts()
        want = g_cpu.generate_delta_field(seed, smoothing_length=s)
        _, r = rel_err((got.cpu(),), (want,))
        log(f"phase 2 slice {shape} seed {seed} s={s}: rel {r:.3e} "
            f"(bar {SLICE_BAR:g}), launches {counts}")
        if not r <= SLICE_BAR:
            raise AssertionError(f"CUDA render disagrees with CPU: rel {r:.3e}")
        if counts["K2"] < 1 or counts["K3"] < 2 or counts["K4"] < 1:
            raise AssertionError(f"render skipped a kernel: {counts}")


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
    """The 1024^3 main path through the public API; returns the launch
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
    log(f"phase 3 main path {HEADLINE}: var {var:.6g}, predicted {pred:.6g}, "
        f"ratio {var / pred:.5f}, launches {counts}")
    if not abs(var / pred - 1.0) <= VAR_BAR:
        raise AssertionError(f"variance off prediction: {var / pred:.4f}")
    if counts["K2"] < 2 or counts["K3"] < 4 or counts["K4"] < 2:
        raise AssertionError(f"main path skipped a kernel: {counts}")
    return counts


def stage_breakdown(torch, g, seed):
    """Median device ms of each stage of ``g``'s render, timed with CUDA
    events between the stages.  The stages are the calls of
    ``Generator.generate_delta_field``, made one by one here; the field
    they give must equal that method's bit for bit."""
    from randomfield_tpu_torch.ops import fft, sample, sampler, threefry, transform

    nx, ny, nz = g.shape
    nzh = nz // 2 + 1
    stages = {
        "Threefry draws (plain PyTorch)": lambda _: sample.unit_draws_reim(
            threefry.key_from_seed(seed), g.shape, g.device),
        "Hermitian symmetrize (plain)": lambda ri: (
            transform.symmetrize_with_shape_reim(*ri, nz), ri)[1],
        "K2 scale_sigma": lambda ri: sampler.scale_sigma(
            *ri, g.state.table, g.shape, g.grid_spacing, gain=RENDER_GAIN),
        "K3 fft_axis x pass": lambda ri: fft.ifft_axis(*ri, 1, nx, ny * nzh),
        "K3 fft_axis y pass": lambda ri: fft.ifft_axis(*ri, nx, ny, nzh),
        "K4 c2r_tail": lambda ri: fft.c2r_tail(*ri, nz,
                                               g.state.lightcone_weights),
    }
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


def phase4_times(torch, rft, dev, g, card):
    """Times at the main path's shapes; returns {K: (ms, plain_ms)}."""
    from randomfield_tpu_torch.ops import fft, sampler

    nx, ny, nz = HEADLINE
    nzh = nz // 2 + 1
    g512 = rft.Generator(512, 512, 512, grid_spacing=4.0, device=dev)
    render_ms = {}
    for gen_ in (g512, g):
        ms = cuda_ms(torch, lambda: gen_.generate_delta_field(seed=2))
        n = gen_.shape[0] * gen_.shape[1] * gen_.shape[2]
        render_ms[gen_.shape] = ms
        log(f"phase 4 render {gen_.shape}: {ms:.3f} ms, "
            f"{n / ms / 1e6:.4f} Gcells/s [{card}]")

    stage_ms = stage_breakdown(torch, g, seed=2)
    total = sum(stage_ms.values())
    for name, ms in stage_ms.items():
        log(f"phase 4 stage {name} {HEADLINE}: {ms:.3f} ms, "
            f"{100 * ms / total:.2f}% of the {total:.3f} ms stage sum [{card}]")
    idle = device_idle_share(torch, g, seed=2)
    if idle is None:
        log(f"phase 4 device idle share of a {HEADLINE} render: not measured "
            f"(the profiler recorded no device activity) [{card}]")
    else:
        log(f"phase 4 device idle share of a {HEADLINE} render: "
            f"{100 * idle[0]:.3f}% (device span {idle[1]:.3f} ms, busy "
            f"{idle[2]:.3f} ms; torch.profiler) [{card}]")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    f = g.generate_delta_field(seed=3)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"phase 4 peak device memory of a {HEADLINE} render: "
        f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above "
        f"the {base / 2**30:.3f} GiB held before it) [{card}]")
    del f

    gen = torch.Generator(device=dev).manual_seed(4)
    src_re = torch.randn((nx, ny, nzh), generator=gen, device=dev)
    src_im = torch.randn((nx, ny, nzh), generator=gen, device=dev)
    src_im[..., 0] = 0.0
    src_im[..., -1] = 0.0
    re, im = torch.empty_like(src_re), torch.empty_like(src_im)

    def fresh():
        re.copy_(src_re)
        im.copy_(src_im)

    t, w = g.state.table, g.state.lightcone_weights
    runs = {
        "K2": (lambda: sampler.scale_sigma(re, im, t, HEADLINE, HEADLINE_SPACING,
                                           gain=RENDER_GAIN),
               lambda: sampler.scale_sigma_plain(re, im, t, HEADLINE,
                                                 HEADLINE_SPACING,
                                                 gain=RENDER_GAIN)),
        "K3 x pass": (lambda: fft.ifft_axis(re, im, 1, nx, ny * nzh),
                      lambda: fft.ifft_axis_plain(re, im, 1, nx, ny * nzh)),
        "K3 y pass": (lambda: fft.ifft_axis(re, im, nx, ny, nzh),
                      lambda: fft.ifft_axis_plain(re, im, nx, ny, nzh)),
        "K4": (lambda: fft.c2r_tail(re, im, nz, w),
               lambda: fft.c2r_tail_plain(re, im, nz, w)),
    }
    times = {}
    for what, (kernel, plain) in runs.items():
        # in turns: plain, kernel, kernel, plain; the median of each pair
        p1 = cuda_ms(torch, plain, setup=fresh)
        k1 = cuda_ms(torch, kernel, setup=fresh)
        k2 = cuda_ms(torch, kernel, setup=fresh)
        p2 = cuda_ms(torch, plain, setup=fresh)
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        times[what] = (k_ms, p_ms)
        log(f"phase 4 {what} at {HEADLINE}: kernel {k_ms:.3f} ms "
            f"({k1:.3f}, {k2:.3f}), plain {p_ms:.3f} ms ({p1:.3f}, {p2:.3f}) "
            f"[{card}]")
    x, y = times.pop("K3 x pass"), times.pop("K3 y pass")
    times["K3"] = (x[0] + y[0], x[1] + y[1])
    return times


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

        errs = {}
        phase1_kernels(torch, g, errs)
        torch.cuda.empty_cache()
        phase2_slice(torch, rft, dev)
        counts = phase3_main(torch, g)
        torch.cuda.empty_cache()
        times = phase4_times(torch, rft, dev, g, card)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    kernels = [
        dict(KERNELS[k], launches=counts[k], max_abs_err=errs[k],
             ms=times[k][0], plain_ms=times[k][1])
        for k in ("K2", "K3", "K4")
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
