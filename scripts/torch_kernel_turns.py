#!/usr/bin/env python3
"""Time the port's drawing kernels against another checkout's, in turns.

On a machine with one CUDA card, from the repository root, with REF another
commit unpacked by ``git archive`` into a directory ``.gitignore`` lists:

    mkdir -p build/ref && git archive <commit> | tar -x -C build/ref
    python3 scripts/torch_kernel_turns.py build/ref

Four worker processes run one after another, REF, this checkout, this
checkout, REF; each imports its own checkout's ``randomfield_tpu_torch``,
builds its kernels, counts the SASS of the hashing kernels' per-mode loops
(``chip_smoke.sass_counts``: registers, loop instructions, instructions a
mode), digests every kernel's SASS and times with CUDA events at 1024^3,
2 Mpc/h, seed 2, through the public wrappers, each kernel twice: single
launches (median of 5 after a warm-up, the device synchronized after each)
and back to back (BATCH launches with no synchronization between them, the
median of BATCHES batches, the SM clock and power sampled by nvidia-smi
meanwhile):
K2F ``draw_scale``, its unit mode (``generate_noise``'s draw), its fixed
mode (K2FX ``draw_fixed``, the fixed and the paired field), KN's fixed mode
(``sample_nested(mode='fixed')`` on the nested scene's table), K7
``draw_scale_shard`` on the second of four ky shards and K10
``genfft.sample_fftx`` (the planes made before the timing), with K1
``sample_modes``, K8 ``sample_shard`` on the second shard and K5
``sample_power_bins`` (one seed, 32 bins) as controls.  The workers also
save K2F's spectrum (s = 0 and 8), unit normals and fixed fields (s = 0 and
8, the paired field at s = 0), KN's fixed field, K1's spectrum, K5's sums
and K10's lines at 256^3; the parent process holds this checkout's K2F,
K2FX, KN fixed, K1 and K5 to REF's bit for bit and its K10 to REF's within
K10's bar (5e-6 of the largest output: the transform's rounding may move,
the draws may not).
Prints each kernel's two turns a side and their means, single and back to
back, with the card's name and power limit, each turn's SM clock range
and median power, and the kernels whose SASS differs from REF's.
It never imports JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import statistics
import subprocess
import sys

HEADLINE, SPACING, SEED, NBINS = (1024, 1024, 1024), 2.0, 2, 32
CHECK_SHAPE = (256, 256, 256)
# K10 against REF's: chip_smoke.py's BARS["K10"]
K10_BAR = 5e-6
REPS = 5
BATCH, BATCHES = 40, 3
RANKS = 4
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cuda_ms(torch, fn):
    times = []
    for i in range(REPS + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if i:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(torch, fn):
    """Per-launch ms of BATCH launches with no synchronization between
    them, the median of BATCHES batches."""
    per = []
    for _ in range(BATCHES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BATCH):
            fn()
        end.record()
        torch.cuda.synchronize()
        per.append(start.elapsed_time(end) / BATCH)
    return statistics.median(per)


def sampling_clock(fn):
    """fn() while nvidia-smi samples the SM clock (MHz) and the power (W)
    every 100 ms: (its result, [min clock, max clock], median power)."""
    import tempfile

    with tempfile.TemporaryFile("w+") as fh:
        smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=fh, stderr=subprocess.DEVNULL)
        try:
            out = fn()
        finally:
            smi.terminate()
            smi.wait(timeout=60)
        fh.seek(0)
        rows = [[float(v) for v in line.split(",")] for line in fh
                if line.count(",") == 1]
    clock = [r[0] for r in rows]
    return out, [min(clock), max(clock)], statistics.median(r[1] for r in rows)


def worker(root, out_dir, tag):
    """One turn: the kernels of the checkout at ``root``."""
    import importlib.util

    sys.path.insert(0, root)
    import torch

    import randomfield_tpu_torch as rft
    from randomfield_tpu_torch.ops import _build, genfft, sampler
    from randomfield_tpu_torch.validate import stats

    if not rft.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {rft.__file__}, not {root}'s package")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    lib = _build._build()
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = smoke.sass_counts(lib, cuobjdump)
    funcs, _ = smoke.sass_functions(lib, cuobjdump)
    # an anonymous namespace's mangled name carries a hash of the source's
    # path: drop it, so that the two checkouts' kernels pair up
    digests = {re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_(\w+?_cu)_[0-9a-f]{8}",
                      r"\1_", f):
               hashlib.sha256("\n".join(t for _, t in body).encode())
               .hexdigest() for f, body in funcs.items()}
    dev = torch.device("cuda", 0)
    table = sampler.make_sigma_table(rft.load_default_power(), HEADLINE,
                                     SPACING, device=dev)
    nested = sampler.make_box_sigma_table(rft.load_default_power(), HEADLINE,
                                          SPACING, device=dev)
    edges, _ = stats.bin_setup(HEADLINE, SPACING, NBINS)
    ny_loc = HEADLINE[1] // RANKS
    planes = genfft.plane_spectra(SEED, table, HEADLINE, SPACING)
    runs = {
        "K2F": lambda: sampler.draw_scale(SEED, table, HEADLINE, SPACING),
        "K2F unit": lambda: sampler.draw_scale(SEED, table, HEADLINE, SPACING,
                                               unit=True),
        "K2FX": lambda: sampler.draw_fixed(SEED, table, HEADLINE, SPACING),
        "K2FX paired": lambda: sampler.draw_fixed(SEED, table, HEADLINE,
                                                  SPACING, flip=True),
        "KN fixed": lambda: sampler.sample_nested(SEED, nested, HEADLINE,
                                                  SPACING, mode="fixed"),
        "K7": lambda: sampler.draw_scale_shard(SEED, table, HEADLINE, SPACING,
                                               0.0, ny_loc, ny_loc),
        "K10": lambda: genfft.sample_fftx(SEED, table, HEADLINE, SPACING,
                                          planes=planes),
        "K1": lambda: sampler.sample_modes(SEED, table, HEADLINE, SPACING),
        "K8": lambda: sampler.sample_shard(SEED, table, HEADLINE, SPACING,
                                           0.0, ny_loc, ny_loc),
        "K5": lambda: sampler.sample_power_bins(SEED, table, HEADLINE,
                                                SPACING, 0.0, edges),
    }
    ms = {k: cuda_ms(torch, fn) for k, fn in runs.items()}
    b2b, clock, power = sampling_clock(
        lambda: {k: back_to_back_ms(torch, fn) for k, fn in runs.items()})
    del planes
    small = sampler.make_sigma_table(rft.load_default_power(), CHECK_SHAPE,
                                     8.0, device=dev)
    small_nested = sampler.make_box_sigma_table(rft.load_default_power(),
                                                CHECK_SHAPE, 8.0, device=dev)
    edges, _ = stats.bin_setup(CHECK_SHAPE, 8.0, NBINS)
    out = {
        "k1": sampler.sample_modes(SEED, small, CHECK_SHAPE, 8.0, 8.0),
        "k5": sampler.sample_power_bins(SEED, small, CHECK_SHAPE, 8.0, 8.0,
                                        edges),
        "k2f s=0": sampler.draw_scale(SEED, small, CHECK_SHAPE, 8.0),
        "k2f s=8": sampler.draw_scale(SEED, small, CHECK_SHAPE, 8.0, 8.0),
        "k2f unit": sampler.draw_scale(SEED, small, CHECK_SHAPE, 8.0,
                                       unit=True),
        "k2fx s=0": sampler.draw_fixed(SEED, small, CHECK_SHAPE, 8.0),
        "k2fx s=8": sampler.draw_fixed(SEED, small, CHECK_SHAPE, 8.0, 8.0),
        "k2fx paired": sampler.draw_fixed(SEED, small, CHECK_SHAPE, 8.0,
                                          flip=True),
        "kn fixed": sampler.sample_nested(SEED, small_nested, CHECK_SHAPE,
                                          8.0, mode="fixed"),
        "k10": genfft.sample_fftx(SEED, small, CHECK_SHAPE, 8.0, 8.0),
    }
    torch.save({k: (v.cpu() if isinstance(v, torch.Tensor)
                    else torch.stack(v).cpu()) for k, v in out.items()},
               os.path.join(out_dir, f"{tag}.pt"))
    with open(os.path.join(out_dir, f"{tag}.json"), "w") as fh:
        json.dump({"ms": ms, "b2b": b2b, "clock": clock, "power": power,
                   "sass": sass, "digests": digests,
                   "jax": "jax" in sys.modules}, fh)


def main(ref):
    import tempfile

    sys.path.insert(0, HERE)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with tempfile.TemporaryDirectory(prefix="rf_turns_") as tmp:
        _turns(ref, tmp, card)


def _turns(ref, tmp, card):
    """The four turns, their files in ``tmp``, and what they print."""
    import torch

    turns = [("ref", ref), ("this", HERE), ("this", HERE), ("ref", ref)]
    results = []
    for i, (side, root) in enumerate(turns):
        tag = f"{i}_{side}"
        subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                        os.path.abspath(root), tmp, tag], check=True,
                       timeout=900)
        with open(os.path.join(tmp, f"{tag}.json")) as fh:
            res = json.load(fh)
        if res["jax"]:
            raise RuntimeError("a worker imported JAX")
        results.append((side, res))
        print(f"turn {i} {side}: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in res["ms"].items()) + "; back to "
            "back " + ", ".join(f"{k} {v:.3f} ms"
                                for k, v in res["b2b"].items())
            + f"; SM clock {res['clock'][0]:.0f}-{res['clock'][1]:.0f} MHz, "
            f"power {res['power']:.1f} W", flush=True)
    for key, how in (("ms", "single"), ("b2b", "back to back")):
        for kid in results[0][1][key]:
            ref_ms = [r[key][kid] for s, r in results if s == "ref"]
            new_ms = [r[key][kid] for s, r in results if s == "this"]
            print(f"{kid} at {HEADLINE}, {how}: this "
                  f"{statistics.mean(new_ms):.3f} ms "
                  f"({', '.join(f'{t:.3f}' for t in new_ms)}), ref "
                  f"{statistics.mean(ref_ms):.3f} ms "
                  f"({', '.join(f'{t:.3f}' for t in ref_ms)}), this / ref "
                  f"{statistics.mean(new_ms) / statistics.mean(ref_ms):.4f} "
                  f"[{card}]", flush=True)
    for side, res in results[:2]:
        for kid, (regs, span, hot, hashes, per_mode) in res["sass"].items():
            print(f"{side} {kid} SASS: {regs} registers a thread, loop body "
                  f"{span} instructions, {hot} outside its cold paths, for "
                  f"{hashes} hash(es): {per_mode:.1f} a mode", flush=True)
    ref_sass, new_sass = results[0][1]["digests"], results[1][1]["digests"]
    moved = sorted(f for f in set(ref_sass) | set(new_sass)
                   if ref_sass.get(f) != new_sass.get(f))
    same = sum(1 for f in new_sass if ref_sass.get(f) == new_sass[f])
    print(f"SASS: {len(ref_sass)} kernels in ref, {len(new_sass)} here, "
          f"{same} identical; differ, new or gone: "
          f"{', '.join(moved) or 'none'}", flush=True)

    ref_out = torch.load(os.path.join(tmp, "0_ref.pt"))
    new_out = torch.load(os.path.join(tmp, "1_this.pt"))
    same = {k: torch.equal(new_out[k], ref_out[k]) for k in ref_out}
    k10 = (new_out["k10"] - ref_out["k10"]).abs().max() / ref_out["k10"].abs().max()
    print(f"at {CHECK_SHAPE}, this vs ref: " + ", ".join(
        f"{k} {'bit-equal' if v else 'DIFFERENT'}" for k, v in same.items()
        if k != "k10") + f"; k10 max|d| / max|ref| {float(k10):.3e} (bar "
        f"{K10_BAR:g})", flush=True)
    if not all(v for k, v in same.items() if k != "k10") or not k10 <= K10_BAR:
        raise SystemExit("this checkout's draws moved from REF's")


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--worker":
        worker(*sys.argv[2:])
    elif len(sys.argv) == 2:
        main(sys.argv[1])
    else:
        sys.exit(__doc__)
