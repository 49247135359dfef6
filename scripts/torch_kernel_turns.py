#!/usr/bin/env python3
"""Time the port's hashing kernels against another checkout's, in turns.

On a machine with one CUDA card, from the repository root, with REF another
commit unpacked by ``git archive`` into a directory ``.gitignore`` lists:

    mkdir -p build/ref && git archive <commit> | tar -x -C build/ref
    python3 scripts/torch_kernel_turns.py build/ref

Four worker processes run one after another, REF, this checkout, this
checkout, REF; each imports its own checkout's ``randomfield_tpu_torch``,
builds its kernels, counts the SASS of the hashing kernels' per-mode loops
(``chip_smoke.sass_counts``: registers, loop instructions, instructions a
mode) and times with CUDA events (median of 5 after a warm-up) at 1024^3,
2 Mpc/h, seed 2, through the public wrappers: K1 ``sample_modes``, K8
``sample_shard`` on the second of four ky shards, K5 ``sample_power_bins``
(one seed, 32 bins), and K2F ``draw_scale`` and K7
``draw_scale_shard`` (the second of four shards) as controls.  The workers also
save K1's and K2F's spectra and K5's sums at 256^3; the parent process
holds this checkout's K1 to REF's K1 with the plane fix after it, its K5 to
REF's K5 with the planes binned after it, where REF leaves them to the
caller, and its K2F to REF's bit for bit.
Prints each kernel's two turns a side and their means with the card's name
and power limit.
It never imports JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

HEADLINE, SPACING, SEED, NBINS = (1024, 1024, 1024), 2.0, 2, 32
CHECK_SHAPE = (256, 256, 256)
REPS = 5
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


def worker(root, out_dir, tag):
    """One turn: the kernels of the checkout at ``root``."""
    import importlib.util

    sys.path.insert(0, root)
    import torch

    import randomfield_tpu_torch as rft
    from randomfield_tpu_torch.ops import _build, sampler
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
    dev = torch.device("cuda", 0)
    table = sampler.make_sigma_table(rft.load_default_power(), HEADLINE,
                                     SPACING, device=dev)
    edges, _ = stats.bin_setup(HEADLINE, SPACING, NBINS)
    ny_loc = HEADLINE[1] // RANKS
    runs = {
        "K1": lambda: sampler.sample_modes(SEED, table, HEADLINE, SPACING),
        "K8": lambda: sampler.sample_shard(SEED, table, HEADLINE, SPACING,
                                           0.0, ny_loc, ny_loc),
        "K5": lambda: sampler.sample_power_bins(SEED, table, HEADLINE,
                                                SPACING, 0.0, edges),
        "K2F": lambda: sampler.draw_scale(SEED, table, HEADLINE, SPACING),
        "K7": lambda: sampler.draw_scale_shard(SEED, table, HEADLINE, SPACING,
                                               0.0, ny_loc, ny_loc),
    }
    ms = {k: cuda_ms(torch, fn) for k, fn in runs.items()}
    small = sampler.make_sigma_table(rft.load_default_power(), CHECK_SHAPE,
                                     8.0, device=dev)
    k1 = sampler.sample_modes(SEED, small, CHECK_SHAPE, 8.0, 8.0)
    edges, _ = stats.bin_setup(CHECK_SHAPE, 8.0, NBINS)
    k5 = sampler.sample_power_bins(SEED, small, CHECK_SHAPE, 8.0, 8.0, edges)
    k2f = sampler.draw_scale(SEED, small, CHECK_SHAPE, 8.0, 8.0)
    torch.save({"k1": tuple(t.cpu() for t in k1), "k2f": k2f.cpu(),
                "k5": (k5.cpu() if isinstance(k5, torch.Tensor)
                       else tuple(t.cpu() for t in k5))},
               os.path.join(out_dir, f"{tag}.pt"))
    with open(os.path.join(out_dir, f"{tag}.json"), "w") as fh:
        json.dump({"ms": ms, "sass": sass,
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

    from randomfield_tpu_torch.ops import transform
    from randomfield_tpu_torch.validate import stats

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
            f"{k} {v:.3f} ms" for k, v in res["ms"].items()), flush=True)
    for kid in results[0][1]["ms"]:
        ref_ms = [r["ms"][kid] for s, r in results if s == "ref"]
        new_ms = [r["ms"][kid] for s, r in results if s == "this"]
        print(f"{kid} at {HEADLINE}: this {statistics.mean(new_ms):.3f} ms "
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

    ref_out = torch.load(os.path.join(tmp, "0_ref.pt"))
    new_out = torch.load(os.path.join(tmp, "1_this.pt"))
    old_re, old_im = (t.clone() for t in ref_out["k1"])
    if not isinstance(ref_out["k5"], torch.Tensor):  # raw planes: fix them
        old_re, old_im = transform.symmetrize_with_shape_reim(
            old_re, old_im, CHECK_SHAPE[2])
        acc, pre, pim = ref_out["k5"]
        ref_k5 = acc + stats.plane_bins(pre, pim, CHECK_SHAPE, 8.0, NBINS)
    else:
        ref_k5 = ref_out["k5"]
    re, im = new_out["k1"]
    d = max(float((re - old_re).abs().max()), float((im - old_im).abs().max()))
    same = torch.equal(re, old_re) and torch.equal(im, old_im)
    k5 = new_out["k5"]
    live = ref_k5[0] > 0
    rel = float(((k5[1:] - ref_k5[1:]).abs() / ref_k5[1:].abs())[:, live].max())
    k2f_same = torch.equal(new_out["k2f"], ref_out["k2f"])
    print(f"K1 {CHECK_SHAPE} s=8: this vs ref with the plane fix "
          f"{'bit-equal' if same else f'max|d| {d:.3e}'}; K5: counts "
          f"{'equal' if torch.equal(k5[0], ref_k5[0]) else 'DIFFER'}, sums "
          f"max rel {rel:.3e}; K2F: "
          f"{'bit-equal' if k2f_same else 'DIFFERENT'}", flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--worker":
        worker(*sys.argv[2:])
    elif len(sys.argv) == 2:
        main(sys.argv[1])
    else:
        sys.exit(__doc__)
