"""Timing helpers.

Port of ``randomfield_tpu/utils/timing.py``.  CUDA launches return before
the card has run them, so a host clock means something only after a
synchronize; :func:`block_and_time` does that for every CUDA tensor in
the result, where the JAX package calls ``jax.block_until_ready``.
"""

from __future__ import annotations

import time

import torch

__all__ = ["Timer", "block_and_time"]


class Timer:
    """Context manager: ``with Timer('stage', verbose=True) as t: ...``."""

    def __init__(self, label="", verbose=False):
        self.label = label
        self.verbose = verbose
        self.elapsed = float("nan")

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.verbose:
            print(f"[randomfield_tpu_torch] {self.label}: "
                  f"{self.elapsed * 1e3:.1f} ms")
        return False


def _cuda_devices(out, found):
    """Collect the devices of the CUDA tensors in ``out`` (tensors, and
    tuples, lists and dict values of them) into ``found``."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for item in out:
            _cuda_devices(item, found)
    elif isinstance(out, dict):
        for item in out.values():
            _cuda_devices(item, found)
    return found


def block_and_time(fn, *args, iters=1, **kwargs):
    """Run ``fn`` ``iters`` times, waiting for the card's work on each
    result's CUDA tensors; return (best seconds, last result).  A result
    on the CPU needs no wait."""
    out = None
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        for device in _cuda_devices(out, set()):
            torch.cuda.synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best, out
