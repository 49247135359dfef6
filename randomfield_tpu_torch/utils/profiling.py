"""Profiling hooks.

Port of ``randomfield_tpu/utils/profiling.py``: where the JAX package
captures ``jax.profiler`` traces, :func:`trace` records
``torch.profiler`` (host and CUDA activity) and writes a Chrome trace
(``chrome://tracing``, Perfetto) into its directory; the kernels appear
under their ``__global__`` names.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

__all__ = ["trace", "annotate"]


@contextlib.contextmanager
def trace(log_dir=None):
    """Capture a host and device trace around a block:

        with profiling.trace("traces") as log_dir:
            gen.generate_delta_field(0)

    The block's CUDA work is synchronized before the trace stops; the
    trace is ``log_dir/trace_<pid>_<ns>.json``.  ``log_dir`` defaults to
    ``randomfield_tpu_torch_trace`` in the temporary directory
    (``TMPDIR``).
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(),
                               "randomfield_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name):
    """Named region inside a trace (context manager)."""
    return torch.profiler.record_function(name)
