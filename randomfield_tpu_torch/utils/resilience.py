"""Failure detection and elastic recovery for long-running workflows.

Port of ``randomfield_tpu/utils/resilience.py``.  Fields regenerate from
seeds, so the durable state of an ensemble is its small binned-spectrum
checkpoint (:func:`..validate.ensemble.sample_power_ensemble`, whose
fingerprint records the physics of a row and not the topology), and
recovery is

    classify the failure  ->  bounded retry with a REBUILT generator
                          ->  resume from the checkpoint.

Classification is conservative.  The JAX package's tables stay as they
are (its status codes and prose markers); on top of them, what this
runtime raises:

* ``torch.cuda.OutOfMemoryError`` is fatal, as RESOURCE_EXHAUSTED is: the
  same call asks for the same memory again;
* ``RuntimeError("CUDA error: ...")`` is fatal: an illegal address or a
  launch failure poisons the process's CUDA context, so no retry inside
  the process can succeed (the job must be relaunched);
* ``torch.distributed.DistBackendError`` and NCCL's own failure texts (a
  watchdog timeout, an aborted communicator, ``ncclRemoteError``,
  ``ncclSystemError``) are transient: a peer or the network failed.

Unknown errors stay fatal, so a new deterministic failure can never spin
the retry loop.
"""

from __future__ import annotations

import time

import torch

__all__ = [
    "classify_failure",
    "retry_transient",
    "resilient_sample_power_ensemble",
]

# gRPC-ish status codes + infrastructure markers that indicate the WORLD
# failed (retryable), not the program.  Checked case-sensitively for
# codes, case-insensitively for prose markers.
TRANSIENT_CODES = (
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "CANCELLED",
)
TRANSIENT_MARKERS = (
    "connection reset",
    "connection refused",
    "failed to connect",
    "socket closed",
    "broken pipe",
    "preempt",
    "device halted",
    "network error",
    "heartbeat",
)
# Deterministic failures: retrying reproduces them.
FATAL_CODES = (
    "INVALID_ARGUMENT",
    "RESOURCE_EXHAUSTED",
    "UNIMPLEMENTED",
    "FAILED_PRECONDITION",
    "OUT_OF_RANGE",
)
# NCCL's texts for a collective that a peer or the network broke
NCCL_TRANSIENT_MARKERS = (
    "Watchdog caught collective operation timeout",
    "NCCL communicator was aborted",
    "ncclRemoteError",
    "ncclSystemError",
)
# the prefix of every CUDA runtime error torch raises
CUDA_ERROR = "CUDA error:"


def classify_failure(exc):
    """'transient' (retry with a rebuilt generator) or 'fatal' (re-raise).

    Plain Python errors (ValueError, TypeError, KeyError, ...) are the
    caller's bug: always fatal.  Then this runtime's classes and texts
    (see the module docstring), then the JAX package's status codes and
    markers; unknown runtime errors are fatal.
    """
    if isinstance(exc, (ValueError, TypeError, KeyError, AttributeError,
                        IndexError, ZeroDivisionError)):
        return "fatal"
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return "fatal"
    text = str(exc)
    if isinstance(exc, torch.distributed.DistBackendError) or any(
            marker in text for marker in NCCL_TRANSIENT_MARKERS):
        return "transient"
    if CUDA_ERROR in text:
        return "fatal"
    for code in FATAL_CODES:
        if code in text:
            return "fatal"
    for code in TRANSIENT_CODES:
        if code in text:
            return "transient"
    low = text.lower()
    for marker in TRANSIENT_MARKERS:
        if marker in low:
            return "transient"
    if isinstance(exc, (ConnectionError, TimeoutError, OSError)):
        return "transient"
    return "fatal"


def retry_transient(fn, max_retries=3, base_delay_s=1.0, reinit=None,
                    classify=classify_failure, on_retry=None):
    """Run ``fn()`` with bounded retries on transient failures.

    Between attempts: the CUDA caching allocator returns its free blocks
    (a failed attempt's buffers), ``reinit()`` runs if given (rebuild
    generators, re-join the process group), and the delay backs off
    exponentially from ``base_delay_s``.  Fatal failures and retry
    exhaustion re-raise the original exception.  ``on_retry(attempt,
    exc)`` observes each retry.  Returns ``fn()``'s value.
    """
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as exc:  # noqa: BLE001 — classified below
            if classify(exc) != "transient" or attempt >= int(max_retries):
                raise
            attempt += 1
            if on_retry is not None:
                on_retry(attempt, exc)
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            if reinit is not None:
                reinit()
            if base_delay_s > 0:
                time.sleep(float(base_delay_s) * 2.0 ** (attempt - 1))


def resilient_sample_power_ensemble(generator_factory, seeds,
                                    smoothing_length=0.0, nbins=32,
                                    checkpoint_path=None,
                                    checkpoint_every=16, max_restarts=3,
                                    base_delay_s=1.0, on_retry=None):
    """Elastic, fault-tolerant P(k) ensemble.

    ``generator_factory`` is a zero-argument callable returning a fresh
    ``Generator``, called once per (re)start so every retry gets a clean
    scene (passing a Generator instance works too, without the rebuild).
    ``checkpoint_path`` is required: it bounds the recomputation a failure
    costs to ``checkpoint_every`` seeds, and its fingerprint is
    topology-free, so a restart may use another mesh.  Transient failures
    restart up to ``max_restarts`` times; fatal ones re-raise at once.
    Returns ``(k_mean, p_hat, n_modes)`` as
    :func:`randomfield_tpu_torch.validate.ensemble.sample_power_ensemble`.
    """
    from randomfield_tpu_torch.validate.ensemble import sample_power_ensemble

    if checkpoint_path is None:
        raise ValueError(
            "resilient_sample_power_ensemble requires checkpoint_path: "
            "without it a restart would recompute every seed, which is "
            "plain retry_transient(sample_power_ensemble), not recovery."
        )
    if callable(generator_factory):
        factory = generator_factory
    else:
        g = generator_factory
        factory = lambda: g  # noqa: E731 — documented degraded mode

    def run():
        return sample_power_ensemble(
            factory(), seeds, smoothing_length=smoothing_length,
            nbins=nbins, checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every,
        )

    return retry_transient(
        run, max_retries=max_restarts, base_delay_s=base_delay_s,
        on_retry=on_retry,
    )
