"""The port's failure classification and recovery
(randomfield_tpu_torch.utils.resilience) against the JAX package's.

* every case of tests/test_resilience.py::test_classify_failure gets the
  same verdict from both packages;
* what torch, CUDA and NCCL raise: out of memory and CUDA errors are
  fatal, distributed backend errors and NCCL's collective failures
  transient, unknown errors fatal;
* retries rebuild through ``reinit`` and give up on fatal errors or after
  ``max_retries``;
* a checkpointed ensemble interrupted by a transient failure resumes and
  equals the uninterrupted run bit for bit; a fatal error propagates.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

from randomfield_tpu.utils import resilience as jrz  # noqa: E402

import randomfield_tpu_torch as rft  # noqa: E402
from randomfield_tpu_torch.utils import resilience as rz  # noqa: E402
from randomfield_tpu_torch.validate.ensemble import (  # noqa: E402
    sample_power_ensemble)


class _FakeRuntimeError(RuntimeError):
    pass


# tests/test_resilience.py::test_classify_failure, case for case
JAX_CASES = [
    (_FakeRuntimeError("UNAVAILABLE: socket closed"), "transient"),
    (_FakeRuntimeError("DEADLINE_EXCEEDED: heartbeat"), "transient"),
    (ConnectionResetError("peer reset"), "transient"),
    (_FakeRuntimeError("slice 0 preempted"), "transient"),
    (ValueError("bad power table"), "fatal"),
    (_FakeRuntimeError("RESOURCE_EXHAUSTED: out of memory allocating 8.0G"),
     "fatal"),
    (_FakeRuntimeError("INVALID_ARGUMENT: shapes"), "fatal"),
    (_FakeRuntimeError("UNIMPLEMENTED: complex transfer"), "fatal"),
    (_FakeRuntimeError("weird new failure"), "fatal"),
]

TORCH_CASES = [
    (torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 80.00 GiB"), "fatal"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "fatal"),
    (RuntimeError("CUDA error: unspecified launch failure"), "fatal"),
    (torch.distributed.DistBackendError("NCCL error in: ...: unhandled "
                                        "system error"), "transient"),
    (RuntimeError("[Rank 1] Watchdog caught collective operation timeout: "
                  "WorkNCCL(SeqNum=7, OpType=ALLTOALL_BASE)"), "transient"),
    (RuntimeError("NCCL communicator was aborted on rank 0."), "transient"),
    (RuntimeError("NCCL error: remote process exited or there was a "
                  "network error, NCCL version 2.21.5 ncclRemoteError"),
     "transient"),
    (RuntimeError("ncclSystemError: System call (e.g. socket, malloc) or "
                  "external library call failed"), "transient"),
    (RuntimeError("a new torch failure"), "fatal"),
]


@pytest.mark.parametrize("exc, verdict", JAX_CASES,
                         ids=[str(e) for e, _ in JAX_CASES])
def test_classify_failure_matches_jax(exc, verdict):
    assert jrz.classify_failure(exc) == verdict
    assert rz.classify_failure(exc) == verdict


@pytest.mark.parametrize("exc, verdict", TORCH_CASES,
                         ids=[str(e)[:40] for e, _ in TORCH_CASES])
def test_classify_torch_and_nccl_failures(exc, verdict):
    assert rz.classify_failure(exc) == verdict


def test_retry_transient_recovers_and_reinits():
    calls = {"n": 0, "reinit": 0, "retries": []}

    def fn():
        calls["n"] += 1
        if calls["n"] < 3:
            raise torch.distributed.DistBackendError("NCCL timeout")
        return "ok"

    out = rz.retry_transient(
        fn, max_retries=3, base_delay_s=0.0,
        reinit=lambda: calls.__setitem__("reinit", calls["reinit"] + 1),
        on_retry=lambda a, e: calls["retries"].append(a),
    )
    assert out == "ok"
    assert calls == {"n": 3, "reinit": 2, "retries": [1, 2]}


def test_retry_transient_fatal_and_exhaustion():
    n = {"oom": 0, "down": 0}

    def oom():
        n["oom"] += 1
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    with pytest.raises(torch.cuda.OutOfMemoryError):
        rz.retry_transient(oom, max_retries=5, base_delay_s=0.0)
    assert n["oom"] == 1  # raised on the first try

    def always_down():
        n["down"] += 1
        raise _FakeRuntimeError("ABORTED: collective")

    with pytest.raises(_FakeRuntimeError):
        rz.retry_transient(always_down, max_retries=2, base_delay_s=0.0)
    assert n["down"] == 3  # initial + 2 retries


def test_resilient_ensemble_resumes_bit_equal(tmp_path, monkeypatch):
    """A transient failure mid-ensemble: the restart rebuilds the
    Generator, skips the checkpointed rows and gives the uninterrupted
    run's result bit for bit."""
    n, sp = 16, 8.0
    seeds = list(range(10))

    def factory():
        built.append(1)
        return rft.Generator(n, n, n, grid_spacing=sp, device="cpu")

    built = []
    k_ref, p_ref, m_ref = sample_power_ensemble(
        factory(), seeds, nbins=8, checkpoint_path=tmp_path / "ref.npz",
        checkpoint_every=4)

    real_batch = rft.Generator.sample_power_batch
    state = {"calls": 0}

    def flaky_batch(self, *a, **kw):
        state["calls"] += 1
        if state["calls"] == 2:  # after one checkpointed chunk
            raise RuntimeError("NCCL communicator was aborted on rank 1.")
        return real_batch(self, *a, **kw)

    monkeypatch.setattr(rft.Generator, "sample_power_batch", flaky_batch)
    built.clear()
    retries = []
    k, p, m = rz.resilient_sample_power_ensemble(
        factory, seeds, nbins=8, checkpoint_path=tmp_path / "ens.npz",
        checkpoint_every=4, max_restarts=2, base_delay_s=0.0,
        on_retry=lambda a, e: retries.append(str(e)))
    assert len(built) == 2  # a fresh scene per (re)start
    assert len(retries) == 1 and "aborted" in retries[0]
    np.testing.assert_array_equal(k, k_ref)
    np.testing.assert_array_equal(p, p_ref)
    np.testing.assert_array_equal(m, m_ref)
    # one chunk before the failure, the failure, two chunks after it
    assert state["calls"] == 4


def test_resilient_ensemble_fatal_propagates(tmp_path):
    def factory():
        return rft.Generator(16, 16, 16, grid_spacing=8.0, device="cpu")

    sample_power_ensemble(factory(), [0, 1], nbins=8,
                          checkpoint_path=tmp_path / "a.npz",
                          checkpoint_every=2)
    g2 = rft.Generator(16, 16, 16, grid_spacing=4.0, device="cpu")
    tries = []

    def other_scene():
        tries.append(1)
        return g2

    with pytest.raises(ValueError, match="different scene"):
        # a checkpoint of another scene: fatal, no retry
        rz.resilient_sample_power_ensemble(
            other_scene, [0, 1], nbins=8, checkpoint_path=tmp_path / "a.npz",
            base_delay_s=0.0)
    assert len(tries) == 1
    with pytest.raises(ValueError, match="checkpoint_path"):
        rz.resilient_sample_power_ensemble(factory, [0, 1], nbins=8,
                                           checkpoint_path=None)
