"""Build the port's CUDA kernels into one shared library and load it.

At first use, ``nvcc`` compiles every ``randomfield_tpu_torch/csrc/*.cu``
for ``sm_90a`` (one ``nvcc`` per source, all started together) and links
the objects into one ``.so`` with a plain C interface, which ``ctypes``
loads.  No PyTorch header is compiled, so the build takes seconds.  The
library's file name carries a hash of the sources and flags, so an edit
rebuilds and an unchanged tree reuses the earlier build.  Processes that
start together (the ranks of a mesh) build once: a lock file beside the
library serializes them, and the build lands by an atomic rename.

The build directory is ``build/randomfield_tpu_torch/`` beside the package
(listed in ``.gitignore``), or ``$RF_TORCH_BUILD_DIR``.  ``nvcc`` is
``$NVCC``, else the one on ``PATH``, else ``$CUDA_HOME/bin/nvcc``, else
``/usr/local/cuda/bin/nvcc``.

Every C entry returns the CUDA error of its launch; :func:`check` raises
on a non-zero one.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

__all__ = ["library", "library_path", "cuda_tool", "check",
           "current_stream", "NVCC_FLAGS"]

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIB = None

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_D = ctypes.c_double
_U32 = ctypes.c_uint32
_SIGNATURES = {
    "rf_scale_sigma": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                       _F, _F, _F, _F, _F, _F, _F, _F, _P],
    "rf_draw_scale": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                      _F, _F, _F, _F, _F, _F, _F, _F, _I, _P],
    "rf_fft_axis": [_P, _P, _P, _I, _I, _I, _LL, _I, _I, _I, _I, _P],
    "rf_fft_axis_attributes": [_I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "rf_fft_rotate": [_P, _P, _P, _P, _P, _I, _I, _LL, _I, _I, _I, _I, _P],
    "rf_fft_rotate_attributes": [_I, _I, _I, _I, _I, _P, _P, _P, _P],
    "rf_r2c_head": [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P],
    "rf_r2c_head_attributes": [_I, _I, _I, _I, _P, _P, _P, _P],
    "rf_c2r_tail": [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P],
    "rf_c2r_tail_attributes": [_I, _I, _I, _I, _I, _P, _P, _P, _P],
    "rf_sample_modes": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _U32, _U32,
                        _F, _F, _F, _F, _F, _F, _F, _P],
    "rf_sample_nested": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _U32, _U32,
                         _F, _F, _F, _F, _F, _F, _F, _F, _I, _P],
    "rf_spectral_kernel": [_P, _P, _I, _I, _I, _I, _I, _D, _D, _D, _I, _I,
                           _I, _I,
                           _F, _F, _F, _F, _P],
    "rf_sample_fftx": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                       _U32, _U32, _F, _F, _F, _F, _F, _F, _F, _P],
    "rf_sample_fftx_attributes": [_I, _I, _I, _I, _I, _P, _P, _P, _P],
    "rf_jax_normal": [_P, _P, _LL, _P],
    "rf_unit_phase": [_P, _P, _P, _P, _LL, _P],
    "rf_sigma_steps": [_P, _P, _I, _LL, _F, _F, _F, _F, _F, _P, _P, _P, _P,
                       _P, _P],
    "rf_bin_spectrum": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _F, _P],
    "rf_bin_spectrum_plan": [_I, _I, _I, _I, _I, _I, _I, _I, _P],
    "rf_paint_count": [_P, _LL, _I, _I, _I, _F, _F, _I, _I, _I, _I, _I,
                       _P, _P],
    "rf_paint_deposit": [_P, _P, _F, _LL, _I, _I, _I, _F, _F, _D, _I, _I,
                         _I, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P],
    "rf_paint_contrast": [_P, _P, _LL, _D, _D, _P],
    "rf_constraint_measure": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _F, _I, _I, _I, _P],
    "rf_constraint_correct": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _F, _I, _I, _P],
    "rf_constraint_plan": [_I, _I, _I, _I, _I, _I, _I, _P],
    "rf_sample_power_bins": [_P, _P, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I,
                             _F, _F, _F, _F, _F, _F, _F, _F, _I, _P],
    "rf_extrema_peaks": [_P, _P, _I, _P, _P, _I, _I, _I, _F, _F, _F, _F, _I,
                         _I, _P],
    "rf_extrema_voids": [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _P],
    "rf_extrema_attributes": [_I, _I, _I, _P, _P, _P, _P],
    "rf_minkowski_plan": [_I, _LL, _P],
    "rf_pair_cells": [_P, _LL, _I, _I, _I, _D, _D, _D, _D, _D, _D, _P, _P,
                      _P],
    "rf_pair_scatter": [_P, _LL, _P, _P, _P, _P],
    "rf_pair_counts": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _LL, _P, _P,
                       _I, _F, _F, _F, _I, _I, _I, _I, _I, _I, _I, _D, _I,
                       _P, _P, _P, _P],
    "rf_pair_counts_attributes": [_I, _I, _I, _I, _P, _P, _P, _P],
    "rf_poisson_counts": [_P, _P, _LL, _I, _I, _P, _P, _I, _P, _P, _LL,
                          _I, _I, _P, _P],
    "rf_poisson_attributes": [_I, _P, _P, _P],
    "rf_minkowski_bins": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                          _LL, _P, _P, _P, _P, _P],
}


def build_dir() -> pathlib.Path:
    env = os.environ.get("RF_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return CSRC.parent.parent / "build" / "randomfield_tpu_torch"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 cuda_home and os.path.join(cuda_home, "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set NVCC or CUDA_HOME): the CUDA kernels of "
        "randomfield_tpu_torch are built from source at first use"
    )


def _sources() -> list[pathlib.Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build() -> pathlib.Path:
    out = build_dir() / f"rf_kernels_{_source_hash()}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_name(f"{out.name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not out.exists():
            _compile(out)
    return out


def _compile(out: pathlib.Path) -> None:
    nvcc = _nvcc()
    work = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    work.mkdir()
    try:
        # one nvcc per source, all at once; then one link
        jobs = []
        for src in _sources():
            if src.suffix == ".cu":
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o",
                       str(work / f"{src.stem}.o"), str(src)]
                jobs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
        results = [(cmd, proc.communicate()[0], proc.returncode)
                   for cmd, proc in jobs]
        lib = work / out.name
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib),
                *(cmd[-2] for cmd, _ in jobs)]
        if not any(rc for _, _, rc in results):
            proc = subprocess.run(link, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            results.append((link, proc.stdout, proc.returncode))
        failed = [(cmd, log, rc) for cmd, log, rc in results if rc]
        if failed:
            raise RuntimeError("\n".join(
                f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{log}"
                for cmd, log, rc in failed))
        os.replace(lib, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _declare(lib):
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.rf_error_string.argtypes = [ctypes.c_int]
    lib.rf_error_string.restype = ctypes.c_char_p
    return lib


def library():
    """The loaded kernel library, built on the first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _declare(ctypes.CDLL(str(_build())))
        return _LIB


def library_path() -> pathlib.Path:
    """The kernel library's file, built on the first call."""
    return _build()


def cuda_tool(name: str) -> str:
    """A program of the CUDA toolkit that holds nvcc (``cuobjdump``...)."""
    return str(pathlib.Path(_nvcc()).parent / name)


def check(status: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if status:
        msg = library().rf_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status}: {msg}")


def current_stream(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as a handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
