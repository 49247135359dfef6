"""Join this process to a group of SPMD ranks (``torch.distributed``).

Port of ``randomfield_tpu/parallel/multihost.py``.  JAX spans processes
with ``jax.distributed.initialize`` and one global program; the port runs
one process per device, every one calling the same functions on its own
shard, and :func:`initialize` is the one call each rank makes first:

* on GPUs, the NCCL backend with one GPU per rank: under ``torchrun`` call
  ``initialize()`` with no arguments (it reads ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT``); under
  ``torch.multiprocessing.spawn`` pass ``init_method`` (``tcp://host:port``
  or ``file:///path``), ``world_size``, ``rank`` and ``device``;
* on CPUs, the gloo backend with ``device='cpu'`` (how the tests run meshes).

Then :func:`.mesh.make_mesh` gives the rank its :class:`.mesh.SlabMesh`.
"""

from __future__ import annotations

import os

import torch

__all__ = ["initialize", "shutdown"]


def initialize(backend="nccl", init_method=None, world_size=None, rank=None,
               device=None) -> torch.device:
    """``torch.distributed.init_process_group`` for one rank; returns its
    device.

    Unset arguments come from the environment ``torchrun`` sets
    (``init_method='env://'``).  ``device`` defaults to ``cuda:LOCAL_RANK``
    for NCCL and to the CPU for gloo; a CUDA device becomes the process's
    current device, so each rank's kernels launch on its own card.
    """
    import torch.distributed as dist

    if init_method is None:
        init_method = "env://"
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if device is None:
        device = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
                  if backend == "nccl" else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(world_size), rank=int(rank))
    return device


def shutdown() -> None:
    """Leave the process group (``destroy_process_group``), if joined."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
