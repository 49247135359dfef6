"""Slab meshes over ``torch.distributed`` process groups.

Port of ``randomfield_tpu/parallel/mesh.py``.  The JAX package builds a
('data', 'space') device mesh and lets ``shard_map`` run one program over
it; the port runs SPMD processes instead, one per device, each calling the
same functions on its own shard (:mod:`.multihost` joins them).  A
:class:`SlabMesh` is what those functions need to know: the process group,
this rank, the 'space' size P and this rank's device.

The layout is the JAX package's (``parallel/dfft.py``):

* the packed spectrum is 'xyz' ``(nx, ny/P, nz/2+1)``, sharded along ky;
* the field is ``(nx/P, ny, nz)``, sharded along x.

Each rank holds its slab as a plain tensor on its device.  The collectives
every mesh path needs are methods here; a one-rank mesh skips them, and
needs no process group at all.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["SlabMesh", "PencilMesh", "make_mesh", "make_pencil_mesh",
           "require_slab", "check_divisible"]

_ROADMAP = "(ROADMAP.md, Queue 1 item 5)"


@dataclasses.dataclass(frozen=True)
class SlabMesh:
    """One rank's view of a slab ('space') mesh of ``size`` ranks.

    ``group`` is the ``torch.distributed`` process group of the ranks, or
    None for a one-rank mesh without one.
    """

    group: object
    rank: int
    size: int
    device: torch.device

    def rows(self, n: int) -> tuple[int, int]:
        """(offset, count) of this rank's block of an axis of length n."""
        count = n // self.size
        return self.rank * count, count

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Block r of ``t``'s leading axis to rank r; returns the blocks
        received, in rank order along the leading axis."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(), group=self.group)
        return out

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t``, concatenated in rank order along ``dim``."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, in place; returns ``t``."""
        if self.size > 1:
            import torch.distributed as dist

            dist.all_reduce(t, group=self.group)
        return t

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``t`` over the ranks, in place;
        returns ``t``."""
        if self.size > 1:
            import torch.distributed as dist

            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def ring_exchange(self, to_prev: torch.Tensor, to_next: torch.Tensor):
        """The periodic neighbour exchange of a ring: ``to_prev`` goes to
        rank - 1 and ``to_next`` to rank + 1 (mod size); returns
        (``to_prev`` of rank + 1, ``to_next`` of rank - 1).  Both tensors
        have one shape.  One ``all_to_all`` whose other blocks are empty;
        on one rank the two tensors come back swapped."""
        if self.size == 1:
            return to_prev, to_next
        import torch.distributed as dist

        n, p, r = to_prev.numel(), self.size, self.rank
        prev, nxt = (r - 1) % p, (r + 1) % p
        send, send_splits, recv_splits = [], [], []
        for d in range(p):  # to rank d: to_prev first, then to_next
            blocks = ([to_prev] if d == prev else []) + (
                [to_next] if d == nxt else [])
            send += [b.reshape(-1) for b in blocks]
            send_splits.append(n * len(blocks))
            recv_splits.append(n * ((d == nxt) + (d == prev)))
        out = torch.empty(sum(recv_splits), dtype=to_prev.dtype,
                          device=to_prev.device)
        dist.all_to_all_single(out, torch.cat(send), recv_splits,
                               send_splits, group=self.group)
        got, at = {}, 0
        for s in range(p):  # from rank s, in the order it sent them
            if s == nxt:
                got["next"] = out[at:at + n].view(to_prev.shape)
                at += n
            if s == prev:
                got["prev"] = out[at:at + n].view(to_prev.shape)
                at += n
        return got["next"], got["prev"]


def check_divisible(shape, size):
    """Raise ValueError unless a slab mesh of ``size`` ranks splits the grid
    (``parallel/dfft.py:_check_divisible``)."""
    nx, ny, _ = shape
    if nx % size or ny % size:
        raise ValueError(
            f"slab decomposition needs nx ({nx}) and ny ({ny}) divisible by "
            f"the 'space' mesh axis size ({size})"
        )


def make_mesh(data=1, space=None, group=None, device=None) -> SlabMesh:
    """This rank's slab mesh over ``group`` (the default group by default).

    ``space`` is the number of ranks the grid is split over; it must equal
    the group's size (None takes it).  Without an initialized process group
    the mesh is this process alone, ``space`` 1.  ``device`` is the rank's
    device: by default the current CUDA device (:func:`.multihost.initialize`
    sets it per rank).  ``data > 1`` raises NotImplementedError: the
    seed-parallel axis is not ported yet.
    """
    if data != 1:
        raise NotImplementedError(
            f"a 'data' mesh axis (data={data}) is not ported to "
            f"randomfield_tpu_torch yet: seed-parallel meshes follow the slab "
            f"mesh {_ROADMAP}")
    import torch.distributed as dist

    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        rank, size = 0, 1
    else:
        rank, size = dist.get_rank(group), dist.get_world_size(group)
    if space is not None and int(space) != size:
        raise ValueError(f"space={space}, but the process group has {size} "
                         f"rank(s): a slab mesh puts one shard on each rank")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return SlabMesh(group=group, rank=rank, size=size,
                    device=torch.device(device))


@dataclasses.dataclass(frozen=True)
class PencilMesh:
    """A ('data', 'spx', 'spy') pencil mesh request: every entry point
    refuses it (:func:`require_slab`) until the pencil path is ported."""

    data: int
    spx: int
    spy: int


def make_pencil_mesh(data=1, spx=1, spy=1) -> PencilMesh:
    """The 2-D pencil mesh of ``randomfield_tpu/parallel/pencil.py``.  Not
    ported yet: the Generator and the estimators raise NotImplementedError
    on it."""
    return PencilMesh(int(data), int(spx), int(spy))


def require_slab(mesh) -> SlabMesh:
    """``mesh`` if it is a :class:`SlabMesh`; NotImplementedError for a
    pencil mesh, TypeError for anything else."""
    if isinstance(mesh, PencilMesh):
        raise NotImplementedError(
            f"pencil meshes ({mesh}) are not ported to randomfield_tpu_torch "
            f"yet: they reuse the slab mesh's kernels with a second exchange "
            f"{_ROADMAP}")
    if not isinstance(mesh, SlabMesh):
        raise TypeError(f"mesh must be a SlabMesh from make_mesh, got "
                        f"{type(mesh).__name__}")
    return mesh
