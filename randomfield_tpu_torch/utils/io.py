"""Field and scene serialization in the JAX package's on-disk format.

Port of ``randomfield_tpu/utils/io.py``.  Either package reads what the
other writes:

* :func:`save_field` writes one ``.npz`` with the keys ``delta``,
  ``format_version`` (1), ``meta_json`` (the seed, the scene as JSON, the
  pipeline and sampler, ``extra``) and, with a generator, ``power_k``,
  ``power_pk``, ``redshifts`` and ``growth``;
* :func:`save_field_sharded` writes a directory of
  ``chunk_<x>_<y>_<z>.npz`` files (``block``, ``starts``), named by the
  chunk's global start, and ``manifest.npz``; every file is written under
  a temporary name and renamed, so a crash leaves no truncated file.

The durable artifact stays the scene and the seed (fields regenerate from
them); a CUDA tensor is copied to the host before it is written.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib

import numpy as np
import torch

__all__ = [
    "save_field",
    "load_field",
    "save_field_sharded",
    "load_field_sharded",
    "scene_to_json",
    "scene_from_json",
]

_FORMAT_VERSION = 1
# the port renders float32 fields; the JAX Scene records its dtype
_DTYPE = "float32"


def _host(delta):
    """A field as a host numpy array (CUDA tensors copied first)."""
    if isinstance(delta, torch.Tensor):
        return delta.detach().cpu().numpy()
    return np.asarray(delta)


def _provenance(payload, generator, seed, extra):
    """The metadata dict, with the generator's arrays added to ``payload``."""
    meta = {"seed": seed}
    if generator is not None:
        meta["scene"] = json.loads(scene_to_json(generator.scene))
        meta["pipeline"] = generator.pipeline
        meta["sampler"] = generator.sampler
        payload["power_k"] = np.asarray(generator.power.k)
        payload["power_pk"] = np.asarray(generator.power.Pk)
        payload["redshifts"] = np.asarray(generator.redshifts)
        payload["growth"] = np.asarray(generator.growth_function)
    if extra:
        meta["extra"] = extra
    return meta


def _meta_bytes(meta):
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def _read_meta(f):
    meta = json.loads(bytes(f["meta_json"]).decode()) if "meta_json" in f else {}
    for key in ("power_k", "power_pk", "redshifts", "growth"):
        if key in f:
            meta[key] = f[key]
    return meta


def save_field(path, delta, generator=None, seed=None, extra=None):
    """Write a rendered field to ``.npz`` with provenance metadata.

    ``generator`` (optional) contributes the scene spec, power table and
    evolution arrays so the file is self-describing; ``seed`` records how
    to regenerate the field exactly.  Returns the path.
    """
    path = pathlib.Path(path)
    payload = {"delta": _host(delta), "format_version": _FORMAT_VERSION}
    payload["meta_json"] = _meta_bytes(
        _provenance(payload, generator, seed, extra))
    np.savez_compressed(path, **payload)
    return path


def load_field(path):
    """Read a field written by :func:`save_field` -> (host array, meta)."""
    with np.load(path, allow_pickle=False) as f:
        return f["delta"], _read_meta(f)


def save_field_sharded(dirpath, delta, generator=None, seed=None,
                       extra=None, mesh=None):
    """Write a field as per-rank chunks plus a manifest.

    On a slab mesh (``mesh``, or else ``generator.mesh``) ``delta`` is this
    rank's x slab ``(nx/P, ny, nz)``: the rank writes it as one chunk at
    its global start ``(rank nx/P, 0, 0)`` and rank 0 writes
    ``manifest.npz`` (the global shape, the dtype and :func:`save_field`'s
    provenance).  Without a mesh the field is one chunk.  No collective
    runs: each rank writes only what it holds.  Returns the directory.
    """
    dirpath = pathlib.Path(dirpath)
    dirpath.mkdir(parents=True, exist_ok=True)
    if mesh is None and generator is not None:
        mesh = getattr(generator, "mesh", None)
    rank, size = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    block = _host(delta)
    gshape = (block.shape[0] * size, *block.shape[1:])
    starts = np.asarray([rank * block.shape[0]] + [0] * (block.ndim - 1),
                        np.int64)
    stem = "chunk_" + "_".join(f"{int(v):08d}" for v in starts)
    # the temporary name is unique across processes, so only the renames
    # of two writers of one chunk can meet
    tmp = dirpath / f".{stem}.tmp.{os.getpid()}.npz"
    np.savez_compressed(tmp, block=block, starts=starts)
    tmp.replace(dirpath / f"{stem}.npz")
    if rank == 0:
        payload = {"format_version": _FORMAT_VERSION}
        meta = _provenance(payload, generator, seed, extra)
        meta["global_shape"] = [int(n) for n in gshape]
        meta["dtype"] = str(block.dtype)
        payload["meta_json"] = _meta_bytes(meta)
        tmp = dirpath / f".manifest.tmp.{os.getpid()}.npz"
        np.savez_compressed(tmp, **payload)
        tmp.replace(dirpath / "manifest.npz")
    return dirpath


def _fill(dirpath, gshape, dtype, lo, hi):
    """The block [lo, hi) of the field from the chunks that overlap it; a
    chunk's global start is in its name and its extent comes from the
    lattice of chunk starts, so a chunk that does not overlap is never
    read."""
    chunks = {tuple(int(v) for v in p.stem.split("_")[1:]): p
              for p in sorted(dirpath.glob("chunk_*.npz"))}
    nd = len(gshape)
    axis_starts = [sorted({s[ax] for s in chunks}) for ax in range(nd)]

    def extent(start):
        out = []
        for ax, s in enumerate(start):
            nxt = [v for v in axis_starts[ax] if v > s]
            out.append((nxt[0] if nxt else gshape[ax]) - s)
        return out

    block = np.empty([h - l for l, h in zip(lo, hi)], dtype)
    hit = np.zeros(block.shape, bool)
    for start, path in chunks.items():
        ext = extent(start)
        if any(max(lo[ax], start[ax]) >= min(hi[ax], start[ax] + ext[ax])
               for ax in range(nd)):
            continue
        with np.load(path, allow_pickle=False) as f:
            data = f["block"]
        isl, osl = [], []
        for ax, (s, n) in enumerate(zip(start, data.shape)):
            a, b = max(lo[ax], s), min(hi[ax], s + n)
            isl.append(slice(a - lo[ax], b - lo[ax]))
            osl.append(slice(a - s, b - s))
        block[tuple(isl)] = data[tuple(osl)]
        hit[tuple(isl)] = True
    if not hit.all():
        raise ValueError(f"chunks in {dirpath} do not cover the block "
                         f"{list(zip(lo, hi))}")
    return block


def load_field_sharded(dirpath, mesh=None):
    """Reassemble a field written by :func:`save_field_sharded` (by either
    package).

    With ``mesh=None`` returns the whole host array and the meta dict.
    With a slab mesh returns this rank's x slab ``(nx/P, ny, nz)`` as a
    tensor on ``mesh.device``, read from only the chunks that overlap it,
    so no rank holds the whole field.
    """
    dirpath = pathlib.Path(dirpath)
    with np.load(dirpath / "manifest.npz", allow_pickle=False) as f:
        meta = _read_meta(f)
    gshape = tuple(meta["global_shape"])
    dtype = np.dtype(meta["dtype"])
    lo, hi = [0] * len(gshape), list(gshape)
    if mesh is not None:
        lo[0], count = mesh.rows(gshape[0])
        hi[0] = lo[0] + count
    block = _fill(dirpath, gshape, dtype, lo, hi)
    if mesh is None:
        return block, meta
    return torch.from_numpy(block).to(mesh.device), meta


def scene_to_json(scene) -> str:
    """Serialize a Scene (including cosmology) to JSON; the JAX package's
    keys, ``dtype`` "float32" among them."""
    d = dataclasses.asdict(scene)
    d["dtype"] = _DTYPE
    d["cosmology"] = dataclasses.asdict(scene.cosmology)
    return json.dumps(d, indent=2, sort_keys=True)


def scene_from_json(text):
    """Inverse of :func:`scene_to_json` (also reads the JAX package's);
    ValueError for a dtype other than float32, which the port does not
    render."""
    from randomfield_tpu_torch.engine.scene import Scene
    from randomfield_tpu_torch.models.cosmology import Cosmology

    d = json.loads(text)
    dtype = d.pop("dtype", _DTYPE)
    if dtype != _DTYPE:
        raise ValueError(f"scene dtype {dtype!r}: randomfield_tpu_torch "
                         f"renders {_DTYPE} fields only")
    d["cosmology"] = Cosmology(**d["cosmology"])
    return Scene(**d)
