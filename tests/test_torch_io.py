"""The port's field I/O (randomfield_tpu_torch.utils.io) against the JAX
package's: each package reads what the other writes, bit for bit.

* a port ``save_field`` file through JAX's ``load_field``, and a JAX file
  through the port's (fields exact; meta, power table and evolution
  arrays equal);
* ``scene_from_json`` of either package's JSON gives the other's Scene;
* chunks written by in-process slab-mesh ranks (``SlabMesh(group=None,
  rank=r, size=2)``) read back by JAX's ``load_field_sharded`` and by the
  port's, whole and a slab a rank;
* a scene dtype the port does not render is refused.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import randomfield_tpu as rf  # noqa: E402
from randomfield_tpu.utils import io as jio  # noqa: E402

import randomfield_tpu_torch as rft  # noqa: E402
from randomfield_tpu_torch.parallel.mesh import SlabMesh  # noqa: E402
from randomfield_tpu_torch.utils import io as tio  # noqa: E402

SHAPE = (16, 16, 16)
SPACING = 8.0
SEED = 3
Z0 = 0.25


def _port():
    return rft.Generator(*SHAPE, grid_spacing=SPACING, z0=Z0, device="cpu")


def _jax():
    return rf.Generator(*SHAPE, grid_spacing=SPACING, z0=Z0)


def _same_meta(a, b):
    for key in ("seed", "scene", "pipeline", "sampler", "extra"):
        assert a.get(key) == b.get(key), key
    for key in ("power_k", "power_pk", "redshifts", "growth"):
        np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.smoke
def test_port_file_reads_in_jax(tmp_path):
    g = _port()
    delta = g.generate_delta_field(SEED)
    path = tio.save_field(tmp_path / "f.npz", delta, generator=g, seed=SEED,
                          extra={"note": "port"})
    back, meta = jio.load_field(path)
    np.testing.assert_array_equal(back, delta.numpy())
    _same_meta(meta, tio.load_field(path)[1])
    assert meta["extra"] == {"note": "port"}
    assert jio.scene_from_json(json.dumps(meta["scene"])) == _jax().scene
    # regenerate in JAX from the file: the same Threefry stream
    jg = rf.Generator(*SHAPE, grid_spacing=SPACING, z0=Z0,
                      power=(meta["power_k"], meta["power_pk"]))
    again = np.asarray(jg.generate_delta_field(meta["seed"]))
    assert np.abs(again - back).max() <= 1e-3 * np.abs(back).max()


def test_jax_file_reads_in_port(tmp_path):
    jg = _jax()
    delta = jg.generate_delta_field(SEED)
    path = jio.save_field(tmp_path / "j.npz", delta, generator=jg, seed=SEED,
                          extra={"note": "jax"})
    back, meta = tio.load_field(path)
    np.testing.assert_array_equal(back, np.asarray(delta))
    _same_meta(meta, jio.load_field(path)[1])
    assert tio.scene_from_json(json.dumps(meta["scene"])) == _port().scene


def test_scene_json_both_ways():
    port_json = tio.scene_to_json(_port().scene)
    jax_json = jio.scene_to_json(_jax().scene)
    assert json.loads(port_json) == json.loads(jax_json)
    assert jio.scene_from_json(port_json) == _jax().scene
    assert tio.scene_from_json(jax_json) == _port().scene
    assert tio.scene_from_json(port_json) == _port().scene


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
def test_refused_dtype(dtype):
    d = json.loads(tio.scene_to_json(_port().scene))
    d["dtype"] = dtype
    with pytest.raises(ValueError, match="float32"):
        tio.scene_from_json(json.dumps(d))


def test_sharded_chunks_of_slab_ranks(tmp_path):
    g = _port()
    delta = g.generate_delta_field(SEED)
    size = 2
    meshes = [SlabMesh(group=None, rank=r, size=size,
                       device=torch.device("cpu")) for r in range(size)]
    out = tmp_path / "chunks"
    for m in meshes:
        lo, n = m.rows(SHAPE[0])
        tio.save_field_sharded(out, delta[lo:lo + n], generator=g, seed=SEED,
                               mesh=m)
    names = sorted(p.name for p in out.iterdir())
    assert names == ["chunk_00000000_00000000_00000000.npz",
                     "chunk_00000008_00000000_00000000.npz", "manifest.npz"]

    full, meta = jio.load_field_sharded(out)
    np.testing.assert_array_equal(full, delta.numpy())
    assert meta["dtype"] == "float32" and meta["seed"] == SEED
    assert meta["global_shape"] == list(SHAPE)
    assert jio.scene_from_json(json.dumps(meta["scene"])) == _jax().scene

    whole, tmeta = tio.load_field_sharded(out)
    np.testing.assert_array_equal(whole, delta.numpy())
    assert tmeta["global_shape"] == list(SHAPE)
    for m in meshes:
        lo, n = m.rows(SHAPE[0])
        slab, _ = tio.load_field_sharded(out, mesh=m)
        assert isinstance(slab, torch.Tensor) and slab.device == m.device
        assert torch.equal(slab, delta[lo:lo + n])


def test_sharded_reads_only_overlapping_chunks(tmp_path, monkeypatch):
    delta = torch.arange(np.prod(SHAPE), dtype=torch.float32).reshape(SHAPE)
    meshes = [SlabMesh(None, r, 4, torch.device("cpu")) for r in range(4)]
    for m in meshes:
        lo, n = m.rows(SHAPE[0])
        tio.save_field_sharded(tmp_path, delta[lo:lo + n], seed=1, mesh=m)
    read = []
    real = np.load

    def counting_load(path, *a, **kw):
        read.append(str(path))
        return real(path, *a, **kw)

    monkeypatch.setattr(np, "load", counting_load)
    slab, _ = tio.load_field_sharded(
        tmp_path, mesh=SlabMesh(None, 1, 2, torch.device("cpu")))
    assert torch.equal(slab, delta[8:16])
    assert sorted(p.rsplit("/", 1)[1] for p in read) == [
        "chunk_00000008_00000000_00000000.npz",
        "chunk_00000012_00000000_00000000.npz", "manifest.npz"]


def test_jax_sharded_chunks_read_by_port(tmp_path):
    jg = _jax()
    delta = np.asarray(jg.generate_delta_field(SEED))
    jio.save_field_sharded(tmp_path, delta, generator=jg, seed=SEED)
    whole, meta = tio.load_field_sharded(tmp_path)
    np.testing.assert_array_equal(whole, delta)
    slab, _ = tio.load_field_sharded(
        tmp_path, mesh=SlabMesh(None, 1, 2, torch.device("cpu")))
    np.testing.assert_array_equal(slab.numpy(), delta[8:])
