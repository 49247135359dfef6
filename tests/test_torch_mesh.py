"""The slab-mesh slice of the port (randomfield_tpu_torch.parallel) vs one
device and vs the JAX package's mesh.

Ranks are ``torch.multiprocessing.spawn`` processes in a gloo group whose
rendezvous is a FileStore (no TCP port).  The rank function lives at the
top of this module and JAX is imported only inside the tests, so a rank
imports neither JAX nor tests/conftest.py.  Each mesh size runs once per
session: the first test that needs it spawns the ranks under a file lock in
the session's shared temporary directory, every rank ``torch.save``s what
it computed, and the tests compare those slabs.  A one-rank mesh needs no
process group and runs in the test's own process.

Tolerances:
* slab draws, the K8 plain union, the sharded Hermitian fix and K8's fix
  in the thread against it: exact;
* a mesh render vs the single-device render of the same seed: bit-equal
  expected, bar 1e-6 max|delta| (the CPU FFT of a slab batches its lines
  differently);
* the Threefry mesh render vs JAX's mesh render: 1e-3 max|delta|, the bar
  of tests/test_torch_generator.py (the JAX CPU mesh scales by its sigma
  grid, the port by the uniform table);
* binned spectra: counts exact, p_hat within 1e-5 (float64 sums in
  another order; JAX's float32 one-hot contraction).
"""

import fcntl
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import randomfield_tpu_torch as rft  # noqa: E402
from randomfield_tpu_torch.ops import modestream, sample, sampler  # noqa: E402
from randomfield_tpu_torch.ops import threefry, transform  # noqa: E402
from randomfield_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from randomfield_tpu_torch.validate import stats  # noqa: E402

SHAPE = (32, 32, 32)
SPACING = 16.0
SEED = 5
SMOOTHING = 6.0
NBINS = 10
SAMPLERS = ("threefry", "pallas")
RENDER_TOL = 1e-6
JAX_TOL = 1e-3
P_RTOL = 1e-5
JOIN_TIMEOUT_S = 300.0


# ---- the ranks ------------------------------------------------------------------

def _rank_work(m):
    """What every rank computes on its mesh ``m``: its slabs and the
    replicated results, in a dict of tensors and numpy arrays."""
    y_off, ny_loc = m.rows(SHAPE[1])
    out = {}
    for name in SAMPLERS:
        g = rft.Generator(*SHAPE, grid_spacing=SPACING, mesh=m, sampler=name)
        field = g.generate_delta_field(SEED)
        out[f"field_{name}"] = field
        out[f"smooth_{name}"] = g.generate_delta_field(
            SEED, smoothing_length=SMOOTHING, apply_lightcone=False)
        out[f"batch_{name}"] = g.generate_delta_fields([SEED, SEED + 1])
        out[f"power_{name}"] = g.calculate_power(field, nbins=NBINS)
        out[f"variance_{name}"] = g.predicted_variance(SMOOTHING, True)
    g = rft.Generator(*SHAPE, grid_spacing=SPACING, mesh=m)
    out["sample_power"] = g.sample_power(SEED, SMOOTHING, nbins=NBINS)
    out["sample_power_batch"] = g.sample_power_batch([1, 2], nbins=NBINS)
    re, im = sample.unit_draws_reim(threefry.key_from_seed(SEED), SHAPE, "cpu",
                                    y_off, ny_loc)
    out["draws"] = (re.clone(), im.clone())
    out["symmetrized"] = transform.symmetrize_slab_reim(re, im, SHAPE[2], m)
    out["modes"] = sampler.sample_shard(SEED, g.state.table, SHAPE, SPACING,
                                        SMOOTHING, y_off, ny_loc)
    raw = sampler.seeded_modes_plain(SEED, g.state.table, SHAPE, SPACING,
                                     SMOOTHING, y_off, ny_loc)
    out["modes_gathered"] = transform.symmetrize_slab_reim(*raw, SHAPE[2], m)
    errors = {}
    for what, call in (
            ("indivisible", lambda: rft.Generator(
                SHAPE[0] + 2, *SHAPE[1:], grid_spacing=SPACING, mesh=m)),
            ("pallas sample_power", lambda: rft.Generator(
                *SHAPE, grid_spacing=SPACING, mesh=m,
                sampler="pallas").sample_power(SEED))):
        try:
            call()
            errors[what] = None
        except Exception as err:  # the test checks the kind and the text
            errors[what] = (type(err).__name__, str(err))
    out["errors"] = errors
    return out


def _rank_main(rank, size, store, out_dir):
    # the ranks run beside the xdist workers: one thread each
    torch.set_num_threads(1)
    from randomfield_tpu_torch.parallel import multihost

    multihost.initialize("gloo", f"file://{store}", size, rank, "cpu")
    try:
        out = _rank_work(pmesh.make_mesh(space=size, device="cpu"))
        out["jax modules"] = [m for m in sys.modules
                              if m == "jax" or m.startswith("jax.")]
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        multihost.shutdown()


def _shared_dir(tmp_path_factory):
    """The session's temporary directory, shared by its xdist workers."""
    root = tmp_path_factory.getbasetemp()
    return root.parent if os.environ.get("PYTEST_XDIST_WORKER") else root


def _spawn(size, out):
    import torch.multiprocessing as mp

    out.mkdir(parents=True, exist_ok=True)
    ctx = mp.spawn(_rank_main, args=(size, str(out / "store"), str(out)),
                   nprocs=size, join=False)
    try:
        # join(timeout) returns False while any rank runs, raises if one failed
        for _ in range(int(JOIN_TIMEOUT_S)):
            if ctx.join(timeout=1.0):
                return
        raise TimeoutError(f"{size} ranks did not finish in {JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def _mesh_results(size, tmp_path_factory):
    """Every rank's results of a ``size``-rank mesh, spawned once per
    session."""
    if size == 1:
        return [_rank_work(pmesh.make_mesh(device="cpu"))]
    shared = _shared_dir(tmp_path_factory)
    out = shared / f"torch_mesh_{size}"
    with open(shared / f"torch_mesh_{size}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        failed = out / "failed"
        if failed.exists():
            pytest.fail(f"the {size}-rank run failed: {failed.read_text()}")
        if not (out / "done").exists():
            try:
                _spawn(size, out)
            except Exception as err:
                failed.write_text(repr(err))
                raise
            (out / "done").touch()
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(size)]


def _x_cat(results, key):
    return torch.cat([r[key] for r in results], dim=-3)


def _max_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---- pieces, on one process -------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 8, 12), (12, 16, 10)])
@pytest.mark.parametrize("size", [2, 4])
def test_slab_draws_are_slices_of_the_full_draw(shape, size):
    key = threefry.key_from_seed(9)
    full = sample.unit_draws_reim(key, shape)
    bits = modestream.mode_bits(modestream.mode_key(9), shape)
    ny_loc = shape[1] // size
    for r in range(size):
        rows = slice(r * ny_loc, (r + 1) * ny_loc)
        re, im = sample.unit_draws_reim(key, shape, "cpu", r * ny_loc, ny_loc)
        assert torch.equal(re, full[0][:, rows])
        assert torch.equal(im, full[1][:, rows])
        b1, b2 = modestream.mode_bits(modestream.mode_key(9), shape, 0, None,
                                      "cpu", r * ny_loc, ny_loc)
        assert torch.equal(b1, bits[0][:, rows])
        assert torch.equal(b2, bits[1][:, rows])


@pytest.mark.parametrize("smoothing", [0.0, SMOOTHING])
def test_k8_plain_union_is_k1(smoothing):
    g = rft.Generator(*SHAPE, grid_spacing=SPACING, device="cpu",
                      sampler="pallas")
    whole = sampler.sample_modes(SEED, g.state.table, SHAPE, SPACING, smoothing)
    parts = [sampler.sample_shard(SEED, g.state.table, SHAPE, SPACING,
                                  smoothing, y, 8) for y in range(0, 32, 8)]
    assert torch.equal(torch.cat([p[0] for p in parts], 1), whole[0])
    assert torch.equal(torch.cat([p[1] for p in parts], 1), whole[1])


# ---- the mesh vs one device ------------------------------------------------------------

@pytest.mark.smoke
@pytest.mark.parametrize("size", [1, 2, 4])
@pytest.mark.parametrize("name", SAMPLERS)
def test_mesh_render_equals_single_device(tmp_path_factory, size, name):
    results = _mesh_results(size, tmp_path_factory)
    g = rft.Generator(*SHAPE, grid_spacing=SPACING, device="cpu", sampler=name)
    want = {
        "field": g.generate_delta_field(SEED),
        "smooth": g.generate_delta_field(SEED, smoothing_length=SMOOTHING,
                                         apply_lightcone=False),
        "batch": g.generate_delta_fields([SEED, SEED + 1]),
    }
    for key, w in want.items():
        got = _x_cat(results, f"{key}_{name}")
        assert got.shape == w.shape
        assert _max_rel(got, w) <= RENDER_TOL, key
    if size > 1:  # the ranks ran the port alone
        assert not any(r["jax modules"] for r in results)


@pytest.mark.parametrize("size", [2, 4])
def test_sharded_symmetrize_and_k8_equal_single_device(tmp_path_factory, size):
    results = _mesh_results(size, tmp_path_factory)
    re, im = sample.unit_draws_reim(threefry.key_from_seed(SEED), SHAPE)
    draws = (torch.cat([r["draws"][0] for r in results], 1),
             torch.cat([r["draws"][1] for r in results], 1))
    assert torch.equal(draws[0], re) and torch.equal(draws[1], im)
    transform.symmetrize_with_shape_reim(re, im, SHAPE[2])
    assert torch.equal(torch.cat([r["symmetrized"][0] for r in results], 1), re)
    assert torch.equal(torch.cat([r["symmetrized"][1] for r in results], 1), im)
    g = rft.Generator(*SHAPE, grid_spacing=SPACING, device="cpu")
    k1 = sampler.sample_modes(SEED, g.state.table, SHAPE, SPACING, SMOOTHING)
    assert torch.equal(torch.cat([r["modes"][0] for r in results], 1), k1[0])
    assert torch.equal(torch.cat([r["modes"][1] for r in results], 1), k1[1])


@pytest.mark.parametrize("size", [1, 2, 4])
def test_k8_fix_needs_no_gather(tmp_path_factory, size):
    # K8 fixes its shard's planes by drawing partners' counters; the
    # gathered fix of the raw shard (one all_gather of the planes) agrees
    results = _mesh_results(size, tmp_path_factory)
    for r in results:
        assert torch.equal(r["modes"][0], r["modes_gathered"][0])
        assert torch.equal(r["modes"][1], r["modes_gathered"][1])


def _assert_bins(got, want):
    k, p, n = got
    kw, pw, nw = (np.asarray(a, np.float64) for a in want)
    np.testing.assert_array_equal(n, nw)
    live = nw > 0
    assert live.sum() >= 3
    np.testing.assert_allclose(p[live], pw[live], rtol=P_RTOL)
    np.testing.assert_allclose(k[live], kw[live], rtol=P_RTOL)


@pytest.mark.parametrize("size", [1, 2, 4])
def test_mesh_estimators_equal_single_device(tmp_path_factory, size):
    results = _mesh_results(size, tmp_path_factory)
    for name in SAMPLERS:
        g = rft.Generator(*SHAPE, grid_spacing=SPACING, device="cpu",
                          sampler=name)
        want = g.calculate_power(g.generate_delta_field(SEED), nbins=NBINS)
        variance = g.predicted_variance(SMOOTHING, True)
        for r in results:  # every rank holds the whole field's result
            _assert_bins(r[f"power_{name}"], want)
            assert abs(r[f"variance_{name}"] / variance - 1.0) <= 1e-12
    g = rft.Generator(*SHAPE, grid_spacing=SPACING, device="cpu")
    want = g.sample_power(SEED, SMOOTHING, nbins=NBINS)
    batch = g.sample_power_batch([1, 2], nbins=NBINS)
    for r in results:
        _assert_bins(r["sample_power"], want)
        np.testing.assert_array_equal(r["sample_power_batch"][2], batch[2])
        live = batch[2] > 0
        np.testing.assert_allclose(r["sample_power_batch"][1][:, live],
                                   batch[1][:, live], rtol=P_RTOL)


# ---- the mesh vs the JAX package's mesh -------------------------------------------------

@pytest.mark.parametrize("size", [2, 4])
def test_threefry_mesh_matches_jax_mesh(tmp_path_factory, size):
    import randomfield_tpu as rf
    from randomfield_tpu.parallel.mesh import make_mesh as jax_mesh

    results = _mesh_results(size, tmp_path_factory)
    gj = rf.Generator(*SHAPE, grid_spacing=SPACING, mesh=jax_mesh(1, size))
    want = np.asarray(gj.generate_delta_field(SEED))
    assert _max_rel(_x_cat(results, "field_threefry"), want) <= JAX_TOL
    want = np.asarray(gj.generate_delta_field(
        SEED, smoothing_length=SMOOTHING, apply_lightcone=False))
    assert _max_rel(_x_cat(results, "smooth_threefry"), want) <= JAX_TOL


@pytest.mark.parametrize("size", [2, 4])
def test_mesh_calculate_power_matches_jax_mesh(tmp_path_factory, size):
    import jax.numpy as jnp

    from randomfield_tpu.parallel.mesh import make_mesh as jax_mesh
    from randomfield_tpu.validate import stats as jstats

    results = _mesh_results(size, tmp_path_factory)
    field = _x_cat(results, "field_threefry").numpy()
    want = jstats.calculate_power(jnp.asarray(field), SPACING, NBINS,
                                  mesh=jax_mesh(1, size))
    _assert_bins(results[0]["power_threefry"], want)


# ---- what the mesh refuses -----------------------------------------------------------------

def test_mesh_error_cases(tmp_path_factory):
    errors = _mesh_results(4, tmp_path_factory)[0]["errors"]
    assert errors["indivisible"][0] == "ValueError"
    assert "divisible" in errors["indivisible"][1]
    assert errors["pallas sample_power"][0] == "ValueError"
    assert "plain renders only" in errors["pallas sample_power"][1]
    with pytest.raises(ValueError, match="divisible"):
        pmesh.check_divisible((32, 30, 32), 4)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        pmesh.make_mesh(data=2, device="cpu")
    with pytest.raises(ValueError, match="space=2"):
        pmesh.make_mesh(space=2, device="cpu")  # no process group: one rank
    pencil = pmesh.make_pencil_mesh(spx=2, spy=2)
    with pytest.raises(NotImplementedError, match="pencil"):
        rft.Generator(*SHAPE, grid_spacing=SPACING, mesh=pencil)
    with pytest.raises(NotImplementedError, match="pencil"):
        stats.calculate_power(torch.zeros(SHAPE), SPACING, mesh=pencil)
    with pytest.raises(TypeError, match="SlabMesh"):
        rft.Generator(*SHAPE, grid_spacing=SPACING, mesh=object())
    one = pmesh.make_mesh(device="cpu")
    with pytest.raises(ValueError, match="not the mesh's device"):
        rft.Generator(*SHAPE, grid_spacing=SPACING, mesh=one, device="cuda")
    g = rft.Generator(*SHAPE, grid_spacing=SPACING, mesh=one)
    # generate_noise on a mesh returns the whole grid's draws, as the JAX
    # package does; generate_from_noise refuses a mesh with its words
    noise = g.generate_noise(1)
    assert noise.shape == (2, SHAPE[0], SHAPE[1], SHAPE[2] // 2 + 1)
    with pytest.raises(ValueError, match="single-device fused scene"):
        g.generate_from_noise(noise)
