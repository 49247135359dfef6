"""The slab mesh's fixed, nested, derived and 2LPT renders, sigmas, f_NL
fields, field moments and Fourier and xi estimators vs the port's single
device and vs the JAX package's mesh.

Ranks are ``torch.multiprocessing.spawn`` processes in a gloo group whose
rendezvous is a FileStore, as in tests/test_torch_mesh.py: the rank
function lives at the top of this module and imports no JAX, each mesh
size (2 and 4 ranks, at 32^3) runs once per session under a file lock in
the session's shared temporary directory, every rank ``torch.save``s what
it computed (or the error a call raised), and the tests compare those
slabs.  The estimators are fed one numpy field made from a seed, each rank
its x slab of it.

Bars:
* renders (fixed and paired, nested, potential, displacement, velocity,
  tidal, classify_web, Kaiser), sigmas, noise and the f_NL fields vs the
  single device: 1e-6 max|delta| (bit-equal draws; the CPU transforms of a
  slab batch their lines differently);
* 2LPT vs the single device: 1e-5 max|psi| for psi and 2e-5 max|psi2| for
  the correction alone (the mesh synthesizes the second order from the
  sampled spectrum, as the JAX mesh program does, the single device from
  a forward transform of the rendered field: the two differ by the
  transforms' rounding);
* the Fourier estimators: counts exact, p and k within 1e-5 (a multipole
  within 1e-5 of its bin's monopole: p_2 and p_4 cross zero); field
  moments within 1e-10; xi and xi_ell: counts exact, values within 1e-5 of
  the largest |xi|; the bispectrum: triples exact, B within 1e-5 of the
  largest |B|, triad counts within 1e-6;
* vs the JAX package's CPU mesh: fields from the same seed within 1e-3
  max|delta| (the bar of tests/test_torch_mesh.py); estimators fed the
  same numpy field: counts exact, p within 1e-5 (xi within 1e-5 of the
  largest |xi|; B within 1e-3 of the largest |B| and triad counts within
  1e-5 of the largest count: the JAX package sums the 32^3 cells' triple
  products in float32, and a Gaussian field's B cancels to near 0).
"""

import fcntl
import functools
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import randomfield_tpu_torch as rft  # noqa: E402
from randomfield_tpu_torch.validate import bispectrum as bisp  # noqa: E402
from randomfield_tpu_torch.validate import stats  # noqa: E402

SHAPE = (32, 32, 32)
SPACING = 16.0
SEED = 7
SMOOTHING = 6.0
NBINS = 10
XI_BINS = 8
BISP_BINS = 4
FNL = {"field": 50.0, "potential": 2e3}
RENDER_TOL = 1e-6
LPT_TOL = 1e-5
LPT2_TOL = 2e-5
P_RTOL = 1e-5
MOMENT_RTOL = 1e-10
XI_TOL = 1e-5
BISP_TOL = 1e-5
NTRI_RTOL = 1e-6
JAX_TOL = 1e-3
JAX_BISP_TOL = 1e-3
JAX_NTRI_TOL = 1e-5
JOIN_TIMEOUT_S = 300.0

# (key, method, args, kwargs) of the renders each rank runs on a Threefry
# and on a nested scene, and compares with the single device
RENDERS = {
    "threefry": (
        ("fixed", "generate_fixed_field", (SEED,), {}),
        ("fixed_flip", "generate_fixed_field", (SEED,),
         dict(smoothing_length=SMOOTHING, apply_lightcone=False, flip=True)),
        ("fixed_batch", "generate_fixed_fields", ([SEED, SEED + 1],),
         dict(flip=True)),
        ("potential", "generate_potential", (SEED,), dict(z=0.5)),
        ("displacement", "generate_displacement", (SEED,),
         dict(smoothing_length=SMOOTHING)),
        ("velocity", "generate_velocity", (SEED,), dict(component=1)),
        ("tidal", "generate_tidal_field", (SEED,), {}),
        ("web", "classify_web", (SEED,), {}),
        ("kaiser", "generate_kaiser_field", (SEED,),
         dict(z=0.3, bias=1.5, los_axis=0)),
        ("ng_field", "generate_nongaussian_field", (SEED, FNL["field"]),
         dict(kind="field")),
        ("ng_potential", "generate_nongaussian_field",
         (SEED, FNL["potential"]), dict(kind="potential")),
    ),
    "nested": (
        ("field", "generate_delta_field", (SEED,), {}),
        ("smooth", "generate_delta_field", (SEED,),
         dict(smoothing_length=SMOOTHING, apply_lightcone=False)),
        ("fixed", "generate_fixed_field", (SEED,), dict(flip=True)),
        ("tidal", "generate_tidal_field", (SEED,), dict(component=3)),
        ("potential", "generate_potential", (SEED,), {}),
    ),
}
LPT = (("lpt2", None), ("lpt2_z", 2))


def _inputs():
    """The estimators' numpy inputs, made from a seed: two correlated
    fields and a binary window."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal(SHAPE).astype(np.float32)
    b = (0.5 * a + rng.standard_normal(SHAPE)).astype(np.float32)
    w = (rng.uniform(size=SHAPE) > 0.3).astype(np.float32)
    return a, b, w


def _estimators(a, b, w, mesh):
    """(key, call) of every estimator on the fields ``a``, ``b`` and the
    window ``w`` (this rank's x slabs, or the whole grid with mesh None)."""
    return (
        ("power_cic", lambda: stats.calculate_power(
            a, SPACING, NBINS, mesh=mesh, window="cic")),
        ("power_interlaced", lambda: stats.calculate_power(
            a, SPACING, NBINS, mesh=mesh, window="cic", interlaced_with=b)),
        ("poles", lambda: stats.calculate_power_multipoles(
            a, SPACING, NBINS, los_axis=1, window="tsc", mesh=mesh)),
        ("poles_interlaced", lambda: stats.calculate_power_multipoles(
            a, SPACING, NBINS, ells=(0, 2), interlaced_with=b, mesh=mesh)),
        ("wedges", lambda: stats.calculate_power_wedges(
            a, SPACING, NBINS, nmu=4, los_axis=0, window="ngp", mesh=mesh)),
        ("cross", lambda: stats.calculate_cross_power(
            a, b, SPACING, NBINS, mesh=mesh)),
        ("masked", lambda: stats.calculate_masked_power(
            a, w, SPACING, NBINS, mesh=mesh)),
        ("xi", lambda: stats.calculate_correlation(
            a, SPACING, XI_BINS, mesh=mesh)),
        ("xi_ell", lambda: stats.calculate_correlation_multipoles(
            a, SPACING, XI_BINS, los_axis=1, mesh=mesh)),
        ("bispectrum", lambda: bisp.calculate_bispectrum(
            a, SPACING, nbins=BISP_BINS, mesh=mesh)),
        ("moments", lambda: stats.field_moments(a, mesh=mesh)),
    )


def _attempt(out, key, call):
    """``out[key]``: what ``call()`` returns, or ("error", kind, text)."""
    try:
        out[key] = call()
    except Exception as err:  # the tests check the kind and the text
        out[key] = ("error", type(err).__name__, str(err))


class _Refused:
    """A Generator that could not be built: each method raises its error."""

    def __init__(self, err):
        self.err = err

    def __getattr__(self, name):
        raise self.err


def _generator(mesh, sampler):
    try:
        return rft.Generator(*SHAPE, grid_spacing=SPACING, mesh=mesh,
                             sampler=sampler)
    except Exception as err:  # each call on it records the error
        return _Refused(err)


# ---- the ranks ------------------------------------------------------------------

def _rank_work(m):
    """What every rank computes on its mesh ``m``."""
    out = {}
    for name, renders in RENDERS.items():
        g = _generator(m, name)
        for key, method, args, kw in renders:
            _attempt(out, f"{name}_{key}",
                     lambda: getattr(g, method)(*args, **kw))
        for key, comp in LPT:
            _attempt(out, f"{name}_{key}", lambda: g.generate_displacement(
                SEED, component=comp, order=2))
        _attempt(out, f"{name}_sigmas", lambda: g.sigmas)
        _attempt(out, f"{name}_noise", lambda: g.generate_noise(SEED))
    g = rft.Generator(*SHAPE, grid_spacing=SPACING, mesh=m)
    _attempt(out, "from_noise", lambda: g.generate_from_noise(
        g.generate_noise(SEED)))
    gp = rft.Generator(*SHAPE, grid_spacing=SPACING, mesh=m, sampler="pallas")
    _attempt(out, "pallas_potential", lambda: gp.generate_potential(SEED))
    x0, nx_loc = m.rows(SHAPE[0])
    a, b, w = (torch.as_tensor(f[x0:x0 + nx_loc]) for f in _inputs())
    for key, call in _estimators(a, b, w, m):
        _attempt(out, key, call)
    _attempt(out, "method_bispectrum",
             lambda: g.calculate_bispectrum(a, nbins=BISP_BINS))
    _attempt(out, "wedges_interlaced", lambda: stats.calculate_power_wedges(
        a, SPACING, NBINS, interlaced_with=b, mesh=m))
    return out


def _rank_main(rank, size, store, out_dir):
    # the ranks run beside the xdist workers: one thread each
    torch.set_num_threads(1)
    from randomfield_tpu_torch.parallel import mesh as pmesh
    from randomfield_tpu_torch.parallel import multihost

    multihost.initialize("gloo", f"file://{store}", size, rank, "cpu")
    try:
        out = _rank_work(pmesh.make_mesh(space=size, device="cpu"))
        out["jax modules"] = [name for name in sys.modules
                              if name == "jax" or name.startswith("jax.")]
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
    shared = _shared_dir(tmp_path_factory)
    out = shared / f"torch_mesh_surface_{size}"
    with open(shared / f"torch_mesh_surface_{size}.lock", "w") as lock:
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


@functools.lru_cache(maxsize=1)
def _single():
    """The single-device results of the ranks' calls, once per process."""
    out = {}
    for name, renders in RENDERS.items():
        g = rft.Generator(*SHAPE, grid_spacing=SPACING, device="cpu",
                          sampler=name)
        for key, method, args, kw in renders:
            out[f"{name}_{key}"] = getattr(g, method)(*args, **kw)
        for key, comp in LPT:
            out[f"{name}_{key}"] = g.generate_displacement(
                SEED, component=comp, order=2)
            out[f"{name}_{key}_correction"] = out[f"{name}_{key}"] - (
                g.generate_displacement(SEED, component=comp))
        out[f"{name}_sigmas"] = g.sigmas
        out[f"{name}_noise"] = g.generate_noise(SEED)
    a, b, w = (torch.as_tensor(f) for f in _inputs())
    for key, call in _estimators(a, b, w, None):
        out[key] = call()
    return out


def _got(results, key):
    """Every rank's value of ``key``; fails on a rank's error."""
    vals = [r[key] for r in results]
    for v in vals:
        if isinstance(v, tuple) and v and isinstance(v[0], str):
            pytest.fail(f"{key} raised on a rank: {v[1]}: {v[2]}")
    return vals


def _x_cat(results, key):
    return torch.cat(_got(results, key), dim=-3)


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _assert_bins(got, want, rtol=P_RTOL):
    """Counts exact; k and p within ``rtol``, a multipole within ``rtol``
    of its bin's monopole (p_2 and p_4 cross zero)."""
    k, p, n = (np.asarray(a, np.float64) for a in got)
    kw, pw, nw = (np.asarray(a, np.float64) for a in want)
    np.testing.assert_array_equal(n, nw)
    live = nw > 0
    assert live.sum() >= 3
    if p.ndim == 2 and p.shape != n.shape:  # multipoles (n_ells, nbins)
        scale = np.abs(pw[0, live])
        assert np.all(np.abs(p[:, live] - pw[:, live]) <= rtol * scale)
    else:
        np.testing.assert_allclose(p[live], pw[live], rtol=rtol)
    shells = live if live.ndim == 1 else live.any(axis=1)  # wedges: by |k|
    np.testing.assert_allclose(k[shells], kw[shells], rtol=rtol)


def _assert_xi(got, want, tol):
    r, x, n = (np.asarray(a, np.float64) for a in got)
    rw, xw, nw = (np.asarray(a, np.float64) for a in want)
    np.testing.assert_array_equal(n, nw)
    live = nw > 0
    np.testing.assert_allclose(r[live], rw[live], rtol=1e-6)
    assert np.abs(x[..., live] - xw[..., live]).max() <= tol * np.abs(
        xw[..., live]).max()


def _assert_bispectrum(got, want, tol, ntri_rtol=NTRI_RTOL, ntri_tol=0.0):
    kc, tri, b, nt = got
    np.testing.assert_allclose(kc, want[0], rtol=1e-12)
    np.testing.assert_array_equal(tri, want[1])
    want_b = np.asarray(want[2], np.float64)
    assert np.abs(b - want_b).max() <= tol * np.abs(want_b).max()
    np.testing.assert_allclose(nt, want[3], rtol=ntri_rtol,
                               atol=ntri_tol * np.abs(want[3]).max())


SIZES = [2, 4]


# ---- the shard instances' plain versions, in one process --------------------------

@pytest.mark.parametrize("ranks", SIZES)
def test_shard_plain_versions_union_is_whole_grid(ranks):
    """KN's modes, K2F's fixed mode (both signs) and KD's kinds on each
    shard of ky rows: their union is the whole-grid result bit for bit."""
    from randomfield_tpu_torch.ops import derived, sampler

    shape, ny_loc = (16, 16, 16), 16 // ranks
    table = rft.Generator(*shape, grid_spacing=SPACING, device="cpu",
                          sampler="nested").state.table

    def union(call):
        return torch.cat([call(r * ny_loc) for r in range(ranks)], dim=-2)

    for mode in sampler.NESTED_MODES:
        whole = sampler.sample_nested(3, table, shape, SPACING, SMOOTHING,
                                      mode=mode, flip=True)
        assert torch.equal(union(lambda y: sampler.sample_nested(
            3, table, shape, SPACING, SMOOTHING, mode=mode, flip=True,
            y_off=y, ny_loc=ny_loc)), whole), mode
    for flip in (False, True):
        whole = sampler.draw_fixed(3, table, shape, SPACING, SMOOTHING, flip)
        assert torch.equal(union(lambda y: sampler.draw_fixed(
            3, table, shape, SPACING, SMOOTHING, flip, y, ny_loc)), whole)
    rng = np.random.default_rng(2)
    re0, im0 = (torch.as_tensor(rng.standard_normal(
        (16, 16, 9)).astype(np.float32)) for _ in range(2))
    for kind, comps in (("scalar", [0]), ("grad", range(3)),
                        ("tidal", range(6)), ("kaiser", range(3))):
        pref = (1.5, 0.6) if kind == "kaiser" else -0.37
        for comp in comps:
            whole = derived.apply_kernel(re0.clone(), im0.clone(), shape,
                                         SPACING, kind, comp, pref)
            rows = [derived.apply_kernel(
                re0[:, y:y + ny_loc].clone(), im0[:, y:y + ny_loc].clone(),
                shape, SPACING, kind, comp, pref, y_off=y)
                for y in range(0, 16, ny_loc)]
            for i in range(2):
                assert torch.equal(torch.cat([r[i] for r in rows], 1),
                                   whole[i]), (kind, comp)
# the JAX package's mesh programs compile for seconds each: they are held
# on the larger mesh only
JAX_SIZES = [4]


# ---- the renders vs one device ----------------------------------------------------------

@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("key", [f"{name}_{r[0]}" for name, rs in
                                 RENDERS.items() for r in rs
                                 if not r[0].startswith("ng_")])
def test_mesh_renders_equal_single_device(tmp_path_factory, size, key):
    results = _mesh_results(size, tmp_path_factory)
    got, want = _x_cat(results, key), _single()[key]
    assert got.shape == want.shape and got.dtype == want.dtype
    if key.endswith("web"):
        # the classes of cells whose tidal eigenvalues tie within rounding
        # may differ: at most 1e-4 of the cells
        assert (got != want).float().mean() <= 1e-4
    else:
        assert _max_rel(got, want) <= RENDER_TOL, key
    if size == SIZES[-1]:  # the ranks ran the port alone
        assert not any(r["jax modules"] for r in results)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", ["field", "potential"])
def test_mesh_fnl_field_equals_single_device(tmp_path_factory, size, kind):
    # F7: the mesh f_NL field is the whole field's quadratic part (<g^2>
    # and the potential's transforms over the whole grid), not each
    # slab's own
    results = _mesh_results(size, tmp_path_factory)
    key = f"threefry_ng_{kind}"
    assert _max_rel(_x_cat(results, key), _single()[key]) <= RENDER_TOL


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", list(RENDERS))
def test_mesh_2lpt_equals_single_device(tmp_path_factory, size, name):
    results = _mesh_results(size, tmp_path_factory)
    single = _single()
    for key, comp in LPT:
        got = _x_cat(results, f"{name}_{key}")
        want = single[f"{name}_{key}"]
        assert got.shape == want.shape
        assert _max_rel(got, want) <= LPT_TOL, key
        psi1 = single[f"{name}_{key}"] - single[f"{name}_{key}_correction"]
        assert _max_rel(got - psi1, single[f"{name}_{key}_correction"]) <= (
            LPT2_TOL), key


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", list(RENDERS))
def test_mesh_sigmas_and_noise(tmp_path_factory, size, name):
    results = _mesh_results(size, tmp_path_factory)
    single = _single()
    sigmas = torch.cat(_got(results, f"{name}_sigmas"), dim=1)
    assert torch.equal(sigmas, single[f"{name}_sigmas"])
    for noise in _got(results, f"{name}_noise"):  # every rank, whole grid
        assert torch.equal(noise, single[f"{name}_noise"])


@pytest.mark.parametrize("size", SIZES)
def test_mesh_refusals_match_jax(tmp_path_factory, size):
    r = _mesh_results(size, tmp_path_factory)[0]
    assert r["from_noise"][:2] == ("error", "ValueError")
    assert "single-device fused scene" in r["from_noise"][2]
    assert r["pallas_potential"][:2] == ("error", "ValueError")
    assert "plain renders only" in r["pallas_potential"][2]
    assert r["wedges_interlaced"][:2] == ("error", "ValueError")
    assert "interlaced wedges are single-device" in r["wedges_interlaced"][2]


# ---- the estimators vs one device -----------------------------------------------------------

@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("key", ["power_cic", "power_interlaced", "poles",
                                 "poles_interlaced", "wedges", "cross",
                                 "masked"])
def test_mesh_fourier_estimators_equal_single_device(tmp_path_factory, size,
                                                     key):
    results = _mesh_results(size, tmp_path_factory)
    want = _single()[key]
    for got in _got(results, key):  # every rank holds the whole result
        _assert_bins(got, want)


@pytest.mark.parametrize("size", SIZES)
def test_mesh_xi_bispectrum_moments_equal_single_device(tmp_path_factory,
                                                        size):
    results = _mesh_results(size, tmp_path_factory)
    single = _single()
    for r in range(size):
        for key in ("xi", "xi_ell"):
            _assert_xi(_got(results, key)[r], single[key], XI_TOL)
        for key in ("bispectrum", "method_bispectrum"):
            _assert_bispectrum(_got(results, key)[r], single["bispectrum"],
                               BISP_TOL)
        mean, var = _got(results, "moments")[r]
        want_mean, want_var = single["moments"]
        assert abs(mean - want_mean) <= MOMENT_RTOL * abs(want_mean)
        assert abs(var - want_var) <= MOMENT_RTOL * want_var


# ---- vs the JAX package's mesh -------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _jax_gens(size):
    import randomfield_tpu as rf
    from randomfield_tpu.parallel.mesh import make_mesh as jax_mesh

    mesh = jax_mesh(1, size)
    return mesh, {name: rf.Generator(*SHAPE, grid_spacing=SPACING, mesh=mesh,
                                     sampler=name) for name in RENDERS}


@pytest.mark.parametrize("size", JAX_SIZES)
def test_mesh_fields_match_jax_mesh(tmp_path_factory, size):
    results = _mesh_results(size, tmp_path_factory)
    _, gens = _jax_gens(size)
    tf, nested = gens["threefry"], gens["nested"]
    cases = (
        ("threefry_fixed_flip", tf.generate_fixed_field(
            SEED, smoothing_length=SMOOTHING, apply_lightcone=False,
            flip=True)),
        ("threefry_lpt2", tf.generate_displacement(SEED, order=2)),
        ("nested_field", nested.generate_delta_field(SEED)),
        ("nested_smooth", nested.generate_delta_field(
            SEED, smoothing_length=SMOOTHING, apply_lightcone=False)),
    )
    for key, want in cases:
        assert _max_rel(_x_cat(results, key), np.asarray(want)) <= JAX_TOL, key


@pytest.mark.parametrize("size", JAX_SIZES)
def test_mesh_estimators_match_jax_mesh(tmp_path_factory, size):
    import jax.numpy as jnp

    from randomfield_tpu.validate import bispectrum as jbisp
    from randomfield_tpu.validate import stats as jstats

    results = _mesh_results(size, tmp_path_factory)
    mesh, _ = _jax_gens(size)
    a, b, _ = (jnp.asarray(f) for f in _inputs())
    r = results[-1]
    _assert_bins(_got([r], "poles")[0], jstats.calculate_power_multipoles(
        a, SPACING, NBINS, los_axis=1, window="tsc", mesh=mesh))
    _assert_bins(_got([r], "poles_interlaced")[0],
                 jstats.calculate_power_multipoles(
                     a, SPACING, NBINS, ells=(0, 2), interlaced_with=b,
                     mesh=mesh))
    _assert_bins(_got([r], "cross")[0], jstats.calculate_cross_power(
        a, b, SPACING, NBINS, mesh=mesh))
    _assert_xi(_got([r], "xi")[0], jstats.calculate_correlation(
        a, SPACING, XI_BINS, mesh=mesh), XI_TOL)
    _assert_xi(_got([r], "xi_ell")[0], jstats.calculate_correlation_multipoles(
        a, SPACING, XI_BINS, los_axis=1, mesh=mesh), XI_TOL)
    _assert_bispectrum(_got([r], "bispectrum")[0], jbisp.calculate_bispectrum(
        a, SPACING, nbins=BISP_BINS, mesh=mesh), JAX_BISP_TOL, 0.0,
        JAX_NTRI_TOL)
