"""The slab mesh's mock makers vs the port's single device and vs the JAX
package's mesh programs: paint_sharded, the mesh catalog and FKP spectra,
the lognormal and halo renders, the constrained programs and the ported
pod_survey_catalog example.

Ranks are ``torch.multiprocessing.spawn`` processes in a gloo group whose
rendezvous is a FileStore, as in tests/test_torch_mesh_surface.py: four
ranks at 16^3 are started once per session (under a file lock in the
session's shared temporary directory) when the first test of this file
starts, and run the 4-rank mesh and then, ranks 0-1 on a subgroup, the
2-rank mesh while the JAX programs compile; every rank ``torch.save``s
what it computed (or the error a call raised) and the tests compare them;
one rank runs in process on a mesh without a process group.  Every port
computation here (ranks and single device) uses sigma tables 16 times
finer than the default, as tests/test_torch_examples.py does, so that the
port's renders equal the JAX package's to float32 rounding and the JAX
programs' own bars apply.

Bars against the port's single device:
* paint_sharded: the int64 rows, the total and the contrast bit for bit,
  for every window, with and without the interlacing shift, seam
  particles included; the FKP field's rows bit for bit;
* halo counts bit for bit (and KH's linear form on a field that crosses
  lambda = 10 equal to the whole-grid call only with the all-reduced
  maximum), the gathered halo catalog bit for bit;
* spectra: counts exact, p within 1e-6 of the bin's largest |p_ell| plus
  the shot noise taken off it (the CPU's distributed transform is not
  torch.fft.rfftn's algorithm; an all-reduce reorders the sums);
* lognormal and constrained fields within 1e-6 of max|delta| (bit for bit
  on one rank, where the transforms are the same calls), the Gram matrix
  within 1e-12 (float64 reordering), the measured constraints within 1e-6
  of their largest, the posterior MSE within 1e-12.
Against the JAX package's mesh (make_mesh(data=1, space=P)): the bars of
tests/test_paint_sharded.py and tests/test_constrained.py:257-320; the
lognormal fields within tests/test_lognormal.py:113's bars plus the two
packages' single-device gap; KH on the JAX mesh's own Gaussian render,
slab by slab, equals its halo counts; the pod example's lines within
tests/test_torch_examples.py's bar.
"""

import contextlib
import fcntl
import functools
import io
import os
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import randomfield_tpu_torch as rft  # noqa: E402
from randomfield_tpu_torch.models import halos as th  # noqa: E402
from randomfield_tpu_torch.models import lognormal as tl  # noqa: E402
from randomfield_tpu_torch.models import zeldovich as tz  # noqa: E402
from randomfield_tpu_torch.ops import paint as kp  # noqa: E402
from randomfield_tpu_torch.ops import poisson as kh  # noqa: E402
from randomfield_tpu_torch.ops import sampler  # noqa: E402
from randomfield_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from randomfield_tpu_torch.parallel import paint as pp  # noqa: E402
from randomfield_tpu_torch.validate import fkp  # noqa: E402

SHAPE = (16, 16, 16)
SPACING = 8.0
BOX = SHAPE[0] * SPACING
SEED = 5
FINER = 16
WINDOWS = ("ngp", "cic", "tsc")
SHIFTS = (0.0, SPACING / 2.0)
CONSTRAINTS = [((40.0, 60.0, 70.0), 1.5, 12.0),
               ((100.0, 20.0, 33.0), -0.7, 8.0)]
NOISE = 0.02
SIZES = [1, 2, 4]
SPAWNED = [2, 4]  # one spawn of 4 ranks; ranks 0-1 form the 2-rank mesh
JAX_SIZE = 2
P_RTOL = 1e-6
FIELD_TOL = 1e-6
GRAM_RTOL = 1e-12
JOIN_TIMEOUT_S = 300.0


def fine_tables():
    """The port's grid and box sigma tables FINER times finer (as the
    fixture of tests/test_torch_examples.py); returns the undo."""
    count, dlk = sampler.table_knot_count, sampler.BOX_TABLE_DLK
    sampler.table_knot_count = lambda shape: FINER * (count(shape) - 1) + 1
    sampler.BOX_TABLE_DLK = dlk / FINER

    def undo():
        sampler.table_knot_count, sampler.BOX_TABLE_DLK = count, dlk
    return undo


@pytest.fixture(autouse=True)
def _fine_tables():
    undo = fine_tables()
    yield
    undo()


# ---- the inputs, made from seeds ---------------------------------------------

@functools.lru_cache(maxsize=1)
def _catalog():
    """(float32 (3, n) positions, float32 weights) of a random catalog with
    particles on the box's and every rank's slab seams, on cell faces and
    on cell centres (CIC's and TSC's half-way cases)."""
    rng = np.random.default_rng(21)
    pos = rng.uniform(0.0, BOX, size=(3, 1500))
    seams = np.array([0.0, 1e-3, BOX - 1e-3, 4 * SPACING, 4 * SPACING - 1e-3,
                      8 * SPACING, 8 * SPACING + 1e-3, 12 * SPACING - 1e-3,
                      0.5 * SPACING, 4.5 * SPACING, 8.5 * SPACING,
                      BOX - 0.5 * SPACING, 3.0 * SPACING, 12.0 * SPACING])
    pos[0, :seams.size] = seams
    pos[1, :seams.size] = rng.choice(seams, seams.size)
    w = rng.uniform(0.5, 1.5, size=pos.shape[1]).astype(np.float32)
    return pos.astype(np.float32), w


@functools.lru_cache(maxsize=1)
def _fkp_catalogs():
    rng = np.random.default_rng(9)
    data = rng.uniform(0.0, BOX, size=(3, 800)).astype(np.float32)
    rand = rng.uniform(0.0, BOX, size=(3, 6000)).astype(np.float32)
    return data, rand


@functools.lru_cache(maxsize=1)
def _fields():
    """(a field for the constraint measure and the Wiener data, a field
    whose linear intensity (1 + g) 12 crosses lambda = 10)."""
    rng = np.random.default_rng(4)
    return (rng.standard_normal(SHAPE).astype(np.float32),
            (0.4 * rng.standard_normal(SHAPE)).astype(np.float32))


def _noise_table():
    g = rft.Generator(*SHAPE, grid_spacing=SPACING, device="cpu")
    k = np.geomspace(g.k_min / 2.0, g.k_max * 2.0, 24)
    return np.column_stack([k, np.full_like(k, NOISE * SPACING**3)])


# ---- what every rank computes ---------------------------------------------------

def _attempt(out, key, call):
    """``out[key]``: what ``call()`` returns, or ("error", kind, text)."""
    try:
        out[key] = call()
    except Exception as err:  # the tests check the kind and the text
        out[key] = ("error", type(err).__name__, str(err))


class _NoMax(pmesh.SlabMesh):
    """A slab mesh whose maximum is each rank's own (the fault that the
    all-reduced maximum of KH's state repairs)."""

    def all_reduce_max(self, t):
        return t


def _paint_calls(mesh):
    pos, w = _catalog()
    for window in WINDOWS:
        order = kp.ORDERS[window]
        s = kp.fixed_point_exponent(kp.total_abs_weight(
            torch.as_tensor(pos), torch.as_tensor(w)))
        for shift in SHIFTS:
            yield (f"deposit_{window}_{shift}", lambda: pp.deposit_sharded(
                torch.as_tensor(pos), SHAPE, SPACING, mesh,
                torch.as_tensor(w), order, shift, s))
            yield (f"paint_{window}_{shift}", lambda: pp.paint_sharded(
                pos, SHAPE, SPACING, mesh, w, window, shift))


def _spectra_calls(mesh):
    pos, w = _catalog()
    data, rand = _fkp_catalogs()
    return (
        ("catalog_tsc_interlaced", lambda: tz.catalog_power(
            pos, SPACING, SHAPE, w, nbins=8, window="tsc", interlaced=True,
            mesh=mesh)),
        ("catalog_cic", lambda: tz.catalog_power(
            pos, SPACING, SHAPE, nbins=8, mesh=mesh)),
        ("catalog_poles_interlaced", lambda: tz.catalog_power_multipoles(
            pos, SPACING, SHAPE, w, nbins=8, window="tsc", interlaced=True,
            mesh=mesh)),
        ("fkp_cic", lambda: fkp.fkp_power(
            data, rand, SPACING, SHAPE, nbins=8, window="cic", mesh=mesh,
            device="cpu")),
        ("fkp_interlaced", lambda: fkp.fkp_power(
            data, rand, SPACING, SHAPE, nbins=8, window="tsc",
            interlaced=True, mesh=mesh, device="cpu")),
        ("fkp_poles_interlaced", lambda: fkp.fkp_power_multipoles(
            data, rand, SPACING, SHAPE, nbins=8, ells=(0, 2), window="cic",
            interlaced=True, mesh=mesh, device="cpu")),
        ("fkp_fields", lambda: fkp._fields(
            data, rand, SPACING, SHAPE, 1.0, 1.0, None, None, 0.0, "tsc",
            True, "cpu", mesh, "fkp_power")[:2]),
    )


def _model_calls(mesh, rows):
    """(key, call) of the lognormal, halo and constrained paths; ``rows``
    cuts a whole numpy field to this rank's x slab."""
    kw = dict(device="cpu") if mesh is None else dict(mesh=mesh)
    ln = tl.LognormalGenerator(*SHAPE, SPACING, **kw)
    hg = th.HaloGenerator(*SHAPE, SPACING, nbins_mass=2, **kw)
    g = rft.Generator(*SHAPE, grid_spacing=SPACING, **kw)
    gn = rft.Generator(*SHAPE, grid_spacing=SPACING, sampler="nested", **kw)
    data, lin = _fields()
    table = _noise_table()
    offset = 0 if mesh is None else mesh.rows(SHAPE[0])[0] * 256
    key = [7, 11]
    return (
        ("ln_delta", lambda: ln.generate_delta_field(SEED)),
        ("ln_biased", lambda: ln.generate_biased_field(
            SEED, bias=1.6, apply_lightcone=False)),
        ("ln_fixed", lambda: ln.generate_fixed_field(SEED, flip=True)),
        ("halo_g", lambda: hg.lognormal.gaussian.generate_delta_field(
            SEED, apply_lightcone=False)),
        ("halo_counts", lambda: hg.generate_halo_counts(SEED)),
        ("halo_catalog", lambda: hg.generate_halo_catalog(SEED)),
        ("kh_linear", lambda: kh.poisson_counts(
            torch.as_tensor(rows(lin)), [key], "linear", scale=12.0,
            offset=offset, mesh=mesh)),
        ("kh_linear_nomax", lambda: kh.poisson_counts(
            torch.as_tensor(rows(lin)), [key], "linear", scale=12.0,
            offset=offset, mesh=None if mesh is None else _NoMax(
                mesh.group, mesh.rank, mesh.size, mesh.device))),
        ("con_field", lambda: g.generate_constrained_field(
            SEED, CONSTRAINTS, smoothing_length=4.0)),
        ("con_nested", lambda: gn.generate_constrained_field(
            SEED, CONSTRAINTS, apply_lightcone=True)),
        ("con_mean", lambda: g.constrained_mean_field(CONSTRAINTS)),
        ("con_gram", lambda: g.constraint_matrix(CONSTRAINTS, 4.0)),
        ("con_measure", lambda: g.measure_constraints(rows(data),
                                                      CONSTRAINTS)),
        ("wiener", lambda: g.wiener_filter(rows(data),
                                           NOISE * SPACING**3)),
        ("wiener_table", lambda: g.wiener_filter(rows(data), table)),
        ("posterior", lambda: g.generate_posterior_field(
            3, rows(data), NOISE * SPACING**3)),
        ("posterior_table", lambda: g.generate_posterior_field(
            3, rows(data), table)),
        ("mse", lambda: g.predicted_posterior_mse(NOISE * SPACING**3)),
        ("mse_table", lambda: g.predicted_posterior_mse(table)),
    )


def _pod(mesh):
    """The ported pod_survey_catalog at 16^3 on ``mesh``: (what rank 0
    printed, the returned numbers, the halo catalog it drew)."""
    from randomfield_tpu_torch.examples import pod_survey_catalog

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out = pod_survey_catalog.main(device="cpu", n=SHAPE[0], mesh=mesh)
    hg = th.HaloGenerator(*SHAPE, SPACING, mmin=1e13, mmax=1e15,
                          nbins_mass=2, fit="st", mesh=mesh)
    return printed.getvalue(), out, hg.generate_halo_catalog(seed=1)


def _rank_work(m):
    """What every rank of the mesh ``m`` computes."""
    out = {}
    x0, nx_loc = m.rows(SHAPE[0])

    def rows(field):
        return field[x0:x0 + nx_loc]

    for key, call in _paint_calls(m):
        _attempt(out, key, call)
    pos, w = _catalog()
    _attempt(out, "paint_bad_window", lambda: pp.paint_sharded(
        pos, SHAPE, SPACING, m, w, "spline"))
    _attempt(out, "paint_pencil", lambda: pp.paint_sharded(
        pos, SHAPE, SPACING, pmesh.make_pencil_mesh(1, 2, 2), w))
    for key, call in _spectra_calls(m):
        _attempt(out, key, call)
    for key, call in _model_calls(m, rows):
        _attempt(out, key, call)
    gp = rft.Generator(*SHAPE, grid_spacing=SPACING, mesh=m,
                       sampler="pallas")
    _attempt(out, "pallas_constrained", lambda: gp.generate_constrained_field(
        SEED, CONSTRAINTS))
    _attempt(out, "pallas_measure", lambda: gp.measure_constraints(
        rows(_fields()[0]), CONSTRAINTS))
    if m.size == JAX_SIZE:
        _attempt(out, "pod", lambda: _pod(m))
    return out


def _rank_main(rank, size, store, out_dir):
    """One spawned rank: the work of the ``size``-rank mesh, then ranks 0-1
    of it form the 2-rank mesh on a subgroup (one spawn serves both
    sizes).  Each result lands in ``mesh{n}_rank{r}.pt``; an error in
    ``failed{r}``."""
    # the ranks run beside the xdist workers: one thread each
    torch.set_num_threads(1)
    import torch.distributed as dist

    from randomfield_tpu_torch.parallel import multihost

    fine_tables()
    multihost.initialize("gloo", f"file://{store}", size, rank, "cpu")
    try:
        for n in sorted(SPAWNED, reverse=True):
            group = dist.new_group(list(range(n)))  # every rank takes part
            if rank >= n:
                continue
            out = _rank_work(pmesh.make_mesh(space=n, group=group,
                                             device="cpu"))
            out["jax modules"] = [name for name in sys.modules
                                  if name == "jax" or name.startswith("jax.")]
            path = os.path.join(out_dir, f"mesh{n}_rank{rank}.pt")
            torch.save(out, path + ".tmp")
            os.replace(path + ".tmp", path)
    except BaseException as err:
        with open(os.path.join(out_dir, f"failed{rank}"), "w") as f:
            f.write(repr(err))
        raise
    finally:
        multihost.shutdown()


def _shared_dir(tmp_path_factory):
    """The session's temporary directory, shared by its xdist workers."""
    root = tmp_path_factory.getbasetemp()
    return root.parent if os.environ.get("PYTEST_XDIST_WORKER") else root


_RANKS = []  # the spawn context this process started, if any


def _mesh_dir(tmp_path_factory):
    return _shared_dir(tmp_path_factory) / "torch_mesh_mocks"


@pytest.fixture(autouse=True, scope="module")
def _spawned_ranks(tmp_path_factory):
    """Start the max(SPAWNED) ranks once per session without waiting for
    them (the first of the xdist workers to get here, under a file lock),
    so that they run while this process compiles the JAX programs; the
    process that started them reaps them when its tests of this file end."""
    import torch.multiprocessing as mp

    out = _mesh_dir(tmp_path_factory)
    with open(_shared_dir(tmp_path_factory) / "torch_mesh_mocks.lock",
              "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (out / "started").exists():
            out.mkdir(parents=True, exist_ok=True)
            size = max(SPAWNED)
            _RANKS.append(mp.spawn(
                _rank_main, args=(size, str(out / "store"), str(out)),
                nprocs=size, join=False))
            (out / "started").touch()
    yield
    for ctx in _RANKS:
        try:
            _join(ctx, JOIN_TIMEOUT_S)
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
    _RANKS.clear()


def _join(ctx, seconds):
    """Wait up to ``seconds`` for the spawned ranks; raises if one failed."""
    for _ in range(int(seconds * 10)):
        if ctx.join(timeout=0.1):
            return True
    return False


@functools.lru_cache(maxsize=1)
def _one_rank():
    return [_rank_work(pmesh.make_mesh(space=1, device="cpu"))]


def _mesh_results(size, tmp_path_factory):
    """Every rank's results of a ``size``-rank mesh: one rank in process,
    more from the ranks spawned once per session (waited for here)."""
    if size == 1:
        return _one_rank()
    out = _mesh_dir(tmp_path_factory)
    paths = [out / f"mesh{size}_rank{r}.pt" for r in range(size)]
    for _ in range(int(JOIN_TIMEOUT_S * 10)):
        failed = sorted(out.glob("failed*"))
        if failed:
            pytest.fail(f"a spawned rank failed: {failed[0].read_text()}")
        if all(p.exists() for p in paths):
            return [torch.load(p, weights_only=False) for p in paths]
        if _RANKS:
            _RANKS[0].join(timeout=0.1)  # raises if a rank died
        else:
            time.sleep(0.1)
    pytest.fail(f"the {size} ranks did not finish in {JOIN_TIMEOUT_S} s")


@functools.lru_cache(maxsize=1)
def _single():
    """The single-device results of the ranks' calls, once per process."""
    out = {}
    pos, w = _catalog()
    for window in WINDOWS:
        order = kp.ORDERS[window]
        s = kp.fixed_point_exponent(kp.total_abs_weight(
            torch.as_tensor(pos), torch.as_tensor(w)))
        for shift in SHIFTS:
            out[f"deposit_{window}_{shift}"] = kp.deposit(
                torch.as_tensor(pos), SHAPE, SPACING, torch.as_tensor(w),
                order, shift, s)
            out[f"paint_{window}_{shift}"] = kp.paint(
                torch.as_tensor(pos), SHAPE, SPACING, torch.as_tensor(w),
                order, shift)
    for key, call in _spectra_calls(None):
        out[key] = call()
    for key, call in _model_calls(None, lambda field: field):
        if key != "kh_linear_nomax":
            out[key] = call()
    return out


def _got(results, key):
    """Every rank's value of ``key``; fails on a rank's error."""
    vals = [r[key] for r in results]
    for v in vals:
        if isinstance(v, tuple) and v and isinstance(v[0], str) and (
                v[0] == "error"):
            pytest.fail(f"{key} raised on a rank: {v[1]}: {v[2]}")
    return vals


def _x_cat(results, key, dim=-3):
    return torch.cat(_got(results, key), dim=dim)


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _assert_bins(got, want, rtol, shot=0.0):
    """Counts exact; k within ``rtol``, p within ``rtol`` of its bin's
    largest |p_ell| plus ``shot`` (the shot noise taken off the monopole:
    the difference is the transforms', on the spectrum before the
    subtraction)."""
    k, p, n = (np.asarray(a, np.float64) for a in got[:3])
    kw, pw, nw = (np.asarray(a, np.float64) for a in want[:3])
    np.testing.assert_array_equal(n, nw)
    live = nw > 0
    assert live.sum() >= 3
    raw = np.abs(pw).reshape(-1, pw.shape[-1]).max(axis=0)[live] + shot
    assert np.all(np.abs(p[..., live] - pw[..., live]) <= rtol * raw)
    np.testing.assert_allclose(k[live], kw[live], rtol=rtol)


def _fkp_bins(est):
    p = est.p
    if isinstance(p, dict):
        p = np.stack([p[e] for e in sorted(p)])
    return est.k, p, est.n_modes


# ---- vs the JAX package's mesh ------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _jax_mesh():
    from randomfield_tpu.parallel.mesh import make_mesh

    return make_mesh(data=1, space=JAX_SIZE)


def test_paint_and_spectra_match_jax_mesh(tmp_path_factory):
    from randomfield_tpu.models import zeldovich as jz
    from randomfield_tpu.parallel.paint import paint_sharded
    from randomfield_tpu.validate import fkp as jfkp

    mesh = _jax_mesh()
    pos, w = _catalog()
    painted = {window: paint_sharded(pos, SHAPE, SPACING, mesh, weights=w,
                                     window=window) for window in WINDOWS}
    k, p, n = jz.catalog_power(pos, SPACING, shape=SHAPE, weights=w, nbins=8,
                               window="tsc", interlaced=True, mesh=mesh)
    data, rand = _fkp_catalogs()
    want = jfkp.fkp_power(data, rand, SPACING, SHAPE, nbins=8, window="cic",
                          mesh=mesh)
    results = _mesh_results(JAX_SIZE, tmp_path_factory)
    for window, (d, m) in painted.items():  # test_paint_sharded.py's bars
        got = _x_cat([{"d": r[f"paint_{window}_0.0"][0]} for r in results],
                     "d")
        np.testing.assert_allclose(got.numpy(), np.asarray(d), rtol=1e-4,
                                   atol=1e-5)
        assert np.isclose(results[0][f"paint_{window}_0.0"][1], m, rtol=1e-5)
    kg, pg, ng = _got(results, "catalog_tsc_interlaced")[0]
    np.testing.assert_allclose(ng, n, rtol=1e-6)
    live = n > 0
    np.testing.assert_allclose(kg[live], k[live], rtol=1e-5)
    np.testing.assert_allclose(pg[live], p[live], rtol=2e-3,
                               atol=1e-4 * np.nanmax(np.abs(p)))
    got = _got(results, "fkp_cic")[0]
    np.testing.assert_allclose(got.n_modes, want.n_modes, rtol=1e-6)
    assert np.isclose(got.alpha, want.alpha, rtol=1e-6)
    assert np.isclose(got.shot_noise, want.shot_noise, rtol=1e-5)
    live = want.n_modes > 0
    np.testing.assert_allclose(
        got.p[live], want.p[live], rtol=2e-3,
        atol=1e-4 * np.nanmax(np.abs(want.p) + want.shot_noise))


def test_lognormal_and_halos_match_jax_mesh(tmp_path_factory):
    """The lognormal fields: the port's mesh field differs from the JAX
    mesh's by no more than the two packages' single-device fields differ
    (the port's transformed table is binned in float32, the reference's
    in float64: tests/test_torch_lognormal.py holds them within 1e-3 of
    the peak) plus tests/test_lognormal.py's bars of the JAX mesh program.
    KH (its plain version, on the CPU) on the JAX mesh's own Gaussian
    render equals the mesh's halo counts (tests/test_paint_sharded.py's
    equality; the port's slabs equal its whole grid, as the tests below
    hold)."""
    import jax

    from randomfield_tpu.models import halos as jh
    from randomfield_tpu.models import lognormal as jl

    mesh = _jax_mesh()
    hj = jh.HaloGenerator(*SHAPE, grid_spacing=SPACING, nbins_mass=2,
                          mesh=mesh)
    gen = hj.lognormal  # the default power's lognormal scene on the mesh
    ref = jl.LognormalGenerator(*SHAPE, grid_spacing=SPACING)
    fields = {key: (np.asarray(jax.device_get(call(gen))),
                    np.asarray(call(ref)), bars) for key, call, bars in (
        ("ln_delta", lambda g: g.generate_delta_field(SEED), (2e-4, 2e-5)),
        ("ln_biased", lambda g: g.generate_biased_field(
            SEED, bias=1.6, apply_lightcone=False), (2e-4, 3e-4)))}
    g = np.asarray(jax.device_get(hj.lognormal.gaussian.generate_delta_field(
        SEED, apply_lightcone=False)))
    counts = np.asarray(jax.device_get(hj.generate_halo_counts(SEED)))
    results = _mesh_results(JAX_SIZE, tmp_path_factory)
    single = _single()
    for key, (want, alone, (rtol, atol)) in fields.items():
        gap = np.abs(single[key].numpy() - alone)
        assert gap.max() <= 1e-3 * np.abs(want).max(), key
        got = _x_cat(results, key).numpy()
        assert np.all(np.abs(got - want)
                      <= gap + atol + rtol * np.abs(want) + 1e-6), key
    got = kh.poisson_counts(torch.as_tensor(g), th.halo_keys(SEED, 2),
                            "lognormal", lam0=hj.nbar * hj._cell_volume,
                            bias=hj.bias, sigma_g2=hj.lognormal.sigma_g2)
    np.testing.assert_array_equal(got.numpy(), counts)


def test_constrained_programs_match_jax_mesh(tmp_path_factory):
    """tests/test_constrained.py:257-320's bars on a JAX_SIZE-rank mesh."""
    import jax

    import randomfield_tpu as rf

    gm = rf.Generator(*SHAPE, grid_spacing=SPACING, mesh=_jax_mesh())

    def host(x):
        return np.asarray(jax.device_get(x))

    data = _fields()[0]
    gram = host(gm.constraint_matrix(CONSTRAINTS, 4.0))
    ref = host(gm.generate_constrained_field(SEED, CONSTRAINTS,
                                             smoothing_length=4.0))
    mean = host(gm.constrained_mean_field(CONSTRAINTS))
    gamma = host(gm.measure_constraints(data, CONSTRAINTS))
    noisy = {key: (host(gm.wiener_filter(data, noise)),
                   host(gm.generate_posterior_field(3, data, noise)),
                   host(gm.predicted_posterior_mse(noise)))
             for key, noise in (("", NOISE * SPACING**3),
                                ("_table", _noise_table()))}
    results = _mesh_results(JAX_SIZE, tmp_path_factory)
    np.testing.assert_allclose(_got(results, "con_gram")[0], gram, rtol=2e-4)
    np.testing.assert_allclose(_x_cat(results, "con_field").numpy(), ref,
                               atol=6e-3 * ref.std(), rtol=2e-3)
    np.testing.assert_allclose(_x_cat(results, "con_mean").numpy(), mean,
                               atol=1e-3 * np.abs(mean).max())
    np.testing.assert_allclose(_got(results, "con_measure")[0], gamma,
                               atol=4e-3)
    for key, (rec, post, mse) in noisy.items():
        np.testing.assert_allclose(_x_cat(results, "wiener" + key).numpy(),
                                   rec, atol=2e-4 * rec.std(), rtol=1e-3)
        np.testing.assert_allclose(
            _x_cat(results, "posterior" + key).numpy(), post,
            atol=1e-3 * post.std(), rtol=1e-3)
        np.testing.assert_allclose(_got(results, "mse" + key)[0], mse,
                                   rtol=1e-4)


# ---- paint_sharded ---------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("window", WINDOWS)
def test_paint_sharded_equals_single_device(tmp_path_factory, size, window):
    """The int64 rows and the total, the contrast and the mean: the
    single-device deposit's and paint's bit for bit, seams included."""
    results = _mesh_results(size, tmp_path_factory)
    single = _single()
    for shift in SHIFTS:
        key = f"{window}_{shift}"
        got = _got(results, f"deposit_{key}")
        want = single[f"deposit_{key}"]
        assert torch.equal(torch.cat([r for r, _ in got]), want), key
        assert all(total == int(want.sum()) for _, total in got)
        delta = _x_cat([{"d": r[f"paint_{key}"][0]} for r in results], "d")
        assert delta.dtype == torch.float32
        assert torch.equal(delta, single[f"paint_{key}"][0]), key
        assert all(r[f"paint_{key}"][1] == single[f"paint_{key}"][1]
                   for r in results)


@pytest.mark.parametrize("size", SIZES)
def test_paint_sharded_conserves_mass(tmp_path_factory, size):
    results = _mesh_results(size, tmp_path_factory)
    _, w = _catalog()
    for window in WINDOWS:
        delta = _x_cat([{"d": r[f"paint_{window}_0.0"][0]} for r in results],
                       "d")
        mean = results[0][f"paint_{window}_0.0"][1]
        total = float(((delta.double() + 1.0) * mean).sum())
        assert abs(total - float(w.astype(np.float64).sum())) <= (
            1e-5 * total)


@pytest.mark.parametrize("size", SIZES)
def test_paint_sharded_refusals(tmp_path_factory, size):
    r = _mesh_results(size, tmp_path_factory)[0]
    assert r["paint_bad_window"][:2] == ("error", "ValueError")
    assert "window must be 'ngp', 'cic' or 'tsc'" in r["paint_bad_window"][2]
    assert r["paint_pencil"][:2] == ("error", "NotImplementedError")
    assert "Queue 1 item 5" in r["paint_pencil"][2]


# ---- the catalog and FKP spectra -------------------------------------------------

@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("key", ["catalog_tsc_interlaced", "catalog_cic",
                                 "catalog_poles_interlaced", "fkp_cic",
                                 "fkp_interlaced", "fkp_poles_interlaced"])
def test_mesh_spectra_equal_single_device(tmp_path_factory, size, key):
    results = _mesh_results(size, tmp_path_factory)
    want = _single()[key]
    if key.startswith("fkp"):
        shot = want.shot_noise
        want = _fkp_bins(want)
    else:  # the counts' shot noise of the weighted catalogs
        shot = (tz.shot_noise(_catalog()[1], BOX**3) if "interlaced" in key
                else 0.0)
    for got in _got(results, key):  # every rank holds the whole result
        if key.startswith("fkp"):
            assert got.alpha == _single()[key].alpha
            assert got.shot_noise == _single()[key].shot_noise
            got = _fkp_bins(got)
        _assert_bins(got, want, P_RTOL, shot)


@pytest.mark.parametrize("size", SIZES)
def test_mesh_fkp_field_equals_single_device_rows(tmp_path_factory, size):
    results = _mesh_results(size, tmp_path_factory)
    f, f2 = _single()["fkp_fields"]
    got = _got(results, "fkp_fields")
    assert torch.equal(torch.cat([g[0] for g in got]), f)
    assert torch.equal(torch.cat([g[1] for g in got]), f2)


# ---- lognormal and halos -------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("key", ["ln_delta", "ln_biased", "ln_fixed"])
def test_mesh_lognormal_equals_single_device(tmp_path_factory, size, key):
    results = _mesh_results(size, tmp_path_factory)
    got, want = _x_cat(results, key), _single()[key]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _max_rel(got, want) <= FIELD_TOL
    if size == 1:
        assert torch.equal(got, want)


@pytest.mark.parametrize("size", SIZES)
def test_mesh_halo_counts_equal_single_device(tmp_path_factory, size):
    """KH's slabs at their global cells: the counts equal the whole-grid
    call on the gathered Gaussian render bit for bit, and the single
    device's counts and catalog."""
    results = _mesh_results(size, tmp_path_factory)
    single = _single()
    counts = _x_cat(results, "halo_counts", dim=1)
    g = _x_cat(results, "halo_g")
    hg = th.HaloGenerator(*SHAPE, SPACING, nbins_mass=2, device="cpu")
    whole = kh.poisson_counts(g, th.halo_keys(SEED, 2), "lognormal",
                              lam0=hg.nbar * hg._cell_volume, bias=hg.bias,
                              sigma_g2=hg.lognormal.sigma_g2)
    assert torch.equal(counts, whole)
    assert torch.equal(counts, single["halo_counts"])
    for pos, mass in _got(results, "halo_catalog"):  # every rank
        np.testing.assert_array_equal(pos, single["halo_catalog"][0])
        np.testing.assert_array_equal(mass, single["halo_catalog"][1])
    if size == SPAWNED[-1]:  # the ranks ran the port alone
        assert not any(r["jax modules"] for r in results)


@pytest.mark.parametrize("size", SIZES)
def test_kh_loop_count_is_the_whole_grids(tmp_path_factory, size):
    """On a field that crosses lambda = 10 the mesh counts equal the
    whole-grid call only with the all-reduced maximum: each rank's own
    maximum of first acceptances ends its rejection loop early."""
    results = _mesh_results(size, tmp_path_factory)
    want = _single()["kh_linear"]
    got = _x_cat(results, "kh_linear", dim=1)
    assert torch.equal(got, want)
    alone = _x_cat(results, "kh_linear_nomax", dim=1)
    assert torch.equal(alone, want) == (size == 1)


# ---- the constrained programs ------------------------------------------------------

@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("key", ["con_field", "con_nested", "con_mean",
                                 "wiener", "wiener_table", "posterior",
                                 "posterior_table"])
def test_mesh_constrained_fields_equal_single_device(tmp_path_factory, size,
                                                     key):
    results = _mesh_results(size, tmp_path_factory)
    got, want = _x_cat(results, key), _single()[key]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _max_rel(got, want) <= FIELD_TOL, key
    if size == 1 and key.startswith("con"):
        assert torch.equal(got, want)


@pytest.mark.parametrize("size", SIZES)
def test_mesh_constrained_numbers_equal_single_device(tmp_path_factory, size):
    results = _mesh_results(size, tmp_path_factory)
    single = _single()
    for gram in _got(results, "con_gram"):
        np.testing.assert_allclose(gram, single["con_gram"], rtol=GRAM_RTOL)
    for gamma in _got(results, "con_measure"):
        assert _max_rel(gamma, single["con_measure"]) <= FIELD_TOL
    for key in ("mse", "mse_table"):
        for mse in _got(results, key):
            assert abs(mse - single[key]) <= GRAM_RTOL * single[key]


@pytest.mark.parametrize("size", SIZES)
def test_mesh_constrained_refusals_match_jax(tmp_path_factory, size):
    """A pallas mesh scene refuses what reads its sigma grid with the JAX
    package's _mesh_sigmas ValueError; its measure_constraints runs."""
    r = _mesh_results(size, tmp_path_factory)
    first = r[0]["pallas_constrained"]
    assert first[:2] == ("error", "ValueError")
    assert "plain renders only" in first[2]
    gamma = _got(r, "pallas_measure")
    np.testing.assert_allclose(gamma[0], _single()["con_measure"],
                               rtol=FIELD_TOL, atol=FIELD_TOL)


def _jax_pod(n, positions):
    """examples/pod_survey_catalog.py at grid ``n`` on a JAX_SIZE-rank JAX
    mesh, its halo catalog the port's (``positions``; the two packages'
    float32 intensities may round a count across a tie, as
    tests/test_torch_examples.py's mock_catalog replay notes)."""
    from randomfield_tpu.models.halos import HaloGenerator
    from randomfield_tpu.validate.fkp import fkp_power

    spacing = 8.0
    box = n * spacing
    hg = HaloGenerator(n, n, n, grid_spacing=spacing, mmin=1e13, mmax=1e15,
                       nbins_mass=2, fit="st", mesh=_jax_mesh())
    print(f"catalog: {len(positions)} halos "
          f"(expected {hg.expected_counts().sum():.0f}), "
          f"biases {np.round(hg.bias, 2)}")
    rng = np.random.RandomState(99)
    randoms = rng.uniform(0, box, size=(3, 20 * len(positions))).astype(
        np.float32)
    est = fkp_power(positions.astype(np.float32).T, randoms, spacing,
                    (n, n, n), nbins=10, window="tsc", mesh=_jax_mesh())
    k_exp, p_exp, cnt = hg.predicted_combined_power(nbins=10,
                                                    shot_noise=False)
    print(f"alpha {est.alpha:.4f}, shot noise {est.shot_noise:.1f} (Mpc/h)^3")
    print("bin  k          P_FKP        P_model")
    for i in range(len(est.k)):
        if est.n_modes[i] > 0 and np.isfinite(est.p[i]):
            print(f"{i:3d}  {est.k[i]:8.4f}  {est.p[i]:11.1f}  "
                  f"{p_exp[i]:11.1f}")


def test_pod_example_matches_jax_script(tmp_path_factory, capsys):
    """The ported pod_survey_catalog on a JAX_SIZE-rank gloo mesh: rank 0
    prints the JAX script's lines (on the same halo catalog) within
    tests/test_torch_examples.py's bar, the other ranks print nothing, and
    every rank returns the same finite numbers."""
    from test_torch_cli import _assert_same_lines

    results = _mesh_results(JAX_SIZE, tmp_path_factory)
    pods = _got(results, "pod")
    printed, out, (positions, _) = pods[0]
    assert all(p[0] == "" for p in pods[1:])
    for key, value in out.items():
        value = np.asarray(value, np.float64)
        assert np.isfinite(value).all(), key
        for other in pods[1:]:
            np.testing.assert_array_equal(np.asarray(other[1][key],
                                                     np.float64), value)
    _jax_pod(SHAPE[0], positions)
    _assert_same_lines(printed, capsys.readouterr().out)
