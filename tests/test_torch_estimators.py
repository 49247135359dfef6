"""The port's Fourier-space estimators and KB's plain version vs the JAX
package's validate/stats.py, on the same numpy arrays.

Counts are compared exactly: both search the same float32 edges with the
same float32 |k| ((kx^2 + ky^2) + kz^2 of float32 k vectors).  Sums within
1e-5 relative: the JAX package contracts float32 terms against a one-hot
matrix at HIGHEST precision, the port adds them in float64; the window and
interlacing phase tables are float64 rounded once to float32 in the port,
float32 sin/cos in the JAX package.  KB's walk (csrc/bin_spectrum.cu: warps
over lines, lanes over kz, the bin carried along kz, runs flushed when the
bin changes) is replayed in Python and held to the plain version: counts
exact, sums within 1e-12 (float64 additions in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import randomfield_tpu as rf  # noqa: E402
from randomfield_tpu.validate import stats as jstats  # noqa: E402
from randomfield_tpu_torch.ops import binning  # noqa: E402
from randomfield_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from randomfield_tpu_torch.validate import stats  # noqa: E402

SPACING = 8.0
SHAPE = (16, 12, 10)
ODD = (16, 16, 15)
NBINS = 8
SUM_RTOL = 1e-5
WALK_RTOL = 1e-12


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _assert_bins(got, want, rtol=SUM_RTOL):
    """(k, p, n) triples: counts exact, the rest within rtol where
    populated, NaN where empty."""
    k, p, n = (np.asarray(a, np.float64) for a in got)
    kw, pw, nw = (np.asarray(a, np.float64) for a in want)
    np.testing.assert_array_equal(n, nw)
    live = nw > 0
    assert live.sum() >= 3
    scale = np.abs(pw[..., live]).max()
    np.testing.assert_allclose(p[..., live], pw[..., live], rtol=rtol,
                               atol=rtol * scale)
    kl = live if k.shape == live.shape else nw.sum(axis=-1) > 0
    np.testing.assert_allclose(k[kl], kw[kl], rtol=rtol)
    assert np.all(np.isnan(p[..., ~live]))


# ---- the estimators against the JAX package, computed once a module ---------

CASES = {
    "power": lambda m, d, d2, s: m.calculate_power(d, SPACING, NBINS),
    "power_cic": lambda m, d, d2, s: m.calculate_power(d, SPACING, NBINS,
                                                       window="cic"),
    "power_interlaced_tsc": lambda m, d, d2, s: m.calculate_power(
        d, SPACING, NBINS, window="tsc", interlaced_with=d2),
    "poles": lambda m, d, d2, s: m.calculate_power_multipoles(d, SPACING,
                                                              NBINS),
    "poles_x_interlaced_ngp": lambda m, d, d2, s: m.calculate_power_multipoles(
        d, SPACING, NBINS, ells=(2, 4), los_axis=0, window="ngp",
        interlaced_with=d2),
    "wedges_y": lambda m, d, d2, s: m.calculate_power_wedges(
        d, SPACING, NBINS, nmu=3, los_axis=1),
    "wedges_cic_interlaced": lambda m, d, d2, s: m.calculate_power_wedges(
        d, SPACING, NBINS, nmu=4, window="cic", interlaced_with=d2),
    "cross": lambda m, d, d2, s: m.calculate_cross_power(d, d2, SPACING,
                                                         NBINS),
    "masked": lambda m, d, d2, s: m.calculate_masked_power(d, s, SPACING,
                                                           NBINS),
}


def _mask(shape):
    return (np.random.default_rng(9).uniform(size=shape) > 0.3).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_results():
    out = {}
    for shape in (SHAPE, ODD):
        d, d2 = _fields(shape, 1)
        mask = _mask(shape)
        for name, fn in CASES.items():
            out[shape, name] = fn(jstats, jnp.asarray(d), jnp.asarray(d2),
                                  mask)
    return out


@pytest.mark.parametrize("shape", [SHAPE, ODD])
@pytest.mark.parametrize("name", list(CASES))
def test_estimator_matches_jax(jax_results, shape, name):
    d, d2 = _fields(shape, 1)
    got = CASES[name](stats, torch.as_tensor(d), torch.as_tensor(d2),
                      torch.as_tensor(_mask(shape)))
    _assert_bins(got, jax_results[shape, name])


def test_cross_of_a_field_with_itself_is_its_power():
    d, _ = _fields(SHAPE, 2)
    t = torch.as_tensor(d)
    for a, b in zip(stats.calculate_cross_power(t, t, SPACING, NBINS),
                    stats.calculate_power(t, SPACING, NBINS)):
        np.testing.assert_array_equal(a, b)


def test_wedge_average_is_the_power():
    d, _ = _fields(SHAPE, 3)
    t = torch.as_tensor(d)
    k, p, n = stats.calculate_power_wedges(t, SPACING, NBINS, nmu=5)
    kp, pp, npp = stats.calculate_power(t, SPACING, NBINS)
    np.testing.assert_array_equal(n.sum(axis=1), npp)
    live = npp > 0
    avg = np.nansum(p * n, axis=1) / n.sum(axis=1)
    np.testing.assert_allclose(avg[live], pp[live], rtol=1e-12)
    np.testing.assert_allclose(k[live], kp[live], rtol=1e-12)


@pytest.mark.parametrize("los_axis", [0, 2])
def test_grid_binners_match_jax(los_axis):
    pg = np.random.default_rng(4).uniform(
        1.0, 2.0, size=(ODD[0], ODD[1], ODD[2] // 2 + 1)).astype(np.float32)
    _assert_bins(stats.bin_power_multipoles_grid(torch.as_tensor(pg), ODD,
                                                 SPACING, NBINS,
                                                 los_axis=los_axis),
                 jstats.bin_power_multipoles_grid(jnp.asarray(pg), ODD,
                                                  SPACING, NBINS,
                                                  los_axis=los_axis))
    _assert_bins(stats.bin_power_wedges_grid(torch.as_tensor(pg), ODD,
                                             SPACING, NBINS, nmu=3,
                                             los_axis=los_axis),
                 jstats.bin_power_wedges_grid(jnp.asarray(pg), ODD, SPACING,
                                              NBINS, nmu=3, los_axis=los_axis))


def test_predicted_masked_power_matches_jax():
    mask = _mask(SHAPE)
    power = rf.load_default_power()
    want = jstats.predicted_masked_power(power, mask, SPACING, NBINS)
    got = stats.predicted_masked_power(power, torch.as_tensor(mask), SPACING,
                                       NBINS)
    _assert_bins(got, want)


@pytest.mark.parametrize("los_axis", [0, 2])
def test_power_1d_matches_jax(los_axis):
    d, _ = _fields(ODD, 5)
    k, p = stats.calculate_power_1d(torch.as_tensor(d), SPACING, los_axis)
    kw, pw = jstats.calculate_power_1d(jnp.asarray(d), SPACING, los_axis)
    np.testing.assert_array_equal(k, kw)
    np.testing.assert_allclose(p, pw, rtol=SUM_RTOL)
    power = rf.load_default_power()
    k, e = stats.predicted_power_1d(power, ODD, SPACING, los_axis,
                                    smoothing_length=6.0, device="cpu")
    kw, ew = jstats.predicted_power_1d(power, ODD, SPACING, los_axis,
                                       smoothing_length=6.0)
    np.testing.assert_array_equal(k, kw)
    np.testing.assert_allclose(e, ew, rtol=SUM_RTOL)


# ---- KB's walk, replayed ------------------------------------------------------

def kb_walk(kind, arrays, shape, spacing, edges, max_blocks, y_off=0,
            factor=1.0, order=0, ells=None, nmu=None, los_axis=2, warps=4):
    """csrc/bin_spectrum.cu's walk (:func:`kb_spans`) on the plain
    version's per-mode terms, for the geometry pass's values (1 and |k|)
    and the data pass's; as bin_spectrum returns them."""
    nx, ny, nz = shape
    ny_loc = arrays[0].shape[1]
    nbins = len(edges) - 1
    km, key, w, vals = binning.mode_terms(kind, arrays, shape, spacing, edges,
                                          0, nx, y_off, factor, order, ells,
                                          nmu, los_axis)
    km, key, w = km.numpy(), key.numpy(), w.numpy()
    vals = [v.numpy().astype(np.float64) for v in vals]
    kvec = binning.axis_tables(shape, float(spacing), "cpu")[0].numpy()
    kx, ky, kzv = kvec[:nx], kvec[nx:nx + ny], kvec[nx + ny:]
    thr = np.append(binning.edge_thresholds(edges), np.float32(np.inf))

    def k2_of(x, yl):
        kxy2 = np.float32(kx[x] * kx[x]) + np.float32(
            ky[y_off + yl] * ky[y_off + yl])
        return (kxy2 + kzv * kzv).astype(np.float32)

    nb = nbins * (nmu or 1)
    rows = nx * ny_loc
    n_blocks = max(1, min(max_blocks, -(-rows // 4)))
    terms = [np.ones(key.shape)] + vals + [km.astype(np.float64)]
    sums = kb_spans(k2_of, thr, nbins, nz // 2 + 1, rows, ny_loc, key, w,
                    terms, nb, n_blocks, warps, nmu)
    out = np.zeros((len(vals), 3, nb + 1))
    out[:, 0, :nb] = sums[0]
    out[:, 1, :nb] = sums[1:1 + len(vals)]
    out[:, 2, :nb] = sums[-1]
    return out


def kb_spans(k2_of, thr, nbins, nzh, rows, ny_loc, key, w, vals, nb,
             n_blocks, warps, nmu):

    def count(k2):
        return int(np.searchsorted(thr[:nbins + 1], k2, side="right"))

    """The data pass's walk: a line's kz in spans of consecutive kz (a lane
    of the line's warp each); a lane's count
    started by the thresholds' search at its first kz and carried, its
    runs kept (the current and two done) until the line's end, or until a
    lane needs a fourth, when the warp adds the done ones; at the line's
    end every run, key by key ascending.  On a simple line (no wedges,
    every span across one edge at most) the kernel takes each count as the
    span's first or one more: checked here.  Each mode visited once, its key
    checked against the plain search; the value sums (len(vals), nb)."""
    tiles = -(-rows // 4)
    acc = np.zeros((n_blocks, warps, len(vals), nb))
    seen = np.zeros(key.shape, np.int64)
    for b in range(n_blocks):
        for wp in range(warps):
            lines = [4 * t + rr for t in range(b, tiles, n_blocks)
                     for rr in range(wp, 4, warps) if 4 * t + rr < rows]
            for r in lines:
                x, yl = divmod(r, ny_loc)
                k2 = k2_of(x, yl)
                zb, ze = 0, nzh
                span = (ze - zb + 31) // 32
                runs = [[] for _ in range(32)]  # (key, sums); the last current
                # a simple line (no wedges; every span across one edge at
                # most): each count is the span's first, or one more past
                # the first's threshold
                ends = [(z, min(z + span, ze) - 1) for z in
                        range(zb, zb + 32 * span, span) if z < ze]
                cnts = [[int(np.searchsorted(thr[:nbins + 1], k2[z],
                                             side="right")) for z in e]
                        for e in ends]
                if not nmu and all(b - a <= 1 for a, b in cnts):
                    for (za, zz), (ca, _) in zip(ends, cnts):
                        for z in range(za, zz + 1):
                            assert count(k2[z]) == ca + (k2[z] >= thr[ca])

                def add(keep):
                    """Add every lane's runs but its last ``keep``, key by
                    key ascending, and drop them."""
                    done = [rl[:len(rl) - keep] for rl in runs]
                    for kk in sorted({k for d in done for k, _ in d}):
                        for d in done:
                            for k, v in d:
                                if k == kk:
                                    acc[b, wp, :, kk] += v
                    for lane in range(32):
                        runs[lane] = runs[lane][len(done[lane]):]

                for i in range(max(span, 0)):
                    changes = {}
                    for lane in range(32):
                        z = zb + lane * span + i
                        if i >= min(span, ze - zb - lane * span) or z >= ze:
                            continue
                        c = int(np.searchsorted(thr[:nbins + 1],
                                                k2[zb + lane * span],
                                                side="right"))
                        while k2[z] >= thr[c]:
                            c += 1
                        m = (x, yl, z)
                        seen[m] += 1
                        valid = 1 <= c <= nbins
                        assert valid == (w[m] > 0)
                        if not valid:
                            continue
                        kk = (c - 1) * nmu + key[m] % nmu if nmu else c - 1
                        assert kk == key[m]
                        changes[lane] = (kk, m)
                    full = [lane for lane, (kk, _) in changes.items()
                            if runs[lane] and runs[lane][-1][0] != kk
                            and len(runs[lane]) == 3]
                    if full:
                        add(1)
                    for lane, (kk, m) in changes.items():
                        if not runs[lane] or runs[lane][-1][0] != kk:
                            runs[lane].append((kk, np.zeros(len(vals))))
                        for e, v in enumerate(vals):
                            runs[lane][-1][1][e] += w[m] * v[m]
                add(0)
    assert np.all(seen[w > 0] == 1) and np.all(seen <= 1)
    return acc.sum(axis=1).sum(axis=0)


WALKS = [
    ("auto", (40, 12, 20), {}, 64),
    ("auto", (16, 12, 70), dict(order=2, factor=0.37), 2),
    ("cross", (16, 12, 9), dict(ells=(0, 2, 4), los_axis=1, warps=2), 1),
    ("interlaced", (8, 16, 66), dict(nmu=3, los_axis=2, order=3), 3),
    ("grid", (16, 16, 15), dict(nmu=4, los_axis=0, warps=1), 2),
    ("grid", (12, 16, 16), dict(ells=(4, 2), los_axis=2), 64),
    ("auto", (16, 8, 16), dict(y_off=4), 1),
    ("auto", (5, 13, 34), dict(y_off=2), 3),
    ("cross", (6, 10, 130), dict(nmu=4, los_axis=0, warps=2), 4),
    ("auto", (8, 8, 64), dict(ells=(0, 2), warps=1), 2),
]


@pytest.mark.parametrize("shape,spacing,nbins", [
    ((1024, 1024, 1024), 2.0, 32), ((64, 32, 64), 8.0, 12),
    ((16, 16, 64), 8.0, 1024), ((3, 9, 30), 8.0, 12)])
def test_edge_thresholds_are_the_edge_search(shape, spacing, nbins):
    """KB's bin: the count of thresholds at or below a float32 k^2 is the
    count of float32 edges below its correctly rounded float32 square root
    (numpy's, as the card's sqrtf), on random k^2 and on each threshold's
    neighbours."""
    edges, _ = stats.bin_setup(shape, spacing, nbins)
    thr = binning.edge_thresholds(edges)
    e32 = edges.astype(np.float32)
    rng = np.random.default_rng(nbins)
    k2 = np.concatenate([
        rng.uniform(0, (1.2 * e32[-1]) ** 2, 20000).astype(np.float32),
        np.nextafter(thr, np.float32(0)), thr,
        np.nextafter(thr, np.float32(np.inf))])
    np.testing.assert_array_equal(
        np.searchsorted(thr, k2, side="right"),
        np.searchsorted(e32, np.sqrt(k2), side="left"))


@pytest.mark.parametrize("kind,shape,kw,max_blocks", WALKS)
def test_kb_walk_matches_plain(kind, shape, kw, max_blocks):
    nx, ny, nz = shape
    rng = np.random.default_rng(6)
    rows = ny - kw.get("y_off", 0)
    n_arr = binning.KINDS[kind][1]
    arrays = [torch.as_tensor(rng.normal(size=(nx, rows, nz // 2 + 1))
                              .astype(np.float32)) for _ in range(n_arr)]
    if kind == "grid":
        arrays = [a.abs() for a in arrays]
    edges, _ = stats.bin_setup(shape, SPACING, 6)
    plain_kw = {k: v for k, v in kw.items() if k != "warps"}
    want = binning.bin_spectrum_plain(kind, arrays, shape, SPACING, edges,
                                      **plain_kw).numpy()
    got = kb_walk(kind, arrays, shape, SPACING, edges, max_blocks, **kw)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=WALK_RTOL,
                               atol=WALK_RTOL * np.abs(want[:, 1:]).max())
    assert np.all(want[:, :, -1] == 0)  # the masked column adds nothing
    # the CPU wrapper is the plain version
    np.testing.assert_array_equal(
        binning.bin_spectrum(kind, arrays, shape, SPACING, edges,
                             **plain_kw).numpy(), want)


def test_bin_spectrum_refuses_what_it_does_not_take():
    shape = (8, 8, 8)
    re = torch.zeros((8, 8, 5))
    edges, _ = stats.bin_setup(shape, SPACING, 4)
    for args, kw, what in (
            (("fft", (re, re)), {}, "unknown kind"),
            (("cross", (re, re)), {}, "takes 4"),
            (("auto", (re, re.double())), {}, "float32"),
            (("auto", (re, re[:, :4])), {}, "float32"),
            (("auto", (re, re)), dict(ells=(0,), nmu=2), "not both"),
            (("auto", (re, re)), dict(ells=(1,)), "ells"),
            (("auto", (re, re)), dict(y_off=2), "outside")):
        with pytest.raises(ValueError, match=what):
            binning.bin_spectrum(*args, shape, SPACING, edges, **kw)


def test_estimators_refuse_meshes_and_bad_options():
    d = torch.zeros((8, 8, 8))
    slab = pmesh.make_mesh(device="cpu")
    pencil = pmesh.make_pencil_mesh(spx=2, spy=2)
    calls = [
        lambda m: stats.calculate_power_multipoles(d, SPACING, mesh=m),
        lambda m: stats.calculate_power_wedges(d, SPACING, mesh=m),
        lambda m: stats.calculate_cross_power(d, d, SPACING, mesh=m),
        lambda m: stats.calculate_masked_power(d, d + 1.0, SPACING, mesh=m),
        lambda m: stats.calculate_power(d, SPACING, mesh=m, window="cic"),
        lambda m: stats.calculate_correlation(d, SPACING, mesh=m),
        lambda m: stats.calculate_correlation_multipoles(d, SPACING, mesh=m),
    ]
    for call in calls:
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            call(pencil)
        call(slab)  # a one-rank slab mesh runs each of them
    with pytest.raises(ValueError, match="interlaced wedges"):
        stats.calculate_power_wedges(d, SPACING, interlaced_with=d, mesh=slab)
    with pytest.raises(ValueError, match="unknown window"):
        stats.calculate_power(d, SPACING, window="pcs")
    with pytest.raises(ValueError, match="ell=3"):
        stats.calculate_power_multipoles(d, SPACING, ells=(0, 3))
    with pytest.raises(ValueError, match="interlaced_with"):
        stats.calculate_power(d, SPACING, interlaced_with=d[:4])
