"""The port's pair counts (validate/paircount.py on KQ's plain version) vs
the JAX package's validate/paircount.py and its float64 brute-force
oracle, on the same numpy catalogs; and KQ's walk and fixed-point plan
replayed with no card.

Bars: with unit weights the counts equal the JAX package's exactly (both
bin the same float32 r^2 against the same float32 squared edges, and a
count is exact in float32 below 2^24); with weights within 5e-6 relative
of JAX's float32 sums, and equal to the oracle at its own test's rtol of
5e-6 (atol 1e-4 for the Legendre rows); the analytic RR, r_mean and the
weight totals within 1e-6 (JAX's float32 sums of the weights).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

from randomfield_tpu.validate import paircount as jpc  # noqa: E402
from randomfield_tpu_torch.ops import paircount as pc  # noqa: E402
from randomfield_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from randomfield_tpu_torch.validate import paircount  # noqa: E402
from test_paircount import _brute  # noqa: E402

BOX = 100.0
EDGES = np.geomspace(2.0, 45.0, 11)


def _catalogs(n1=900, n2=600, seed=1):
    rng = np.random.default_rng(seed)
    p1 = rng.random((n1, 3)) * BOX
    p2 = rng.random((n2, 3)) * BOX
    # a line of points 4 apart: pairs exactly on the integer edges below
    p1[:20] = [10.0, 20.0, 30.0]
    p1[:20, 2] += 4.0 * np.arange(20)
    # coincident points and points on the faces
    p1[20:24] = p1[30:34]
    p1[24:27] = [[0.0, 5.0, 5.0], [BOX, 5.0, 5.0], [BOX / 2, 5.0, 5.0]]
    return p1, p2, rng.random(n1) + 0.2, rng.random(n2) + 0.2


@pytest.mark.parametrize("kw", [{}, dict(nmu=6), dict(ells=(0, 2, 4)),
                                dict(ells=(2,)), dict(los_axis=0, nmu=3)])
@pytest.mark.parametrize("edges", [EDGES, np.array([0.0, 4.0, 8.0, 16.0,
                                                    40.0, 48.0])])
def test_unit_weight_counts_equal_jax(kw, edges):
    p1, p2, _, _ = _catalogs()
    for other in (None, p2):
        got = paircount.pair_counts(p1, BOX, edges, positions2=other,
                                    device="cpu", **kw)
        want = jpc.pair_counts(p1, BOX, edges, positions2=other, **kw)
        np.testing.assert_array_equal(got["dd"], want["dd"])
        np.testing.assert_allclose(got["r_mean"], want["r_mean"], rtol=1e-6)
        if "ells" in kw:
            np.testing.assert_allclose(got["dd_ell"], want["dd_ell"],
                                       rtol=5e-6, atol=1e-3)
        assert got["cross"] == want["cross"] and got["box"] == want["box"]


@pytest.mark.parametrize("kw", [{}, dict(nmu=4), dict(ells=(0, 2, 4))])
def test_weighted_counts_match_jax_and_the_oracle(kw):
    p1, p2, w1, w2 = _catalogs()
    for other, w_other in ((None, None), (p2, w2)):
        got = paircount.pair_counts(p1, BOX, EDGES, weights=w1,
                                    positions2=other, weights2=w_other,
                                    device="cpu", **kw)
        want = jpc.pair_counts(p1, BOX, EDGES, weights=w1, positions2=other,
                               weights2=w_other, **kw)
        key = "dd_ell" if "ells" in kw else "dd"
        np.testing.assert_allclose(got[key], want[key], rtol=5e-6,
                                   atol=1e-4 if "ells" in kw else 0)
        for t in ("sum_w1", "sum_w2", "sum_w1_sq"):
            assert np.isclose(got[t], want[t], rtol=1e-6)
        # the oracle bins by float64 r (side='right'); away from edges the
        # two rules agree, so its catalog here has no points on an edge
    q1 = np.random.default_rng(5).random((300, 3)) * BOX
    q2 = np.random.default_rng(6).random((200, 3)) * BOX
    v1, v2 = w1[:300], w2[:200]
    got = paircount.pair_counts(q1, BOX, EDGES, weights=v1, positions2=q2,
                                weights2=v2, device="cpu", **kw)
    oracle = _brute(q1, BOX, EDGES, w1=v1, pos2=q2, w2=v2,
                    nmu=kw.get("nmu", 1), ells=kw.get("ells", ()))
    np.testing.assert_allclose(got["dd_ell" if "ells" in kw else "dd"],
                               oracle, rtol=5e-6,
                               atol=1e-4 if "ells" in kw else 0)


def test_correlations_match_jax():
    p1, p2, w1, _ = _catalogs(1200, 700, 3)
    for kw in (dict(), dict(nmu=5), dict(positions2=p2)):
        got = paircount.catalog_correlation(p1, BOX, EDGES, device="cpu",
                                            **kw)
        want = jpc.catalog_correlation(p1, BOX, EDGES, **kw)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-9)
        np.testing.assert_array_equal(got[2], want[2])
    got = paircount.catalog_correlation_multipoles(
        torch.as_tensor(p1.T.reshape(3, 30, 40)), BOX, EDGES, weights=w1)
    want = jpc.catalog_correlation_multipoles(p1.T.reshape(3, 30, 40), BOX,
                                              EDGES, weights=w1)
    np.testing.assert_allclose(got[1], want[1], rtol=5e-6, atol=1e-6)


def test_uniform_catalog_xi_is_zero():
    # the JAX package's gate (tests/test_paircount.py): uniform points
    # give xi = 0 within Poisson error, auto and cross
    rng = np.random.default_rng(2)
    n = 2000
    pos = rng.random((n, 3)) * BOX
    edges = np.geomspace(3.0, 45.0, 9)
    _, xi, dd = paircount.catalog_correlation(pos, BOX, edges, device="cpu")
    assert (np.abs(xi) < 5 * 2.0 / np.sqrt(dd)).all()
    pos2 = rng.random((n // 2, 3)) * BOX
    _, xi2, dd2 = paircount.catalog_correlation(pos, BOX, edges,
                                                positions2=pos2,
                                                device="cpu")
    assert (np.abs(xi2) < 5.0 / np.sqrt(dd2)).all()


def test_refusals_match_jax():
    pos = np.zeros((4, 3))
    for bad, match in (((pos, 10.0, [0.0, 6.0]), "minimum-image"),
                       ((pos, 10.0, [3.0, 1.0]), "increasing"),
                       ((np.zeros((5, 2)), 10.0, [0.0, 1.0]), "positions")):
        for m in (paircount, jpc):
            kw = {"device": "cpu"} if m is paircount else {}
            with pytest.raises(ValueError, match=match):
                m.pair_counts(*bad, **kw)
    for kw, match in ((dict(ells=(1,)), "ell"),
                      (dict(ells=(0,), nmu=4), "not both")):
        with pytest.raises(ValueError, match=match):
            paircount.pair_counts(pos, 10.0, [0.0, 2.0], device="cpu", **kw)
    mesh = pmesh.make_mesh(space=1, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        paircount.pair_counts(pos, 10.0, [0.0, 2.0], mesh=mesh)


def _chain_r2(rows1, rows2, box):
    """(n1, n2) float32 r^2 of the chain's minimum image, as pair_terms
    computes it."""
    b = torch.tensor(box, dtype=torch.float32)
    d = [rows1[:, None, c] - rows2[None, :, c] for c in range(3)]
    d = [dc - b[c] * torch.round(pc._div32(dc, b[c])) for c, dc in
         enumerate(d)]
    return (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]


def _tightest_edge(box, k, coord_max, n2):
    """The largest float32 r^2 whose cell grid keeps k cells on x: its
    cells are as narrow as cell_grid's margin allows."""
    lo, hi = 1, int(np.float32(box[0] ** 2).view(np.int32))
    while lo < hi:
        mid = (lo + hi + 1) // 2
        e = float(np.int32(mid).view(np.float32))
        if pc.cell_grid(box, e, coord_max, n2)[0][0] >= k:
            lo = mid
        else:
            hi = mid - 1
    return float(np.int32(lo).view(np.float32))


def _near(v, k):
    """float32 v and its k neighbours below and above."""
    out, up, down = [np.float32(v)], np.float32(v), np.float32(v)
    for _ in range(k):
        up = np.nextafter(up, np.float32(np.inf))
        down = np.nextafter(down, np.float32(-np.inf))
        out += [up, down]
    return out


def _walk_case(name):
    """(rows1, rows2, box, float32 squared edges) of a walk case."""
    rng = np.random.default_rng(WALK_CASES.index(name))

    def uniform(n, box):
        return rng.random((n, 3)) * np.asarray(box)

    box, r, p2 = (100.0,) * 3, None, None
    if name in ("nc1", "nc2", "nc3"):
        r = {"nc1": 50.0, "nc2": 40.0, "nc3": 30.0}[name]
        p1, p2 = uniform(400, box), uniform(300, box)
    elif name == "nc13":
        box, r = (2048.0,) * 3, 150.0
        p1 = uniform(1500, box)
    elif name == "noncubic":
        box, r = (96.0, 96.0, 120.0), 48.0
        p1 = uniform(500, box)
    elif name == "faces":
        # on the faces, at exactly box, outside [0, box), coincident
        r = 20.0
        p1 = uniform(400, box)
        p1[:12] = [[0.0, 5.0, 5.0], [100.0, 5.0, 5.0], [100.0, 100.0, 0.0],
                   [-0.5, 50.0, 50.0], [100.5, 50.0, 50.0], [-100.0, 0, 0],
                   [199.0, 3.0, 97.0], [-37.0, 250.0, -99.0], [50.0, 0, 80],
                   [50.0, 100.0, 80.0], [20.0, 20.0, 0.0], [20.0, 20.0, 100]]
        p1[12:16] = p1[20:24]
        p2 = np.concatenate([uniform(200, box), p1[:16]])
    elif name == "packed":
        # every object in one cell, the other cells empty
        r = 10.0
        p1 = rng.random((300, 3)) * 6.0 + 41.0
        p2 = rng.random((200, 3)) * 6.0 + 41.0
    elif name == "clustered":
        box, r = (200.0,) * 3, 20.0
        centres = uniform(15, box)
        p1 = np.concatenate([c + 6.0 * rng.standard_normal((60, 3))
                             for c in centres])
        p2 = np.concatenate([uniform(200, box), p1[::3]])
    elif name == "cross_sizes":
        r = 25.0
        p1, p2 = uniform(1200, box), uniform(7, box)
    elif name == "cap":
        # a small reach in a large box: the cells are capped
        box, r = (2048.0,) * 3, 2.0
        p1 = uniform(300, box)
        p1[150:] = p1[:150] + rng.random((150, 3)) * 1.5
    elif name == "margin":
        # the narrowest cells the margin allows (7 on x), coordinates in
        # [-L, 3L) near every cell boundary (6 ulps either side) and one
        # reach past them, and the last edge at the largest chain r^2 of a
        # pair that wraps and straddles a boundary, below the reach
        box = (2048.0, 4 * 2048.0 / 7, 4 * 2048.0 / 7)
        top = 3 * 2048.0
        e = _tightest_edge(box, 7, top, 100)
        xs = [x for j in range(8) for s in (0.0, 2048.0, -2048.0, 4096.0)
              for x in _near(j * 2048.0 / 7 + s, 6)]
        xs += [np.float32(x + np.float32(e ** 0.5)) for x in xs]
        xs = np.array([x for x in xs if abs(x) <= top], np.float32)
        p1 = np.stack([xs, np.ones_like(xs), np.ones_like(xs)], 1)
        rows = pc.pack(torch.as_tensor(p1), torch.ones(len(xs)))
        plan = pc.launch_plan(len(xs), len(xs), box, e, top, 1)
        r2 = _chain_r2(rows, rows, box)
        cell = pc.cell_index(rows, plan)
        x = rows[:, 0]
        edge = ((x[:, None] - x[None, :]).abs() > 1024.0) & (
            cell[:, None] != cell[None, :]) & (r2 <= e)
        e2 = torch.stack([torch.tensor(0.0), r2[edge].max()])
        return rows, rows, box, e2
    else:
        raise KeyError(name)
    e2 = torch.as_tensor((np.array([0.0, r / 3, r]) ** 2).astype(np.float32))
    rows1 = pc.pack(torch.as_tensor(p1), torch.ones(len(p1)))
    rows2 = rows1 if p2 is None else pc.pack(torch.as_tensor(p2),
                                             torch.ones(len(p2)))
    return rows1, rows2, box, e2


def _plan(rows1, rows2, box, e2):
    coord = max(float(rows1[:, :3].abs().max()),
                float(rows2[:, :3].abs().max()))
    return pc.launch_plan(rows1.shape[0], rows2.shape[0], box, float(e2[-1]),
                          coord, e2.numel() - 1)


WALK_CASES = ["nc1", "nc2", "nc3", "nc13", "noncubic", "faces", "packed",
              "clustered", "cross_sizes", "cap", "margin"]


@pytest.mark.parametrize("name", WALK_CASES)
def test_walk_visits_each_pair_in_range_once(name):
    rows1, rows2, box, e2 = _walk_case(name)
    plan = _plan(rows1, rows2, box, e2)
    want_cells = {"nc1": (1, 1, 1), "nc2": (2, 2, 2), "nc3": (3, 3, 3),
                  "nc13": (13, 13, 13), "noncubic": (1, 1, 2),
                  "margin": (7, 4, 4)}
    if name in want_cells:
        assert plan.cells == want_cells[name]
    visits, per_item = pc.walk_plain(rows1, rows2, plan)
    r2 = _chain_r2(rows1, rows2, box)
    valid = (r2 > e2[0]) & (r2 <= e2[-1])
    assert int(valid.sum()) > 0
    assert bool((visits[valid] == 1).all()) and int(visits.max()) <= 1
    assert sum(per_item) == int(visits.sum())
    assert len(per_item) <= plan.max_items
    if name == "margin":
        # pairs exactly on the last edge, across a cell boundary and the
        # periodic wrap
        cell = pc.cell_index(rows1, plan)
        x = rows1[:, 0]
        edge = (r2 == e2[-1]) & (cell[:, None] != cell[None, :])
        assert bool((edge & ((x[:, None] - x[None, :]).abs()
                             > box[0] / 2)).any())


@pytest.mark.parametrize("name", ["faces", "clustered", "noncubic"])
def test_expected_pairs_is_the_replays_count(name):
    rows1, rows2, box, e2 = _walk_case(name)
    plan = _plan(rows1, rows2, box, e2)
    _, per_item = pc.walk_plain(rows1, rows2, plan)
    counts = [pc.cell_counts(r, plan) for r in (rows1, rows2)]
    assert sum(int(c.sum()) for c in counts) == rows1.shape[0] + rows2.shape[0]
    assert pc.expected_pairs(*counts, plan.cells) == sum(per_item)


@pytest.mark.parametrize("mode,nmu,ells", [(0, 1, ()), (1, 7, ()),
                                           (2, 1, (0, 2, 4))])
def test_walk_sums_equal_the_brute_plain_version(mode, nmu, ells):
    for name in ("faces", "clustered"):
        rows1, rows2, box, e2 = _walk_case(name)
        w1 = torch.as_tensor(np.random.default_rng(3).random(
            rows1.shape[0]) + 0.25, dtype=torch.float32)
        rows1 = torch.cat([rows1[:, :3], w1[:, None]], 1)
        edges2 = torch.as_tensor((np.linspace(0.0, float(e2[-1]) ** 0.5, 9)
                                  ** 2).astype(np.float32))
        s = pc.fixed_point_exponent(rows1.shape[0], rows2.shape[0], 1.25,
                                    1.0, float(edges2[-1]) ** 0.5, ells)
        for los in (0, 2):
            args = (rows1, rows2, box, edges2, s, mode, nmu, ells, los)
            want, seen = pc.pair_sums_plain(*args)
            got, examined = pc.pair_sums_walk_plain(*args)
            assert torch.equal(got, want) and int(want[0].sum()) > 0
            assert seen == rows1.shape[0] * rows2.shape[0] > examined


@pytest.mark.parametrize("n", [1, 2, 3, 4, 13])
def test_neighbour_cells_are_distinct(n):
    cells = (n, 3, n)
    for c in range(n * 3 * n):
        near = pc.neighbour_cells(c, cells)
        assert len(near) == len(set(near)) == len(
            pc.axis_offsets(n)) ** 2 * 3
        assert c in near


@pytest.mark.parametrize("n2,reach", [(300, 2.0), (10**6, 0.5)])
def test_cell_count_is_capped(n2, reach):
    cells, _, _ = pc.cell_grid((2048.0,) * 3, np.float32(reach**2), 2048.0,
                               n2)
    cap = max(n2, pc.MIN_CELL_CAP)
    assert math.prod(cells) <= cap and math.prod(cells) > cap / 8
    # without the cap, 2048 / 2 ~ 1023 cells an axis
    assert max(cells) < 1023
    # larger cells than the reach asks for: the walk stays right ("cap")


def test_item_offsets_are_int64_past_2_31():
    # the plan alone, no catalog: a cell of 2^31 + 5 objects, then cells
    # whose rows start past 2^31 and 2^32
    counts = [2**31 + 5, 3, 0, 2**31, 70]
    starts = [0, 2**31 + 5, 2**31 + 8, 2**31 + 8, 2**32 + 8]
    ends = pc.item_ends(torch.tensor(counts, dtype=torch.int64)).tolist()
    first1 = -(-(2**31 + 5) // pc.ROWS)
    assert ends[:2] == [first1, first1 + 1]
    assert pc.item_rows(first1 - 1, ends, starts, counts) == (
        0, (first1 - 1) * pc.ROWS, (2**31 + 5) - (first1 - 1) * pc.ROWS)
    assert pc.item_rows(first1, ends, starts, counts) == (1, 2**31 + 5, 3)
    last3 = ends[3] - 1
    assert pc.item_rows(last3, ends, starts, counts) == (
        3, 2**31 + 8 + 2**31 - pc.ROWS, pc.ROWS)
    assert pc.item_rows(ends[4] - 1, ends, starts, counts) == (
        4, 2**32 + 8 + 64, 6)
    plan = pc.launch_plan(2**31 + 77, 2**33, (2048.0,) * 3, 150.0**2, 2048.0,
                          30)
    assert plan.cells == (13, 13, 13)
    assert plan.max_items == 13**3 + -(-(2**31 + 77) // pc.ROWS) > 2**26


def test_histograms_fit_or_raise():
    def plan(*hist):
        return pc.launch_plan(10, 10, (100.0,) * 3, 100.0, 100.0, *hist)

    assert plan(30).copies == pc.WARPS and plan(30).slots == 60
    assert plan(30, 1, 10).slots == 600 and plan(30, 2, 1, 3).slots == 150
    assert plan(300, 1, 10).copies == 1
    with pytest.raises(ValueError, match="shared memory"):
        plan(3000, 1, 10)


@pytest.mark.parametrize("n,wmax,rmax,ells", [
    (2**17, 1.0, 150.0, ()), (2**20, 3.5, 10.0, (0, 2, 4)),
    (100, 1e6, 1.0, (2,))])
def test_fixed_point_plan_cannot_overflow(n, wmax, rmax, ells):
    s = pc.fixed_point_exponent(n, n, wmax, wmax, rmax, ells)
    factor = max([1.0, rmax] + [2 * e + 1.0 for e in ells])
    worst = n * n * (wmax * wmax * factor * 2.0**s + 0.5)
    assert worst < 2**62
    # a unit weight is an exact count of 2^s units
    assert 2.0**s == int(2.0**s) or s < 0


def test_plain_sums_are_exact_integers_of_the_terms():
    p1, _, w1, _ = _catalogs(400, 10, 8)
    rows = pc.pack(torch.as_tensor(p1), torch.as_tensor(w1))
    e2 = torch.as_tensor((EDGES**2).astype(np.float32))
    s = pc.fixed_point_exponent(400, 400, 1.2, 1.2, EDGES[-1])
    sums, seen = pc.pair_sums(rows, rows, (BOX,) * 3, e2, s)
    assert seen == 400 * 400
    idx, terms = pc.pair_terms(rows, rows, torch.full((3,), BOX), e2, 10)
    q = torch.round(terms[0].double() * 2.0**s).long()
    want = torch.zeros(10, dtype=torch.int64).index_add_(0, idx, q)
    assert torch.equal(sums[0], want)
    # chunked rows give the same integers
    old = pc._PLAIN_PAIRS
    try:
        pc._PLAIN_PAIRS = 4000
        again, _ = pc.pair_sums(rows, rows, (BOX,) * 3, e2, s)
    finally:
        pc._PLAIN_PAIRS = old
    assert torch.equal(sums, again)


def test_port_paircount_imports_no_jax():
    import subprocess
    import sys

    code = ("import sys; import randomfield_tpu_torch.validate.paircount, "
            "randomfield_tpu_torch.validate.fkp, "
            "randomfield_tpu_torch.validate.marked, "
            "randomfield_tpu_torch.validate.velocity, "
            "randomfield_tpu_torch.models.massfunction, "
            "randomfield_tpu_torch.models.halomodel, "
            "randomfield_tpu_torch.models.limber, "
            "randomfield_tpu_torch.models.ssc, "
            "randomfield_tpu_torch.models.baofit, "
            "randomfield_tpu_torch.models.streaming; "
            "assert 'jax' not in sys.modules and "
            "'randomfield_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
