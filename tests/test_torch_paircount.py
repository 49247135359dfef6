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


@pytest.mark.parametrize("n1,n2,nbins,mode,nmu,n_ells", [
    (1, 1, 5, 0, 1, 0), (300, 1000, 7, 1, 3, 0), (257, 255, 4, 2, 1, 3),
    (600, 513, 30, 0, 1, 0), (5, 3000, 12, 1, 10, 0)])
def test_walk_visits_each_pair_once(n1, n2, nbins, mode, nmu, n_ells):
    plan = pc.launch_plan(n1, n2, nbins, mode, nmu, n_ells)
    assert plan.cols % pc.TILE == 0
    assert (plan.col_blocks - 1) * plan.cols < n2 <= plan.col_blocks * plan.cols
    assert plan.row_blocks * pc.ROWS >= n1 > (plan.row_blocks - 1) * pc.ROWS
    visits, per_block = pc.walk_plain(n1, n2, plan)
    assert int(visits.min()) == 1 and int(visits.max()) == 1
    assert sum(per_block) == n1 * n2
    assert plan.slots == pc.row_count(mode, n_ells) * nbins * (
        nmu if mode == 1 else 1)


@pytest.mark.parametrize("n1,n2", [(256, 2**31 - 100), (256, 2**34),
                                   (2**20, 2**31)])
def test_plan_covers_long_catalogs(n1, n2):
    # the column ranges reach past 2^31 objects, where a 32-bit column
    # counter (col_lo + cols) would wrap: the kernel counts in 64 bits
    plan = pc.launch_plan(n1, n2, 30)
    assert plan.col_blocks * plan.cols >= n2 > (plan.col_blocks - 1) * plan.cols
    assert plan.cols % pc.TILE == 0
    assert plan.col_blocks * plan.cols >= 2**31


def test_plan_fills_the_card_and_fits_the_histograms():
    plan = pc.launch_plan(2**17, 2**17, 30)
    assert plan.copies == pc.WARPS
    assert plan.row_blocks * plan.col_blocks >= 2048
    assert pc.launch_plan(10, 10, 300, 1, 10).copies == 1
    with pytest.raises(ValueError, match="shared memory"):
        pc.launch_plan(10, 10, 3000, 1, 10)


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
