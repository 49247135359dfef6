"""The port's Zel'dovich mock catalogs (models/zeldovich.py) and KP's plain
version (ops/paint.py) vs the JAX package.

(a) positions: lagrangian_positions equal, zeldovich_positions within
    float32 rounding of the box (the same float32 operations; XLA may
    contract q + psi + f psi);
(b) painting on the arrays the JAX package's zeldovich_positions returns,
    with boundary particles (on cell faces, at L, at negative coordinates):
    NGP exact, CIC and TSC within 1e-5 max|delta| of the reference's
    float32 scatter (the port's int64 sums round each window weight once);
    the plain int64 sums independent of particle order, mass conserved,
    the kernel's shift argument equal to shifted positions;
(c) catalog_power and its multipoles at 1e-4 relative, interlaced too;
(d) zeldovich_power at 1e-10;
(e) poisson_sample: the JAX package's jax.random.poisson counts replayed by
    KH's plain version, equal on every cell (Gaussian and lognormal fields,
    clipped intensities, lambda >= 10, float64 input), still gated
    statistically; and refusals.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import jax  # noqa: E402

from randomfield_tpu.models import zeldovich as jz  # noqa: E402
from randomfield_tpu.ops import power as jpower  # noqa: E402
from randomfield_tpu_torch.models import zeldovich as tz  # noqa: E402
from randomfield_tpu_torch.ops import paint as kp  # noqa: E402

SHAPE = (16, 16, 16)
SPACING = 4.0
# window weights rounded to 2^-s units once, against float32 atomics
PAINT = 1e-5
# the estimators on one painted field: float32 FFTs of two libraries
POWER = 1e-4
# zeldovich_power: the same host float64 algorithm
THEORY = 1e-10


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def catalog():
    """JAX-displaced positions of a random psi (numpy float32), and the
    same plus boundary particles as a flat (3, n) list."""
    rng = np.random.default_rng(4)
    psi = rng.normal(0.0, 3.0, (3,) + SHAPE).astype(np.float32)
    pos = np.asarray(jz.zeldovich_positions(psi, SPACING, f=0.6))
    box = np.asarray(SHAPE, np.float32)[:, None] * SPACING
    faces = (rng.integers(-4, 2 * SHAPE[0] + 4, (3, 96)).astype(np.float32)
             * (SPACING / 2))
    faces[:, :3] = box[:, 0:1]
    faces[:, 3:6] = 0.0
    flat = np.concatenate([pos.reshape(3, -1), faces], axis=1)
    weights = rng.uniform(0.0, 2.0, flat.shape[1]).astype(np.float32)
    return psi, pos, flat, weights


def test_lagrangian_positions_match_jax():
    got = tz.lagrangian_positions((8, 6, 10), 3.0, device="cpu").numpy()
    want = np.asarray(jz.lagrangian_positions((8, 6, 10), 3.0))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("f,los", [(0.0, 2), (0.7, 0), (0.5, 1), (-0.3, 2)])
def test_zeldovich_positions_match_jax(catalog, f, los):
    psi = catalog[0]
    got = tz.zeldovich_positions(torch.as_tensor(psi), SPACING, f, los)
    want = np.asarray(jz.zeldovich_positions(psi, SPACING, f=f, los_axis=los))
    box = SHAPE[0] * SPACING
    assert got.dtype == torch.float32
    assert float(got.min()) >= 0.0 and float(got.max()) <= box
    # one or two float32 ulps of the box: the same operations in order
    assert np.abs(got.numpy() - want).max() <= 2 * box * 2.0 ** -23


@pytest.mark.parametrize("window", ["ngp", "cic", "tsc"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("interlaced", [False, True])
def test_paint_matches_jax(catalog, window, weighted, interlaced):
    flat, weights = catalog[2], catalog[3]
    w = weights if weighted else 1.0
    pos = flat + np.float32(SPACING / 2) if interlaced else flat
    want, wmean = jz.paint(pos, SHAPE, SPACING, w, window)
    if interlaced:  # the kernel's shift argument, no shifted copy
        s = kp.fixed_point_exponent(kp.total_abs_weight(
            torch.as_tensor(flat), torch.as_tensor(weights) if weighted
            else 1.0))
        acc = kp.deposit(torch.as_tensor(flat), SHAPE, SPACING,
                         torch.as_tensor(weights) if weighted else 1.0,
                         kp.ORDERS[window], SPACING / 2, s)
        got, mean = kp.contrast(acc, s)
    else:
        got, mean = tz.paint(flat, SHAPE, SPACING, w, window)
    want = np.asarray(want)
    assert _max_rel(got, want) <= PAINT
    assert mean == pytest.approx(float(wmean), rel=PAINT)
    if window == "ngp" and not weighted:
        # the NGP mass of unit weights: whole particles a cell, exactly
        s = kp.fixed_point_exponent(flat.shape[1])
        acc = kp.deposit(torch.as_tensor(flat), SHAPE, SPACING, 1.0, 1,
                         SPACING / 2 if interlaced else 0.0, s)
        mass = jz._paint(jax.numpy.asarray(pos),
                         jax.numpy.ones(pos.shape[1:]), SHAPE, SPACING, 1)
        np.testing.assert_array_equal((acc >> s).numpy(), np.asarray(mass))


@pytest.mark.parametrize("order", [1, 2, 3])
def test_deposit_is_order_free_and_conserves_mass(catalog, order):
    flat, weights = catalog[2], catalog[3]
    pos, w = torch.as_tensor(flat), torch.as_tensor(weights)
    s = kp.fixed_point_exponent(kp.total_abs_weight(pos, w))
    acc = kp.deposit_plain(pos, SHAPE, SPACING, w, order, 0.0, s)
    perm = torch.randperm(pos.shape[1], generator=torch.Generator()
                          .manual_seed(order))
    again = kp.deposit_plain(pos[:, perm], SHAPE, SPACING, w[perm], order,
                             0.0, s)
    assert torch.equal(acc, again)
    total = float(acc.sum()) * 2.0 ** -s
    # each window's float32 weights sum to 1 within a few float32 ulps
    assert total == pytest.approx(float(w.double().sum()), rel=1e-6)
    shifted = kp.deposit_plain(pos + np.float32(SPACING / 2), SHAPE, SPACING,
                               w, order, 0.0, s)
    assert torch.equal(kp.deposit_plain(pos, SHAPE, SPACING, w, order,
                                        SPACING / 2, s), shifted)


def test_uniform_grid_paints_to_zero_and_faces_wrap():
    q = tz.lagrangian_positions(SHAPE, SPACING, device="cpu")
    for window in ("ngp", "cic", "tsc"):
        d, m = tz.paint(q, SHAPE, SPACING, window=window)
        assert float(d.abs().max()) < 1e-6 and m == pytest.approx(1.0)
    # a particle at L lands in cell 0, one at -a/2 in the last cell (NGP)
    pos = torch.tensor([[SHAPE[0] * SPACING, -SPACING / 2],
                        [0.0, 0.0], [0.0, 0.0]], dtype=torch.float32)
    acc = kp.deposit_plain(pos, SHAPE, SPACING, 1.0, 1, 0.0, 0)
    assert int(acc[0, 0, 0]) == 1 and int(acc[-1, 0, 0]) == 1


@pytest.mark.parametrize("window,interlaced", [("cic", False), ("tsc", True),
                                               ("ngp", True)])
def test_catalog_power_matches_jax(catalog, window, interlaced):
    pos = catalog[1]
    got = tz.catalog_power(pos, SPACING, nbins=8, window=window,
                           interlaced=interlaced)
    want = jz.catalog_power(pos, SPACING, nbins=8, window=window,
                            interlaced=interlaced)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    assert _max_rel(got[1], want[1]) <= POWER


@pytest.mark.parametrize("interlaced", [False, True])
def test_catalog_power_multipoles_and_shot_noise_match_jax(catalog,
                                                           interlaced):
    pos = catalog[1]
    counts = np.random.default_rng(2).poisson(2.0, SHAPE).astype(np.float32)
    got = tz.catalog_power_multipoles(pos, SPACING, weights=counts, nbins=8,
                                      window="tsc", interlaced=interlaced,
                                      los_axis=1)
    want = jz.catalog_power_multipoles(pos, SPACING, weights=counts, nbins=8,
                                       window="tsc", interlaced=interlaced,
                                       los_axis=1)
    np.testing.assert_array_equal(got[2], want[2])
    for ell in range(3):
        assert _max_rel(got[1][ell], want[1][ell]) <= POWER
    got = tz.catalog_power(pos, SPACING, weights=counts, nbins=8)
    want = jz.catalog_power(pos, SPACING, weights=counts, nbins=8)
    assert _max_rel(got[1], want[1]) <= POWER
    volume = np.prod(SHAPE) * SPACING ** 3
    for counts_form in (True, False):
        assert tz.shot_noise(torch.as_tensor(counts), volume, counts_form) \
            == pytest.approx(jz.shot_noise(counts, volume, counts_form),
                             rel=1e-12)


def test_zeldovich_power_matches_jax():
    table = jpower.load_default_power()
    k = np.geomspace(0.01, 0.5, 6)
    kw = dict(k=k, z=0.5, n_q=2048, q_max=400.0, n_mu=48, n_psi=1024)
    got = tz.zeldovich_power(table, **kw)
    want = jz.zeldovich_power(table, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert _max_rel(got[1], want[1]) <= THEORY
    mu = np.linspace(0.0, 1.0, 17)
    f = np.random.default_rng(0).normal(size=(5, 17))
    x = np.array([0.0, 1e-8, 0.5, 30.0, 400.0])
    assert _max_rel(tz._filon_cos_batch(mu, f, x),
                    jz._filon_cos_batch(mu, f, x)) <= THEORY


POISSON_CASES = {
    "gaussian": (2e-3, 8.0, 1),
    "clipped": (0.02, 4.0, 2),
    "lognormal": (0.004, 6.0, 3),
    "rejection": (0.5, 5.0, 4),
    "float64": (0.05, 4.0, 5),
    "wide seed": (0.01, 4.0, 2**33 + 17),
}


@pytest.mark.parametrize("case", sorted(POISSON_CASES))
def test_poisson_sample_equals_jax(case):
    # jax.random.poisson(key(seed ^ 0x5EEDC0DE), lambda) replayed cell by
    # cell: equal counts on every cell, both branches of the JAX loop
    nbar, spacing, seed = POISSON_CASES[case]
    rng = np.random.default_rng(seed & 0xFFFF)
    delta = rng.normal(0.0, 1.5 if case == "clipped" else 0.5, SHAPE)
    if case == "lognormal":
        delta = np.expm1(delta - 0.125)
    delta = delta.astype(np.float64 if case == "float64" else np.float32)
    got = tz.poisson_sample(torch.as_tensor(delta), nbar, spacing, seed)
    want = np.asarray(jz.poisson_sample(delta.astype(np.float32), nbar,
                                        spacing, seed))
    assert got.dtype == torch.as_tensor(delta).dtype
    np.testing.assert_array_equal(got.numpy().astype(np.float32), want)
    if case == "rejection":
        assert float(got.max()) >= 10.0  # the rejection branch ran


@pytest.mark.parametrize("lam", [0.05, 0.7, 3.0, 40.0])
def test_poisson_counts_are_poisson(lam):
    # the replayed JAX stream: mean and variance per intensity
    shape = (32, 32, 32)
    counts = tz.poisson_sample(torch.zeros(shape), lam / 8.0, 2.0, seed=9)
    c = counts.double()
    n = c.numel()
    assert torch.equal(c, torch.round(c)) and float(c.min()) >= 0
    assert abs(float(c.mean()) - lam) < 5.0 * (lam / n) ** 0.5
    var_sd = (2.0 * lam * lam / n + lam / n) ** 0.5
    assert abs(float(c.var()) - lam) < 5.0 * var_sd
    again = tz.poisson_sample(torch.zeros(shape), lam / 8.0, 2.0, seed=9)
    assert torch.equal(counts, again)
    assert not torch.equal(counts, tz.poisson_sample(
        torch.zeros(shape), lam / 8.0, 2.0, seed=10))


def test_poisson_shot_noise_flat():
    # the reference's gate (tests/test_zeldovich.py) on the replayed stream
    n, spacing, nbar = 24, 5.0, 0.02
    shape = (n, n, n)
    counts = tz.poisson_sample(torch.zeros(shape), nbar, spacing, seed=5)
    c = counts.numpy()
    lam = nbar * spacing ** 3
    assert abs(c.mean() / lam - 1.0) < 0.05
    assert abs(c.var() / lam - 1.0) < 0.08
    q = tz.lagrangian_positions(shape, spacing, device="cpu")
    k, p, nm = tz.catalog_power(q, spacing, weights=counts, nbins=10,
                                window="ngp", subtract_shot_noise=False)
    volume = n ** 3 * spacing ** 3
    expected = tz.shot_noise(c, volume)
    assert abs(expected / (volume / float(c.sum())) - 1.0) < 1e-6
    ok = np.isfinite(p) & (nm > 30) & (k < 0.5 * np.pi / spacing)
    resid = p[ok] / expected - 1.0
    noise = np.sqrt(2.0 / nm[ok])
    assert np.all(np.abs(resid) < 5.0 * noise + 0.05), (resid, noise)
    _, p0, _ = tz.catalog_power(q, spacing, weights=counts, nbins=10,
                                window="ngp")
    assert np.all(np.abs(p0[ok]) < 5.0 * noise * expected + 0.05 * expected)
    # negative intensities clip to zero counts
    neg = tz.poisson_sample(torch.full(shape, -2.0), nbar, spacing, seed=1)
    assert float(neg.abs().max()) == 0.0


def test_refusals():
    with pytest.raises(ValueError):
        tz.paint(np.zeros((2, 4, 4, 4), np.float32), (4, 4, 4), 1.0)
    with pytest.raises(ValueError, match="window"):
        tz.paint(np.zeros((3, 4, 4, 4), np.float32), (4, 4, 4), 1.0,
                 window="spline")
    with pytest.raises(ValueError):
        tz.zeldovich_positions(torch.zeros((4, 4, 4)), 1.0)
    with pytest.raises(ValueError, match="shape="):
        tz.catalog_power(np.zeros((3, 64), np.float32), 1.0)
    from randomfield_tpu_torch.parallel import mesh as pmesh

    # the slab mesh runs them (tests/test_torch_mesh_mocks.py); the pencil
    # mesh waits for item 5, and anything else is no mesh
    for fn in (tz.catalog_power, tz.catalog_power_multipoles):
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            fn(np.zeros((3, 4, 4, 4), np.float32), 1.0,
               mesh=pmesh.make_pencil_mesh(1, 2, 2))
        with pytest.raises(TypeError, match="SlabMesh"):
            fn(np.zeros((3, 4, 4, 4), np.float32), 1.0, mesh=object())


@pytest.mark.gpu
def test_paint_on_the_card_matches_jax(catalog):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    flat = catalog[2]
    got, _ = tz.paint(torch.as_tensor(flat).cuda(), SHAPE, SPACING,
                      window="tsc")
    want, _ = jz.paint(flat, SHAPE, SPACING, window="tsc")
    assert _max_rel(got.cpu(), np.asarray(want)) <= PAINT


def test_jax_stays_on_the_cpu():
    assert jax.devices()[0].platform == "cpu"
