"""The port's constrained, Wiener and posterior fields (models/constrained.py,
engine/constrained_api.py, KC's plain versions in ops/constraint.py) vs the
JAX package.

(a) Threefry ``split`` bits exact; K2F and KN take a key pair as a seed;
    the unit Hermitian draw against the reference's sample_unit_hermitian;
(b) the Gram matrix against a float64 oracle at 1e-6 of max|xi| (the port
    rounds each axis table once, where the reference rounds its phase
    kx x + ky y + kz z in float32, off by up to |phase| 2^-24) and against
    the reference at 1e-4;
(c) measure_constraints and the constrained, mean, Wiener and posterior
    fields at the same seed within 1e-4 max|delta| of the reference, on
    even, odd and anisotropic grids, both samplers that have a sigma grid;
(d) constraints met exactly, the lightcone after constraining, and every
    refusal with the reference's text or naming Queue 1 item 5 (the slab
    mesh runs them: tests/test_torch_mesh_mocks.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import jax  # noqa: E402

import randomfield_tpu as rf  # noqa: E402
import randomfield_tpu_torch as rft  # noqa: E402
from randomfield_tpu.models import constrained as jcon  # noqa: E402
from randomfield_tpu.ops import sample as jsample  # noqa: E402
from randomfield_tpu_torch.models import constrained as tcon  # noqa: E402
from randomfield_tpu_torch.ops import constraint, sampler  # noqa: E402
from randomfield_tpu_torch.ops import threefry  # noqa: E402
from randomfield_tpu_torch.ops import transform as rtransform  # noqa: E402

SPACING = 8.0
# the same seed through both packages: float32 renders of two libraries
FIELD = 1e-4
CONSTRAINTS = [
    ((64.0, 64.0, 64.0), 2.5, 16.0),    # grid point, smoothed peak
    ((128.0, 96.0, 32.0), -1.0, 24.0),  # grid point, smoothed void
    ((40.0, 200.0, 120.0), 0.7, 0.0),   # grid point, raw field value
    ((61.3, 70.2, 299.9), 1.5, 20.0),   # off the grid, beyond the box in z
]


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def gens():
    out = {}
    for shape in ((32, 32, 32), (18, 15, 20)):
        out[shape] = (rf.Generator(*shape, grid_spacing=SPACING),
                      rft.Generator(*shape, grid_spacing=SPACING,
                                    device="cpu"))
    return out


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 + 5, 123456789])
def test_split_bits_match_jax(seed):
    want = np.asarray(jax.random.key_data(jax.random.split(
        jax.random.key(seed))))
    got = threefry.split(threefry.key_from_seed(seed))
    assert [list(k) for k in got] == want.tolist()
    want3 = np.asarray(jax.random.key_data(jax.random.split(
        jax.random.key(seed), 3)))
    assert [list(k) for k in threefry.split(threefry.key_from_seed(seed),
                                            3)] == want3.tolist()


@pytest.mark.parametrize("nested", [False, True])
def test_draws_take_key_pairs_and_unit_draw_matches_jax(nested):
    shape = (16, 12, 10)
    table = sampler.make_sigma_table(rft.load_default_power(), shape, 16.0)
    draw = sampler.sample_nested if nested else sampler.draw_scale
    key = threefry.key_from_seed(9)
    assert torch.equal(draw(9, table, shape, 16.0), draw(key, table, shape,
                                                         16.0))
    k2 = threefry.split(key)[1]
    re, im = tcon.unit_hermitian(k2, shape, 16.0, "cpu", nested)
    jkey = jax.random.split(jax.random.key(9))[1]
    fn = (jsample.sample_unit_hermitian_nested if nested
          else jsample.sample_unit_hermitian)
    want = np.array(fn(jkey, shape))
    want[0, 0, 0] = 0.0  # the port's draw is zero at DC (sigma(0) = 0)
    np.testing.assert_allclose(re.numpy(), want.real, rtol=0, atol=3e-6)
    np.testing.assert_allclose(im.numpy(), want.imag, rtol=0, atol=3e-6)


def test_pack_constraints_matches_jax_and_takes_its_arrays():
    cons = [{"position": (1.0, 2.0, 3.0), "value": 0.5, "scale": 4.0},
            ((5.0, 6.0, 7.0), -1.0), ((8.0, 9.0, 10.5), 2.0, 1.5)]
    want = jcon.pack_constraints(cons, (16, 16, 16), 4.0)
    got = tcon.pack_constraints(cons, (16, 16, 16), 4.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    again = tcon.pack_constraints(tuple(np.asarray(w) for w in want),
                                  (16, 16, 16), 4.0)
    for g, w in zip(again, got):
        np.testing.assert_array_equal(g, w)
    for bad, match in (([], "at least one"),
                       ([((1.0, 2.0), 0.5, 1.0)], "3 coords")):
        for mod in (tcon, jcon):
            with pytest.raises(ValueError, match=match):
                mod.pack_constraints(bad, (16, 16, 16), 4.0)


def _oracle_gram(sig, shape, spacing, pos, scales, sm):
    """float64 xi from float64 kernels (the reference test's oracle) on
    the port's float32 sigma grid."""
    nx, ny, nz = shape
    kx = 2 * np.pi * np.fft.fftfreq(nx, d=spacing)
    ky = 2 * np.pi * np.fft.fftfreq(ny, d=spacing)
    kz = 2 * np.pi * np.fft.rfftfreq(nz, d=spacing)
    k2 = (kx**2)[:, None, None] + (ky**2)[None, :, None] + (kz**2)[None,
                                                                   None, :]
    sc = constraint._self_conjugate(shape, 0, nx, "cpu").numpy()
    mult = np.full(nz // 2 + 1, 2.0)
    mult[0] = 1.0
    if nz % 2 == 0:
        mult[-1] = 1.0
    w = mult * (sig * np.exp(-0.5 * k2 * sm * sm)) ** 2
    ks = []
    for p, r in zip(np.asarray(pos, np.float64), np.asarray(scales,
                                                             np.float64)):
        ph = (kx[:, None, None] * p[0] + ky[None, :, None] * p[1]
              + kz[None, None, :] * p[2])
        win = np.exp(-0.5 * k2 * r * r)
        ks.append(win * np.cos(ph) + 1j * np.where(sc, 0.0,
                                                   win * np.sin(ph)))
    return np.array([[np.sum(w * (a * b.conj()).real) for b in ks]
                     for a in ks])


@pytest.mark.parametrize("shape,sm", [((32, 32, 32), 0.0),
                                      ((32, 32, 32), 6.0),
                                      ((18, 15, 20), 0.0)])
def test_gram_matches_oracle_and_jax(gens, shape, sm):
    gj, gt = gens[shape]
    got = gt.constraint_matrix(CONSTRAINTS, smoothing_length=sm)
    pos, scl, _ = tcon.pack_constraints(CONSTRAINTS, shape, SPACING)
    oracle = _oracle_gram(gt.sigmas.numpy().astype(np.float64), shape,
                          SPACING, pos, scl, sm)
    assert np.abs(got - oracle).max() <= 1e-6 * np.abs(oracle).max()
    want = gj.constraint_matrix(CONSTRAINTS, smoothing_length=sm)
    assert _max_rel(got, want) <= 1e-4


@pytest.mark.parametrize("shape,sm", [((32, 32, 32), 0.0),
                                      ((32, 32, 32), 6.0),
                                      ((18, 15, 20), 0.0)])
def test_constrained_and_mean_fields_match_jax(gens, shape, sm):
    gj, gt = gens[shape]
    got = gt.generate_constrained_field(7, CONSTRAINTS, smoothing_length=sm)
    want = np.asarray(gj.generate_constrained_field(
        7, CONSTRAINTS, smoothing_length=sm))
    assert _max_rel(got.numpy(), want) <= FIELD
    # constraints met exactly, measured by the independent forward path
    vals = [c[1] for c in CONSTRAINTS]
    np.testing.assert_allclose(gt.measure_constraints(got, CONSTRAINTS),
                               vals, atol=2e-3)
    meas = gt.measure_constraints(want, CONSTRAINTS)
    np.testing.assert_allclose(meas, gj.measure_constraints(want,
                                                            CONSTRAINTS),
                               rtol=FIELD, atol=1e-6)
    mean = gt.constrained_mean_field(CONSTRAINTS, smoothing_length=sm)
    want = np.asarray(gj.constrained_mean_field(CONSTRAINTS,
                                                smoothing_length=sm))
    assert _max_rel(mean.numpy(), want) <= FIELD
    np.testing.assert_allclose(gt.measure_constraints(mean, CONSTRAINTS),
                               vals, atol=2e-3)


@pytest.mark.parametrize("shape", [(32, 32, 32), (15, 17, 19)])
def test_off_grid_raw_constraint_misses_by_the_hermitian_projection(gens,
                                                                    shape):
    """s = 0 and an R = 0 constraint off the grid: its kernel is not
    Hermitian on the self-conjugate kz planes' Nyquist rows (and on the
    whole kz Nyquist plane), so the part of the correction that the c2r's
    Hermitian projection drops is not met.  The corrected spectrum meets
    every constraint within 1e-6 before the projection; the field misses by
    exactly what the projection removes (1e-6), as the reference's does
    (1e-5 of each other), and an odd grid, with no Nyquist row, meets them
    within 1e-5."""
    cons = CONSTRAINTS[:2] + [((61.3, 97.7, 130.1), 1.5, 0.0)]
    vals = np.array([c[1] for c in cons])
    if shape not in gens:
        gens[shape] = (rf.Generator(*shape, grid_spacing=SPACING),
                       rft.Generator(*shape, grid_spacing=SPACING,
                                     device="cpu"))
    gj, gt = gens[shape]
    got = gt.generate_constrained_field(3, cons)
    want = np.asarray(gj.generate_constrained_field(3, cons))
    assert _max_rel(got.numpy(), want) <= FIELD
    miss = gt.measure_constraints(got, cons) - vals
    np.testing.assert_allclose(miss, gj.measure_constraints(want, cons)
                               - vals, rtol=0, atol=1e-5)
    pos, scl, _ = tcon.pack_constraints(cons, shape, SPACING)
    tables = constraint.axis_tables(pos, scl, shape, SPACING)
    re, im = tcon.unit_hermitian(threefry.as_key(3), shape, SPACING, "cpu")
    gamma = constraint.measure(re, im, tables, gt.sigmas)
    alpha = tcon._solve(gt.constraint_matrix(cons), vals - gamma.numpy())
    constraint.correct(re, im, tables, alpha, gt.sigmas)
    pre = constraint.measure(re, im, tables).numpy() - vals
    assert np.abs(pre).max() <= 1e-6
    rtransform.hermitian_part_reim(re, im, shape[2])
    post = constraint.measure(re, im, tables).numpy() - vals
    np.testing.assert_allclose(miss, post, rtol=0, atol=1e-6)
    if all(n % 2 for n in shape):
        assert np.abs(miss).max() <= 1e-5
    else:
        assert np.abs(miss).max() > 1e-3


@pytest.mark.parametrize("tabulated", [False, True])
def test_wiener_and_posterior_match_jax(gens, tabulated):
    gj, gt = gens[(32, 32, 32)]
    truth = gt.generate_delta_field(4, apply_lightcone=False).numpy()
    rng = np.random.RandomState(0)
    noise_std = 0.5 * truth.std()
    data = (truth + rng.normal(scale=noise_std, size=truth.shape)).astype(
        np.float32)
    noise = float(noise_std ** 2 * SPACING ** 3)
    if tabulated:
        k = np.geomspace(gt.k_min / 2.0, gt.k_max * 2.0, 24)
        noise = np.column_stack([k, noise * (1.0 + 0.5 * np.sin(k))])
    rec = gt.wiener_filter(data, noise).numpy()
    assert _max_rel(rec, gj.wiener_filter(data, noise)) <= FIELD
    post = gt.generate_posterior_field(9, data, noise).numpy()
    assert _max_rel(post, gj.generate_posterior_field(9, data, noise)) \
        <= FIELD
    assert gt.predicted_posterior_mse(noise) == pytest.approx(
        gj.predicted_posterior_mse(noise), rel=1e-6)
    if not tabulated:  # the reference's gate on the expected MSE
        mse = float(np.mean((rec - truth) ** 2))
        pred = gt.predicted_posterior_mse(noise)
        assert abs(mse - pred) < 0.2 * pred
        assert abs(float(np.mean((post - truth) ** 2)) - 2.0 * pred) \
            < 0.4 * pred


def test_nested_and_lightcone_and_self_consistency():
    shape = (16, 16, 16)
    gj = rf.Generator(*shape, grid_spacing=16.0, sampler="nested")
    gt = rft.Generator(*shape, grid_spacing=16.0, sampler="nested",
                       device="cpu")
    cons = CONSTRAINTS[:2]
    got = gt.generate_constrained_field(1, cons)
    assert _max_rel(got.numpy(), gj.generate_constrained_field(1, cons)) \
        <= FIELD
    w = np.asarray(gt.growth_function, np.float32)
    lc = gt.generate_constrained_field(1, cons, apply_lightcone=True)
    np.testing.assert_allclose(lc.numpy(), got.numpy() * w, rtol=1e-5,
                               atol=1e-6)
    # constraining a seed to its own values returns its field
    g = rft.Generator(24, 24, 24, grid_spacing=SPACING, device="cpu")
    ref = g.generate_delta_field(5, apply_lightcone=False)
    vals = g.measure_constraints(ref, CONSTRAINTS[:2])
    own = [(c[0], v, c[2]) for c, v in zip(CONSTRAINTS[:2], vals)]
    d = g.generate_constrained_field(5, own)
    # the render reads the sigma grid, the plain render the uniform table
    assert float((d - ref).abs().max()) < 2e-3 * float(ref.std())


def test_refusals_match_jax():
    for kw in (dict(sampler="pallas"), dict(pipeline="staged")):
        g = rft.Generator(16, 16, 16, grid_spacing=SPACING, device="cpu",
                          **kw)
        for name, args in (("generate_constrained_field", (0, CONSTRAINTS)),
                           ("wiener_filter", (np.zeros((16,) * 3,
                                                       np.float32), 1.0)),
                           ("constraint_matrix", (CONSTRAINTS,))):
            with pytest.raises(ValueError, match="single-device fused"):
                getattr(g, name)(*args)
    from randomfield_tpu_torch.parallel import mesh as pmesh

    # a slab mesh runs every method (tests/test_torch_mesh_mocks.py); a
    # pallas mesh scene refuses those that read its sigma grid with the JAX
    # package's _mesh_sigmas error and measures; the pencil mesh waits for
    # item 5
    g = rft.Generator(16, 16, 16, grid_spacing=SPACING, sampler="pallas",
                      mesh=pmesh.make_mesh(space=1, device="cpu"))
    for name, args in (("generate_constrained_field", (0, CONSTRAINTS)),
                       ("constrained_mean_field", (CONSTRAINTS,)),
                       ("generate_posterior_field",
                        (0, np.zeros((16,) * 3, np.float32), 1.0)),
                       ("predicted_posterior_mse", (1.0,))):
        with pytest.raises(ValueError, match="plain renders only"):
            getattr(g, name)(*args)
    assert np.all(g.measure_constraints(np.zeros((16,) * 3, np.float32),
                                        CONSTRAINTS) == 0.0)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        rft.Generator(16, 16, 16, grid_spacing=SPACING,
                      mesh=pmesh.make_pencil_mesh(1, 2, 2))


@pytest.mark.gpu
def test_constrained_on_the_card_matches_jax(gens):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gj, _ = gens[(32, 32, 32)]
    g = rft.Generator(32, 32, 32, grid_spacing=SPACING, device="cuda")
    got = g.generate_constrained_field(7, CONSTRAINTS).cpu().numpy()
    assert _max_rel(got, gj.generate_constrained_field(7, CONSTRAINTS)) \
        <= FIELD
