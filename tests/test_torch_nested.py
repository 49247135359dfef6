"""The port's nested stream (sampler='nested') vs the JAX package.

(a) the stream: lattice codes and Threefry bits exactly, the unit normals
    within 1e-6, the Hermitian draws equal to the fix applied after them;
(b) the public API: nested renders, generate_noise and
    generate_from_noise at the same seed as the JAX Generator;
(c) zoom matching: grids of two sizes over one box share their common
    modes, their sigma tables share their knots (box-anchored), and the
    threefry and pallas scenes keep the grid's own table;
(d) the constructor's refusals, as the JAX package's.
"""

import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.extend.random import threefry_2x32  # noqa: E402

import randomfield_tpu as rf  # noqa: E402
import randomfield_tpu_torch as rft  # noqa: E402
from randomfield_tpu.ops import sample as jsample  # noqa: E402
from randomfield_tpu_torch.ops import sample, sampler, threefry  # noqa: E402
from randomfield_tpu_torch.ops import transform  # noqa: E402
from randomfield_tpu_torch.parallel import mesh as pmesh  # noqa: E402

SPACING = 16.0
# the unit normals: float32 log/cos/sin of two libraries
DRAW_TOL = 1e-6
# the public API: the JAX package scales by its per-mode sigma grid, the port
# by the uniform table (tests/test_torch_generator.py's PUBLIC)
PUBLIC = 1e-3
SHAPES = [(16, 16, 16), (32, 16, 24), (8, 12, 10), (16, 32, 9)]


def _max_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def jax_nested32():
    return rf.Generator(32, 32, 32, grid_spacing=SPACING, sampler="nested")


@pytest.mark.parametrize("shape", SHAPES)
def test_nested_bits_match_jax(shape):
    codes = sample.lattice_codes(shape)
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jsample._lattice_codes(shape)))
    key = jax.random.key(7)
    kd = jax.random.key_data(key).astype(jnp.uint32).reshape(2)
    flat = jnp.asarray(codes.numpy().astype(np.uint32)).reshape(-1)
    out = np.asarray(threefry_2x32(kd, jnp.concatenate(
        [flat, jnp.zeros_like(flat)])))
    b1, b2 = sample.nested_bits(threefry.key_from_seed(7), codes)
    np.testing.assert_array_equal(b1.numpy().ravel(), out[:flat.size])
    np.testing.assert_array_equal(b2.numpy().ravel(), out[flat.size:])


@pytest.mark.parametrize("shape", SHAPES)
def test_nested_unit_draws_match_jax(shape):
    want = np.asarray(jsample.nested_unit_draws(jax.random.key(7), shape))
    re, im = sample.nested_unit_draws(threefry.key_from_seed(7), shape)
    np.testing.assert_allclose(re.numpy(), want[0], rtol=0, atol=DRAW_TOL)
    np.testing.assert_allclose(im.numpy(), want[1], rtol=0, atol=DRAW_TOL)
    z = np.asarray(jsample.sample_unit_hermitian_nested(jax.random.key(7),
                                                        shape))
    hre, him = sample.sample_unit_hermitian_nested(threefry.key_from_seed(7),
                                                   shape)
    np.testing.assert_allclose(hre.numpy(), z.real, rtol=0, atol=DRAW_TOL)
    np.testing.assert_allclose(him.numpy(), z.imag, rtol=0, atol=DRAW_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_hermitian_draws_are_the_fix_after_the_draws(shape):
    # the kernel draws a non-canonical plane mode at its partner's code;
    # the result is the Hermitian fix of the raw draws, bit for bit
    key = threefry.key_from_seed(3)
    re, im = sample.nested_unit_draws(key, shape)
    want = transform.symmetrize_with_shape_reim(re, im, shape[2])
    got = sample.nested_hermitian_draws(key, shape)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert transform.is_hermitian(*got, shape[2], rtol=0, atol=0)


@pytest.mark.parametrize("smoothing,lightcone", [(0.0, True), (10.0, False)])
def test_nested_render_matches_jax(jax_nested32, smoothing, lightcone):
    want = jax_nested32.generate_delta_field(5, smoothing_length=smoothing,
                                             apply_lightcone=lightcone)
    g = rft.Generator(32, 32, 32, grid_spacing=SPACING, sampler="nested",
                      device="cpu")
    got = g.generate_delta_field(5, smoothing_length=smoothing,
                                 apply_lightcone=lightcone)
    assert got.dtype == torch.float32 and tuple(got.shape) == (32, 32, 32)
    assert _max_rel(got.numpy(), want) <= PUBLIC


def test_nested_noise_roundtrip_matches_jax(jax_nested32):
    g = rft.Generator(32, 32, 32, grid_spacing=SPACING, sampler="nested",
                      device="cpu")
    noise = g.generate_noise(4)
    np.testing.assert_allclose(noise.numpy(),
                               np.asarray(jax_nested32.generate_noise(4)),
                               rtol=0, atol=DRAW_TOL)
    field = g.generate_delta_field(4, smoothing_length=5.0)
    assert torch.equal(g.generate_from_noise(noise, smoothing_length=5.0),
                       field)
    batch = g.generate_delta_fields([4, 9], smoothing_length=5.0)
    assert torch.equal(batch[0], field) and not torch.equal(batch[1], field)
    # a stream of its own: not the canonical Threefry field of the seed
    canon = rft.Generator(32, 32, 32, grid_spacing=SPACING, device="cpu")
    assert not torch.allclose(canon.generate_delta_field(4), field)


def _shared(n_coarse, n_fine):
    """[(coarse index, fine index)] of the frequencies of one axis that both
    grids hold below the coarse Nyquist."""
    out = []
    for i in range(n_coarse):
        s = i if i < (n_coarse + 1) // 2 else i - n_coarse
        if n_coarse % 2 == 0 and s == -n_coarse // 2:
            continue
        out.append((i, s % n_fine))
    return out


# the zoom gap over the shared modes, of max|c|: the same draws times the
# same sigma (the box-anchored table's knots) through float32 transforms,
# as the JAX package's per-mode sigma grid gives (1.2e-7 there; 1.0e-7 and
# 8.5e-8 measured here at 16^3 in 32^3 and 32^3 in 64^3)
ZOOM_GAP = 1e-6


def _zoom_gap(n):
    """max |c_coarse - c_fine| / max|c_coarse| over the modes an n^3 and a
    (2n)^3 grid of one 512 Mpc/h box share, below the coarse Nyquist."""
    box = 512.0
    coarse = rft.Generator(n, n, n, grid_spacing=box / n, sampler="nested",
                           device="cpu")
    fine = rft.Generator(2 * n, 2 * n, 2 * n, grid_spacing=box / (2 * n),
                         sampler="nested", device="cpu")
    c1 = torch.fft.rfftn(coarse.generate_delta_field(
        5, apply_lightcone=False).double(), norm="forward").numpy()
    c2 = torch.fft.rfftn(fine.generate_delta_field(
        5, apply_lightcone=False).double(), norm="forward").numpy()
    scale = np.abs(c1).max()
    gap = 0.0
    for ix1, ix2 in _shared(n, 2 * n):
        for iy1, iy2 in _shared(n, 2 * n):
            gap = max(gap, float(np.abs(c1[ix1, iy1, :n // 2]
                                        - c2[ix2, iy2, :n // 2]).max()))
    return gap / scale


def test_nested_zoom_matches_across_resolutions():
    # 16^3 in 32^3: the shared spectral coefficients agree, the coarse field
    # is the band-limited fine one
    assert _zoom_gap(16) <= ZOOM_GAP


def test_nested_zoom_matches_at_32_in_64():
    assert _zoom_gap(32) <= ZOOM_GAP


def test_sigma_tables_by_sampler():
    # nested scenes: knots anchored at the box's fundamental with one step
    # for every grid, so two grids of one box share them bit for bit, and
    # the table keeps the JAX package's 2e-3 bar against tabulate_sigmas;
    # threefry and pallas scenes: the grid's own table, unchanged
    power = rft.load_default_power()
    box = 512.0
    tables = [rft.Generator(n, n, n, grid_spacing=box / n, sampler="nested",
                            device="cpu").state.table for n in (16, 32, 64)]
    for t in tables[1:]:
        assert (t.lk0, t.dlk) == (tables[0].lk0, tables[0].dlk)
        m = tables[0].knots.numel()
        assert torch.equal(t.knots[:m], tables[0].knots)
    for n, t in zip((16, 32, 64), tables):
        shape = (n, n, n)
        amp = sampler.sigma_amplitude(t, shape, box / n).numpy()
        ref = rft.ops.power.tabulate_sigmas(shape, box / n, power).numpy()
        np.testing.assert_allclose(amp, ref, rtol=2e-3, atol=0)
    for name in ("threefry", "pallas"):
        g = rft.Generator(16, 32, 24, grid_spacing=SPACING, sampler=name,
                          device="cpu")
        want = sampler.make_sigma_table(power, g.shape, SPACING)
        assert (g.state.table.lk0, g.state.table.dlk) == (want.lk0, want.dlk)
        assert torch.equal(g.state.table.knots, want.knots)


def test_nested_kernel_modes_on_the_cpu():
    shape = (16, 16, 16)
    table = sampler.make_sigma_table(rft.load_default_power(), shape, SPACING)
    fixed = sampler.sample_nested(2, table, shape, SPACING, mode="fixed")
    paired = sampler.sample_nested(2, table, shape, SPACING, mode="fixed",
                                   flip=True)
    assert torch.equal(paired, -fixed)
    bits = sampler.sample_nested(2, table, shape, SPACING, mode="bits")
    want = sample.nested_bits(threefry.key_from_seed(2),
                              sample.lattice_codes(shape))
    assert torch.equal(bits, torch.stack(want))
    with pytest.raises(ValueError, match="unknown mode"):
        sampler.sample_nested(2, table, shape, SPACING, mode="planes")


def test_nested_refusals_match_jax():
    with pytest.raises(ValueError, match="fused pipeline"):
        rft.Generator(16, 16, 16, grid_spacing=SPACING, sampler="nested",
                      pipeline="staged", device="cpu")
    with pytest.raises(ValueError, match="10 bits"):
        rft.Generator(2048, 16, 16, grid_spacing=SPACING, sampler="nested",
                      device="cpu")
    with pytest.raises(ValueError, match="10 bits"):
        sample.lattice_codes((16, 16, 2048))
    # the nested stream runs on a slab mesh (a one-rank mesh renders the
    # single-device field), and refuses a pencil mesh
    mesh = pmesh.make_mesh(space=1, device="cpu")
    one = rft.Generator(16, 16, 16, grid_spacing=SPACING, sampler="nested",
                        device="cpu")
    g = rft.Generator(16, 16, 16, grid_spacing=SPACING, sampler="nested",
                      mesh=mesh)
    assert torch.equal(g.generate_delta_field(3), one.generate_delta_field(3))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        rft.Generator(16, 16, 16, grid_spacing=SPACING, sampler="nested",
                      mesh=pmesh.make_pencil_mesh(spx=2, spy=2))
