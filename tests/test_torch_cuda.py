"""The port's CUDA kernels on the card (marked ``gpu``; skip without one).

This file imports torch and the port only, so it also runs where JAX is
absent.  On a machine with a CUDA card and nvcc, from the repository root:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py configures JAX.)  Each kernel is held
to its plain PyTorch version on the same tensors, and a CUDA render to the
CPU render of the same seed, which the other test_torch_* files hold to
the JAX package.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import randomfield_tpu_torch as rft  # noqa: E402
from randomfield_tpu_torch.engine import staged  # noqa: E402
from randomfield_tpu_torch.models import web  # noqa: E402
from randomfield_tpu_torch.ops import derived, fft, genfft, grid  # noqa: E402
from randomfield_tpu_torch.ops import sample, sampler  # noqa: E402
from randomfield_tpu_torch.ops import threefry, transform  # noqa: E402
from randomfield_tpu_torch.validate import stats  # noqa: E402

pytestmark = pytest.mark.gpu

SPACING = 16.0
# max|kernel - plain| / max|plain|: float32 rounding of a scale (K2) and of
# a two- or three-pass Stockham FFT against cuFFT's; K4 at the bar of
# tests/test_pallas_fft.py:test_irfft_tail_matches_numpy
K2_TOL, K3_TOL, K4_TOL = 2e-6, 2e-6, 5e-6
# CUDA render vs CPU render: float32 FFTs of two libraries
RENDER_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(shape, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("shape,block", [
    ((64, 32, 64), None), ((64, 32, 64), (8, 4, 16, 16)), ((16, 256, 30), None),
])
@pytest.mark.parametrize("smoothing", [0.0, 3.0])
@pytest.mark.parametrize("gain", [1.0, 0.5 ** 0.5])
def test_scale_sigma_matches_plain(cuda, shape, block, smoothing, gain):
    table = sampler.make_sigma_table(rft.load_default_power(), shape, SPACING,
                                     device=cuda)
    x_off, y_off, bx, by = block or (0, 0, shape[0], shape[1])
    re0 = _randn((bx, by, shape[2] // 2 + 1), cuda, 1)
    im0 = _randn((bx, by, shape[2] // 2 + 1), cuda, 2)
    before = sampler.K2_LAUNCHES
    a, b = sampler.scale_sigma(re0.clone(), im0.clone(), table, shape, SPACING,
                               smoothing, x_off, y_off, gain)
    assert sampler.K2_LAUNCHES == before + 1
    c, d = sampler.scale_sigma_plain(re0.clone(), im0.clone(), table, shape,
                                     SPACING, smoothing, x_off, y_off, gain)
    assert _rel(a, c) <= K2_TOL and _rel(b, d) <= K2_TOL


@pytest.mark.parametrize("view", [(1, 16, 100), (3, 32, 5), (2, 128, 513),
                                  (1, 1024, 96), (2, 2048, 7), (5, 64, 1)])
def test_ifft_axis_matches_plain(cuda, view):
    re0, im0 = _randn(view, cuda, 3), _randn(view, cuda, 4)
    before = fft.K3_LAUNCHES
    a, b = fft.ifft_axis(re0.clone(), im0.clone(), *view)
    assert fft.K3_LAUNCHES == before + 1
    c, d = fft.ifft_axis_plain(re0.clone(), im0.clone(), *view)
    scale = max(float(c.abs().max()), float(d.abs().max()))
    assert max(float((a - c).abs().max()), float((b - d).abs().max())) <= K3_TOL * scale


@pytest.mark.parametrize("lead,nz", [((3, 5), 32), ((2, 8), 256), ((1, 3), 4096)])
def test_c2r_tail_matches_plain(cuda, lead, nz):
    re0 = _randn((*lead, nz // 2 + 1), cuda, 5)
    im0 = _randn((*lead, nz // 2 + 1), cuda, 6)
    im0[..., 0] = 0.0   # a packed half-spectrum's DC and Nyquist
    im0[..., -1] = 0.0  # terms are real
    w = torch.linspace(0.5, 1.5, nz, device=cuda)
    before = fft.K4_LAUNCHES
    got = fft.c2r_tail(re0, im0, nz, w)
    assert fft.K4_LAUNCHES == before + 1
    assert _rel(got, fft.c2r_tail_plain(re0, im0, nz, w)) <= K4_TOL


FFT_LENGTHS = (16, 32, 64, 128, 256, 512, 1024, 2048)


# every length, both signs; inner counts that fill no panel (8..64 columns
# a block: the rotate_panel rule), inner = 513 (a render's y pass) and one
# column
@pytest.mark.parametrize("sign", [+1, -1])
@pytest.mark.parametrize("n", FFT_LENGTHS)
def test_fft_axis_every_length_and_sign(cuda, n, sign):
    kernel, plain = ((fft.ifft_axis, fft.ifft_axis_plain) if sign > 0
                     else (fft.fft_axis, fft.fft_axis_plain))
    for view in ((2, n, fft.rotate_panel(n) + 3), (1, n, 513), (3, n, 1)):
        re0, im0 = _randn(view, cuda, 14), _randn(view, cuda, 15)
        before = fft.K3_LAUNCHES
        a, b = kernel(re0.clone(), im0.clone(), *view)
        assert fft.K3_LAUNCHES == before + 1
        c, d = plain(re0.clone(), im0.clone(), *view)
        scale = max(float(c.abs().max()), float(d.abs().max()))
        assert max(float((a - c).abs().max()),
                   float((b - d).abs().max())) <= K3_TOL * scale, view


# every m = nz / 2 = 16..2048; line counts that fill no block (256 E / m
# lines a block) and one line; with out= (a row of a stack) and without
@pytest.mark.parametrize("into", [False, True])
@pytest.mark.parametrize("m", FFT_LENGTHS)
def test_c2r_tail_every_length(cuda, m, into):
    nz = 2 * m
    w = torch.rand(nz, device=cuda) + 0.5
    for lines in (2**16 // m + 3, 1):
        re0 = _randn((lines, m + 1), cuda, 16)
        im0 = _randn((lines, m + 1), cuda, 17)
        im0[..., 0] = 0.0
        im0[..., -1] = 0.0
        stack = torch.full((3, lines, nz), float("nan"), device=cuda)
        before = fft.K4_LAUNCHES
        got = fft.c2r_tail(re0, im0, nz, w, out=stack[1] if into else None)
        assert fft.K4_LAUNCHES == before + 1
        want = fft.c2r_tail_plain(re0, im0, nz, w)
        assert _rel(got, want) <= K4_TOL, lines
        if into:
            assert got.data_ptr() == stack[1].data_ptr()
            assert torch.isnan(stack[0]).all() and torch.isnan(stack[2]).all()


def test_wrappers_raise_on_shapes_the_kernels_do_not_take(cuda):
    z = torch.zeros((1, 48, 8), device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        fft.ifft_axis(z, z.clone(), 1, 48, 8)
    z = torch.zeros((2, 2, 25), device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        fft.c2r_tail(z, z.clone(), 48, torch.ones(48, device=cuda))
    z = torch.zeros((18, 16), device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        fft.ifft_axis(z, z.clone(), 1, 16, 18)
    z = torch.zeros((2, 17), device=cuda)
    out = torch.zeros(2 * 32 + 1, device=cuda)[1:].view(2, 32)
    with pytest.raises(ValueError, match="aligned"):
        fft.c2r_tail(z, z.clone(), 32, torch.ones(32, device=cuda), out=out)
    # weights that start off an 8-byte boundary are copied, not refused
    w = torch.rand(33, device=cuda)[1:]
    got = fft.c2r_tail(z + 1.0, z.clone(), 32, w)
    assert _rel(got, fft.c2r_tail_plain(z + 1.0, z.clone(), 32, w)) <= K4_TOL


@pytest.mark.parametrize("shape,smoothing", [((32, 32, 64), 10.0),
                                             ((64, 16, 32), 0.0)])
def test_cuda_render_matches_cpu(cuda, shape, smoothing):
    seed = 7
    g = rft.Generator(*shape, grid_spacing=SPACING, device=cuda)
    before = (sampler.K2F_LAUNCHES, fft.K3_LAUNCHES, fft.K4_LAUNCHES)
    got = g.generate_delta_field(seed, smoothing_length=smoothing)
    after = (sampler.K2F_LAUNCHES, fft.K3_LAUNCHES, fft.K4_LAUNCHES)
    assert [b - a for a, b in zip(before, after)] == [1, 2, 1]
    assert torch.equal(g.generate_delta_field(seed, smoothing_length=smoothing), got)
    cpu = rft.Generator(*shape, grid_spacing=SPACING, device="cpu")
    want = cpu.generate_delta_field(seed, smoothing_length=smoothing)
    assert _rel(got.cpu(), want) <= RENDER_TOL
    before = (sampler.K2F_LAUNCHES, sampler.K2_LAUNCHES)
    noise = g.generate_noise(seed)
    assert torch.equal(g.generate_from_noise(noise, smoothing), got)
    assert (sampler.K2F_LAUNCHES, sampler.K2_LAUNCHES) == (before[0] + 1,
                                                          before[1] + 1)
    np.testing.assert_allclose(g.predicted_variance(smoothing, True),
                               cpu.predicted_variance(smoothing, True), rtol=1e-6)


# ---- sampler='pallas': K1, K5 and the render --------------------------------------

# K1 vs plain: the same float32 operations (libdevice logf/sincosf on both
# sides); the K2 bar
K1_TOL = 2e-6
# K5 vs plain: per-mode values agree to float32 rounding; the kernel adds
# them in float64 in another order than the plain version's index_add_
K5_RTOL = 1e-6


@pytest.mark.parametrize("shape", [(16, 16, 16), (32, 16, 30), (16, 256, 64)])
@pytest.mark.parametrize("smoothing", [0.0, 8.0])
def test_sample_modes_matches_plain(cuda, shape, smoothing):
    table = sampler.make_sigma_table(rft.load_default_power(), shape, SPACING,
                                     device=cuda)
    before = sampler.K1_LAUNCHES
    a, b = sampler.sample_modes(5, table, shape, SPACING, smoothing)
    assert sampler.K1_LAUNCHES == before + 1
    # the fused plain version: the raw draws with the planes symmetrized
    c, d = sampler.seeded_spectrum_plain(5, table, shape, SPACING, smoothing)
    assert _rel(a, c) <= K1_TOL and _rel(b, d) <= K1_TOL
    assert float(a[0, 0, 0]) == 0.0 and float(b[0, 0, 0]) == 0.0
    # the planes are exactly Hermitian: a non-canonical mode is its
    # partner's conjugate, a self-conjugate one real
    for p in grid.self_conjugate_kz_planes(shape[2]):
        fre, fim = (t.cpu() for t in (a[..., p], b[..., p]))
        sre, sim = transform.symmetrize_plane_reim(fre, fim, False)
        assert torch.equal(sre, fre) and torch.equal(sim, fim)


@pytest.mark.parametrize("shape", [(16, 16, 16), (32, 200, 30), (16, 16, 15)])
@pytest.mark.parametrize("smoothing", [0.0, 8.0])
def test_sample_power_bins_matches_plain(cuda, shape, smoothing):
    table = sampler.make_sigma_table(rft.load_default_power(), shape, SPACING,
                                     device=cuda)
    edges, _ = stats.bin_setup(shape, SPACING, 12)
    args = (9, table, shape, SPACING, smoothing, edges)
    before = sampler.K5_LAUNCHES
    acc = sampler.sample_power_bins(*args)
    assert sampler.K5_LAUNCHES == before + 1
    acc2 = sampler.sample_power_bins(*args)
    assert torch.equal(acc, acc2), "K5 is not repeatable bit for bit"
    # the fused plain version: interior bins plus the planes fixed and binned
    want = sampler.seeded_power_bins_plain(*args)
    assert torch.equal(acc[0], want[0])
    torch.testing.assert_close(acc[1:], want[1:], rtol=K5_RTOL, atol=0)
    # and binning K1's spectrum: every mode but DC, in the same bins
    re, im = sampler.sample_modes(9, table, shape, SPACING, smoothing)
    k, p, n = stats.spectrum_power((re, im), shape, SPACING, 12)
    np.testing.assert_array_equal(acc[0].cpu().numpy(), n)
    live = n > 0
    np.testing.assert_allclose(acc[1].cpu().numpy()[live] / n[live], p[live],
                               rtol=1e-5)


@pytest.mark.parametrize("shape", [(16, 16, 16), (32, 200, 30)])
def test_sample_power_bins_batch_rows_are_single_seeds(cuda, shape):
    table = sampler.make_sigma_table(rft.load_default_power(), shape, SPACING,
                                     device=cuda)
    edges, _ = stats.bin_setup(shape, SPACING, 12)
    plan = sampler.bin_plan(shape, SPACING, edges, cuda)
    before = sampler.K5_LAUNCHES
    block = sampler.sample_power_bins_batch([3, 8, 3], table, shape, SPACING,
                                            2.0, plan)
    assert sampler.K5_LAUNCHES == before + 1  # one launch over the batch
    assert tuple(block.shape) == (3, 3, 12)
    for row, seed in zip(block, (3, 8, 3)):
        assert torch.equal(row, sampler.sample_power_bins(seed, table, shape,
                                                          SPACING, 2.0, edges))
    assert not torch.equal(block[0], block[1])


def test_sample_power_bins_fixes_the_affine_guess_at_edges(cuda):
    # edges placed exactly on float32 |k| of lattice shells, not
    # log-uniform, and modes above the last edge: the bin the kernel
    # carries along kz must still be where the plain edge search puts it
    shape = (32, 32, 32)
    table = sampler.make_sigma_table(rft.load_default_power(), shape, SPACING,
                                     device=cuda)
    km = np.unique(grid.kmag(shape, SPACING).numpy())
    edges = np.concatenate([[km[1] * 0.999], km[[3, 8, 20, 60, 200]],
                            [km[-1] * 1.001]]).astype(np.float32).astype(np.float64)
    acc = sampler.sample_power_bins(2, table, shape, SPACING, 0.0, edges)
    want = sampler.seeded_power_bins_plain(2, table, shape, SPACING, 0.0,
                                           edges)
    assert torch.equal(acc[0], want[0])
    torch.testing.assert_close(acc[1:], want[1:], rtol=K5_RTOL, atol=0)


@pytest.mark.parametrize("shape,smoothing", [((32, 32, 64), 10.0),
                                             ((64, 16, 32), 0.0)])
def test_pallas_cuda_render_matches_cpu(cuda, shape, smoothing):
    seed = 11
    g = rft.Generator(*shape, grid_spacing=SPACING, device=cuda,
                      sampler="pallas")
    before = (sampler.K1_LAUNCHES, fft.K3_LAUNCHES, fft.K4_LAUNCHES)
    got = g.generate_delta_field(seed, smoothing_length=smoothing)
    after = (sampler.K1_LAUNCHES, fft.K3_LAUNCHES, fft.K4_LAUNCHES)
    assert [b - a for a, b in zip(before, after)] == [1, 2, 1]
    assert torch.equal(g.generate_delta_field(seed, smoothing_length=smoothing), got)
    cpu = rft.Generator(*shape, grid_spacing=SPACING, device="cpu",
                        sampler="pallas")
    want = cpu.generate_delta_field(seed, smoothing_length=smoothing)
    assert _rel(got.cpu(), want) <= RENDER_TOL
    before = sampler.K5_LAUNCHES
    k, p, n = g.sample_power(seed, smoothing, nbins=16)
    assert sampler.K5_LAUNCHES == before + 1
    kc, pc, nc = cpu.sample_power(seed, smoothing, nbins=16)
    np.testing.assert_array_equal(n, nc)
    live = n > 0
    np.testing.assert_allclose(p[live], pc[live], rtol=1e-5)
    np.testing.assert_allclose(k[live], kc[live], rtol=1e-6)


# ---- the slab mesh: K6, forward K3, K7, K8 and a one-rank mesh render --------------

# K6 vs plain: the same float32 unfold after an m-point FFT of two
# libraries; the K4 bar
K6_TOL = 5e-6


# every length the kernel takes (nz / 2 = 16..2048); line counts that fill
# no block's lines (a block owns 256 E / m of them: 64 at nz = 32, 8 at 1024,
# 2 at 4096), and one line
@pytest.mark.parametrize("lead,nz", [((3, 5), 32), ((2, 8), 256), ((4, 64), 1024),
                                     ((1, 3), 4096), ((1,), 32), ((3, 7), 64),
                                     ((70,), 128), ((5,), 512), ((1,), 1024),
                                     ((37,), 1024), ((9,), 2048), ((1,), 4096)])
def test_r2c_head_matches_plain(cuda, lead, nz):
    x = _randn((*lead, nz), cuda, 7)
    before = fft.K6_LAUNCHES
    re, im = fft.r2c_head(x)
    assert fft.K6_LAUNCHES == before + 1
    c = torch.fft.rfft(x)
    scale = max(float(c.real.abs().max()), float(c.imag.abs().max()))
    for want in (fft.r2c_head_plain(x), (c.real, c.imag)):
        assert max(float((re - want[0]).abs().max()),
                   float((im - want[1]).abs().max())) <= K6_TOL * scale


@pytest.mark.parametrize("view", [(1, 16, 100), (2, 128, 513), (3, 2048, 5)])
def test_fft_axis_forward_matches_plain(cuda, view):
    re0, im0 = _randn(view, cuda, 8), _randn(view, cuda, 9)
    before = fft.K3_LAUNCHES
    a, b = fft.fft_axis(re0.clone(), im0.clone(), *view)
    assert fft.K3_LAUNCHES == before + 1
    c, d = fft.fft_axis_plain(re0.clone(), im0.clone(), *view)
    scale = max(float(c.abs().max()), float(d.abs().max()))
    assert max(float((a - c).abs().max()), float((b - d).abs().max())) <= K3_TOL * scale


@pytest.mark.parametrize("shape,ranks", [((32, 64, 32), 4), ((16, 32, 30), 2)])
@pytest.mark.parametrize("smoothing", [0.0, 3.0])
def test_k7_shards_match_plain_and_their_union_is_k2(cuda, shape, ranks, smoothing):
    # K7 is the fused K2 on a shard: its union is whole-grid draw_scale
    table = sampler.make_sigma_table(rft.load_default_power(), shape, SPACING,
                                     device=cuda)
    whole = sampler.draw_scale(4, table, shape, SPACING, smoothing)
    ny_loc = shape[1] // ranks
    for r in range(ranks):
        rows = slice(r * ny_loc, (r + 1) * ny_loc)
        before = sampler.K7_LAUNCHES
        got = sampler.draw_scale_shard(4, table, shape, SPACING, smoothing,
                                       r * ny_loc, ny_loc)
        assert sampler.K7_LAUNCHES == before + 1
        want = sampler.draw_scale_plain(4, table, shape, SPACING, smoothing,
                                        0, r * ny_loc, None, ny_loc)
        assert _rel(got, want) <= K2_TOL
        assert torch.equal(got, whole[:, :, rows])


# the fused K2 vs its plain chain on the card: bits exact; unit normals
# within 3 ulps (the same float32 operations and libdevice log1pf and sqrtf
# on both sides: 0 measured at 1024^3); the spectrum within K2's bar (its
# sigma amplitude is K2's, about 2e-7 off the plain version's)
DRAW_ULPS = 3


def _ulps(a, b):
    return int((a.view(torch.int32).long() - b.view(torch.int32).long())
               .abs().max())


def test_draw_normals_match_plain_on_every_mantissa(cuda):
    # the fused kernel's jax_normal reads bits >> 9: all 2^23 inputs
    bits = torch.arange(2**23, dtype=torch.int64, device=cuda) << 9
    got = sampler.draw_normals(bits)
    want = threefry._normal_from_bits(bits)  # the plain version, on the card
    # the same float32 operations and libdevice calls (log1pf's own
    # operations, in threefry.cuh:log1pf_neg): equal on every input
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,block", [
    ((16, 16, 16), None), ((64, 32, 64), None), ((32, 16, 30), None),
    ((48, 16, 32), None), ((64, 32, 64), (8, 5, 24, 13)),
])
@pytest.mark.parametrize("smoothing", [0.0, 8.0])
def test_draw_scale_matches_plain(cuda, shape, block, smoothing):
    table = sampler.make_sigma_table(rft.load_default_power(), shape, SPACING,
                                     device=cuda)
    x_off, y_off, nx_loc, ny_loc = block or (0, 0, None, None)
    rows = (x_off, y_off, nx_loc, ny_loc)
    before = sampler.K2F_LAUNCHES
    bits = sampler.draw_bits(4, table, shape, *rows)
    unit = sampler.draw_scale(4, table, shape, SPACING, smoothing, *rows,
                              unit=True)
    got = sampler.draw_scale(4, table, shape, SPACING, smoothing, *rows)
    assert sampler.K2F_LAUNCHES == before + 3
    cpu_table = sampler.SigmaTable(table.lk0, table.dlk, table.knots.cpu())
    assert torch.equal(bits.cpu(), sampler.draw_bits(4, cpu_table, shape,
                                                     *rows))
    assert _ulps(unit, sampler.draw_scale_plain(
        4, table, shape, SPACING, smoothing, *rows, unit=True)) <= DRAW_ULPS
    want = sampler.draw_scale_plain(4, table, shape, SPACING, smoothing, *rows)
    assert _rel(got, want) <= K2_TOL


@pytest.mark.parametrize("shape,ranks", [((16, 64, 32), 4), ((32, 16, 30), 2)])
@pytest.mark.parametrize("smoothing", [0.0, 8.0])
def test_k8_shards_match_plain_and_their_union_is_k1(cuda, shape, ranks, smoothing):
    table = sampler.make_sigma_table(rft.load_default_power(), shape, SPACING,
                                     device=cuda)
    whole = sampler.sample_modes(5, table, shape, SPACING, smoothing)
    ny_loc = shape[1] // ranks
    for r in range(ranks):
        before = sampler.K8_LAUNCHES
        a, b = sampler.sample_shard(5, table, shape, SPACING, smoothing,
                                    r * ny_loc, ny_loc)
        assert sampler.K8_LAUNCHES == before + 1
        c, d = sampler.seeded_spectrum_plain(5, table, shape, SPACING,
                                             smoothing, r * ny_loc, ny_loc)
        assert _rel(a, c) <= K1_TOL and _rel(b, d) <= K1_TOL
        rows = slice(r * ny_loc, (r + 1) * ny_loc)
        assert torch.equal(a, whole[0][:, rows]) and torch.equal(b, whole[1][:, rows])


@pytest.mark.parametrize("name", ["threefry", "pallas"])
def test_one_rank_mesh_render_equals_single_device(cuda, name):
    from randomfield_tpu_torch.parallel.mesh import make_mesh

    shape = (32, 32, 64)
    mesh = make_mesh(device=cuda)  # no process group: one rank
    g = rft.Generator(*shape, grid_spacing=SPACING, mesh=mesh, sampler=name)
    one = rft.Generator(*shape, grid_spacing=SPACING, device=cuda, sampler=name)
    kernel = "K7_LAUNCHES" if name == "threefry" else "K8_LAUNCHES"
    before = getattr(sampler, kernel)
    field = g.generate_delta_field(3, smoothing_length=5.0)
    assert getattr(sampler, kernel) == before + 1
    assert torch.equal(field, one.generate_delta_field(3, smoothing_length=5.0))
    before = fft.K6_LAUNCHES
    k, p, n = g.calculate_power(field, nbins=12)
    assert fft.K6_LAUNCHES == before + 1
    kw, pw, nw = one.calculate_power(field, nbins=12)
    np.testing.assert_array_equal(n, nw)
    live = nw > 0
    np.testing.assert_allclose(p[live], pw[live], rtol=1e-5)


# ---- the staged variants: K9, K10, the v4 and v6 renders, the seed batch ----------

# K9 vs plain: a two- or three-pass float32 Stockham transform against
# cuFFT's (K3's bar; measured 2-4e-7); K10 vs plain: K1's draws through an
# nx-point transform of two libraries (the K4 bar)
K9_TOL, K10_TOL = 2e-6, 5e-6
# the v4 render vs the default render: the same spectrum through K9's passes
# and through K3's, the same plans and tables in two kernels (RENDER_TOL's
# class; bit-equal on an H100 while both ran the same stages)
V4_TOL = 1e-5


# every length 16..2048; column counts that fill no panel (8..64 columns a
# block), and one column
@pytest.mark.parametrize("groups,n,cols", [(1, 16, 100), (3, 32, 5), (2, 128, 513),
                                           (1, 1024, 96), (2, 2048, 7), (5, 64, 1),
                                           (1, 64, 33 * 32), (2, 256, 19),
                                           (3, 512, 9), (1, 1024, 1),
                                           (2, 1024, 21), (1, 2048, 1),
                                           (1, 16, 1)])
def test_ifft_rotate_matches_plain(cuda, groups, n, cols):
    re0 = _randn((groups * n, cols), cuda, 12)
    im0 = _randn((groups * n, cols), cuda, 13)
    keep = re0.clone(), im0.clone()
    before = fft.K9_LAUNCHES
    a, b = fft.ifft_rotate(re0, im0, groups, n, cols)
    assert fft.K9_LAUNCHES == before + 1
    assert tuple(a.shape) == tuple(b.shape) == (groups * cols, n)
    assert torch.equal(re0, keep[0]) and torch.equal(im0, keep[1])
    c, d = fft.ifft_rotate_plain(re0, im0, groups, n, cols)
    scale = max(float(c.abs().max()), float(d.abs().max()))
    assert max(float((a - c).abs().max()), float((b - d).abs().max())) <= K9_TOL * scale
    # K3's transform of the same view, rotated: the same plan and tables in
    # two kernels, each within its bar of cuFFT, so within their sum
    e, f = fft.ifft_axis(re0.clone(), im0.clone(), groups, n, cols)
    apart = max(
        float((a.view(groups, cols, n) - e.view(groups, n, cols).transpose(1, 2)).abs().max()),
        float((b.view(groups, cols, n) - f.view(groups, n, cols).transpose(1, 2)).abs().max()))
    assert apart <= (K9_TOL + K3_TOL) * scale


@pytest.mark.parametrize("kernel,sign", [("r2c_head", 1), ("ifft_rotate", 1),
                                         ("fft_axis", 1), ("fft_axis", -1),
                                         ("c2r_tail", 1)])
@pytest.mark.parametrize("n", [16, 32, 64, 128, 256, 512, 1024, 2048])
def test_register_radix_instances_fit_an_sm(cuda, kernel, sign, n):
    regs, blocks, threads, smem = fft.kernel_attributes(kernel, n, sign)
    assert 0 < regs <= 64 and blocks >= 1 and blocks * threads <= 2048
    assert threads <= 1024 and smem <= 227 * 1024


@pytest.mark.parametrize("n", [16, 32, 64, 128, 256, 512, 1024, 2048])
def test_sample_fftx_instances_fit_an_sm(cuda, n):
    knots = sampler.table_knot_count((n, 1024, 1024))
    regs, blocks, threads, smem = genfft.kernel_attributes(n, knots)
    assert 0 < regs <= 64 and blocks >= 1 and blocks * threads <= 2048
    assert threads == 256 and smem <= 227 * 1024


@pytest.mark.parametrize("shape", [(16, 16, 16), (32, 12, 30), (256, 8, 6),
                                   (2048, 3, 4), (64, 5, 10), (128, 7, 6),
                                   (512, 3, 6), (1024, 5, 8)])
@pytest.mark.parametrize("smoothing", [0.0, 8.0])
def test_sample_fftx_matches_plain(cuda, shape, smoothing):
    table = sampler.make_sigma_table(rft.load_default_power(), shape, SPACING,
                                     device=cuda)
    before = genfft.K10_LAUNCHES
    a, b = genfft.sample_fftx(5, table, shape, SPACING, smoothing)
    assert genfft.K10_LAUNCHES == before + 1
    nx, ny, nz = shape
    assert tuple(a.shape) == ((nz // 2 + 1) * ny, nx)
    c, d = genfft.seeded_fftx_plain(5, table, shape, SPACING, smoothing)
    scale = max(float(c.abs().max()), float(d.abs().max()))
    assert max(float((a - c).abs().max()), float((b - d).abs().max())) <= K10_TOL * scale
    again = genfft.sample_fftx(5, table, shape, SPACING, smoothing)
    assert torch.equal(a, again[0]) and torch.equal(b, again[1])


def test_k9_k10_raise_on_grids_the_kernels_do_not_take(cuda):
    z = torch.zeros((48, 8), device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        fft.ifft_rotate(z, z.clone(), 1, 48, 8)
    table = sampler.make_sigma_table(rft.load_default_power(), (48, 16, 16),
                                     SPACING, device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        genfft.sample_fftx(1, table, (48, 16, 16), SPACING)
    with pytest.raises(ValueError, match="even"):
        genfft.sample_fftx(1, table, (16, 16, 15), SPACING)


@pytest.mark.parametrize("variant,kernels", [
    ("v4", {"K1": 1, "K9": 2, "K3": 0, "K4": 1, "K10": 0}),
    ("v6", {"K1": 0, "K9": 0, "K3": 1, "K4": 1, "K10": 1}),
])
@pytest.mark.parametrize("shape,smoothing", [((32, 32, 64), 10.0),
                                             ((64, 16, 32), 0.0)])
def test_staged_variant_cuda_render_matches_cpu(cuda, monkeypatch, variant,
                                                kernels, shape, smoothing):
    def counts():
        return {"K1": sampler.K1_LAUNCHES, "K3": fft.K3_LAUNCHES,
                "K4": fft.K4_LAUNCHES, "K9": fft.K9_LAUNCHES,
                "K10": genfft.K10_LAUNCHES}

    seed = 11
    g = rft.Generator(*shape, grid_spacing=SPACING, device=cuda,
                      sampler="pallas")
    default = g.generate_delta_field(seed, smoothing_length=smoothing)
    monkeypatch.setenv(staged.PIPELINE_ENV, variant)
    before = counts()
    got = g.generate_delta_field(seed, smoothing_length=smoothing)
    after = counts()
    assert {k: after[k] - before[k] for k in kernels} == kernels
    assert torch.equal(g.generate_delta_field(seed, smoothing_length=smoothing), got)
    cpu = rft.Generator(*shape, grid_spacing=SPACING, device="cpu",
                        sampler="pallas")
    want = cpu.generate_delta_field(seed, smoothing_length=smoothing)
    assert _rel(got.cpu(), want) <= RENDER_TOL
    if variant == "v4":
        assert _rel(got, default) <= V4_TOL
    else:
        assert _rel(got, default) > 0.1
    batch = g.generate_delta_fields([seed, seed + 1], smoothing_length=smoothing)
    assert tuple(batch.shape) == (2, *shape) and torch.equal(batch[0], got)
    assert torch.equal(batch[1], g.generate_delta_field(
        seed + 1, smoothing_length=smoothing))


def test_staged_threefry_cuda_render_equals_auto(cuda):
    shape = (32, 32, 64)
    a = rft.Generator(*shape, grid_spacing=SPACING, device=cuda,
                      pipeline="staged").generate_delta_field(4)
    b = rft.Generator(*shape, grid_spacing=SPACING,
                      device=cuda).generate_delta_field(4)
    assert torch.equal(a, b)
    assert staged.can_batch_staged(shape, 4, cuda)
    assert not staged.can_batch_staged((2048, 2048, 2048), 4, cuda)


# ---- KN (the nested stream), K2F's fixed mode, KD (the derived fields) -------

NESTED_SHAPES = [(16, 16, 16), (64, 32, 64), (32, 16, 30), (32, 64, 18)]


def _table(shape, dev):
    return sampler.make_sigma_table(rft.load_default_power(), shape, SPACING,
                                    device=dev)


@pytest.mark.parametrize("shape", NESTED_SHAPES)
@pytest.mark.parametrize("smoothing", [0.0, 8.0])
def test_nested_kernel_matches_plain(cuda, shape, smoothing):
    table = _table(shape, cuda)
    before = sampler.KN_LAUNCHES
    got = {m: sampler.sample_nested(4, table, shape, SPACING, smoothing,
                                    mode=m)
           for m in sampler.NESTED_MODES}
    assert sampler.KN_LAUNCHES == before + len(sampler.NESTED_MODES)
    for m, out in got.items():
        want = sampler.sample_nested_plain(4, table, shape, SPACING,
                                           smoothing, mode=m)
        if m == "bits":
            assert torch.equal(out, want)
        else:
            # Box-Muller's libdevice logf/sincosf against torch's
            assert _rel(out, want) <= K2_TOL, m
    # the render's spectrum is the fix and K2 on the unit mode, bit for bit
    re, im = got["unit"][0].clone(), got["unit"][1].clone()
    re, im = staged.scaled_draws(re, im, table, shape, SPACING, smoothing)
    assert torch.equal(torch.stack([re, im]), got["spectrum"])
    flip = sampler.sample_nested(4, table, shape, SPACING, smoothing,
                                 mode="fixed", flip=True)
    assert torch.equal(flip, -got["fixed"])


@pytest.mark.parametrize("shape", [(16, 16, 16), (64, 32, 64), (32, 16, 30)])
@pytest.mark.parametrize("smoothing", [0.0, 8.0])
def test_draw_fixed_matches_plain(cuda, shape, smoothing):
    table = _table(shape, cuda)
    before = sampler.K2FX_LAUNCHES
    got = sampler.draw_fixed(4, table, shape, SPACING, smoothing)
    flip = sampler.draw_fixed(4, table, shape, SPACING, smoothing, flip=True)
    assert sampler.K2FX_LAUNCHES == before + 2
    want = sampler.draw_fixed_plain(4, table, shape, SPACING, smoothing)
    assert _rel(got, want) <= K2_TOL
    # phase.cuh:unit_phase is sqrt.rn's and div.rn's fast paths, so the
    # modulus and the quotients round as torch's sqrt and division: the
    # kernel is the plain z / |z| of the plain draws scaled by K2 bit for
    # bit (the plain version's own amplitude, sigma_amplitude, is within
    # K2_TOL of K2's)
    re, im = sample.unit_phase(*sample._hermitian_draws(
        threefry.as_key(4), shape, cuda, False))
    sampler.scale_sigma(re, im, table, shape, SPACING, smoothing, gain=1.0)
    assert torch.equal(got, torch.stack([re, im]))
    assert torch.equal(flip, -got)
    # |c| is the amplitude the spectrum mode applies, up to the 1/sqrt(2)
    amp = sampler.sigma_amplitude(table, shape, SPACING, smoothing)
    mag = torch.sqrt(got[0] ** 2 + got[1] ** 2)
    assert float((mag - amp).abs().max()) <= 3e-6 * float(amp.abs().max())


def test_unit_phases_match_plain(cuda):
    # every canonical normal against rolled partners, zero and itself, the
    # signed zero pairs, and random components across [2^-24, 2^4)
    n = threefry._normal_from_bits(
        torch.arange(2**23, dtype=torch.int64, device=cuda) << 9)
    zero = torch.zeros_like(n)
    rng = np.random.default_rng(5)
    words = ((rng.integers(0, 2, 2**20, dtype=np.int64) << 31)
             | (rng.integers(103, 131, 2**20, dtype=np.int64) << 23)
             | rng.integers(0, 2**23, 2**20, dtype=np.int64))
    rand = torch.from_numpy(words.astype(np.uint32).view(np.float32)).to(cuda)
    z = torch.tensor([0.0, -0.0], device=cuda).repeat(32)
    re = torch.cat([n, n, n, n * float(np.float32(np.sqrt(2))), z,
                    rand[::2]])
    im = torch.cat([zero, n, torch.roll(n, 12345), zero,
                    z.view(2, 32).t().reshape(-1), rand[1::2]])
    got = sampler.unit_phases(re.view(-1, 64), im.view(-1, 64))
    want = sample.unit_phase(re.view(-1, 64).clone(), im.view(-1, 64).clone())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


KD_CASES = ([("scalar", 0)] + [("grad", a) for a in range(3)]
            + [("tidal", c) for c in range(6)] + [("kaiser", a) for a in range(3)])


@pytest.mark.parametrize("shape", [(16, 16, 16), (32, 64, 30), (64, 16, 9)])
@pytest.mark.parametrize("kind,comp", KD_CASES)
def test_spectral_kernel_matches_plain(cuda, shape, kind, comp):
    nzh = shape[2] // 2 + 1
    re0 = _randn((shape[0], shape[1], nzh), cuda, 21)
    im0 = _randn((shape[0], shape[1], nzh), cuda, 22)
    pref = (1.5, 0.6) if kind == "kaiser" else -0.37
    before = derived.KD_LAUNCHES
    a, b = derived.apply_kernel(re0.clone(), im0.clone(), shape, SPACING,
                                kind, comp, pref)
    assert derived.KD_LAUNCHES == before + 1
    c, d = derived.apply_kernel_plain(re0.clone(), im0.clone(), shape,
                                      SPACING, kind, comp, pref)
    # the same float32 operations in the same order
    assert torch.equal(a, c) and torch.equal(b, d)


def test_spectral_kernel_2lpt_diagonals_match_plain(cuda):
    shape = (32, 16, 32)
    re0, im0 = _randn((32, 16, 17), cuda, 23), _randn((32, 16, 17), cuda, 24)
    for comp in range(3):
        a, b = derived.apply_kernel(re0.clone(), im0.clone(), shape, SPACING,
                                    "tidal", comp, 0.5, grad_diag=True)
        c, d = derived.apply_kernel_plain(re0.clone(), im0.clone(), shape,
                                          SPACING, "tidal", comp, 0.5,
                                          grad_diag=True)
        assert torch.equal(a, c) and torch.equal(b, d)


def test_rfftn_runs_k6_and_forward_k3(cuda):
    x = _randn((32, 16, 64), cuda, 25)
    before = (fft.K6_LAUNCHES, fft.K3_LAUNCHES)
    re, im = transform.rfftn(x)
    assert (fft.K6_LAUNCHES, fft.K3_LAUNCHES) == (before[0] + 1, before[1] + 2)
    want = torch.fft.rfftn(x)
    assert _rel(torch.stack([re, im]),
                torch.stack([want.real, want.imag])) <= K4_TOL
    assert transform.is_hermitian(re, im, 64, atol=1e-4)


@pytest.mark.parametrize("sampler_name", ["threefry", "pallas", "nested"])
def test_derived_cuda_matches_cpu(cuda, sampler_name):
    shape, seed, s = (32, 32, 64), 6, 20.0
    g = rft.Generator(*shape, grid_spacing=SPACING, device=cuda,
                      sampler=sampler_name)
    gc = rft.Generator(*shape, grid_spacing=SPACING, device="cpu",
                       sampler=sampler_name)
    before = derived.KD_LAUNCHES
    for name, kw in (("generate_potential", dict(z=0.5)),
                     ("generate_displacement", {}),
                     ("generate_displacement", dict(order=2)),
                     ("generate_velocity", dict(z=1.0)),
                     ("generate_tidal_field", {}),
                     ("generate_kaiser_field", dict(z=0.3, bias=1.4))):
        got = getattr(g, name)(seed, smoothing_length=s, **kw)
        want = getattr(gc, name)(seed, smoothing_length=s, **kw)
        assert _rel(got.cpu(), want) <= RENDER_TOL, (name, kw)
    assert derived.KD_LAUNCHES >= before + 1 + 3 + 3 + 9 + 3 + 6 + 1
    if sampler_name != "pallas":
        for flip in (False, True):
            got = g.generate_fixed_field(seed, smoothing_length=s, flip=flip)
            want = gc.generate_fixed_field(seed, smoothing_length=s, flip=flip)
            assert _rel(got.cpu(), want) <= RENDER_TOL
    classes = g.classify_web(seed, smoothing_length=s)
    assert classes.dtype == torch.int8 and classes.device.type == "cuda"
    assert abs(web.web_fractions(classes).sum() - 1.0) < 1e-12


def test_nested_cuda_render_and_noise(cuda):
    shape = (32, 32, 64)
    g = rft.Generator(*shape, grid_spacing=SPACING, device=cuda,
                      sampler="nested")
    gc = rft.Generator(*shape, grid_spacing=SPACING, device="cpu",
                       sampler="nested")
    before = sampler.KN_LAUNCHES
    field = g.generate_delta_field(3, smoothing_length=10.0)
    assert sampler.KN_LAUNCHES == before + 1
    assert _rel(field.cpu(), gc.generate_delta_field(
        3, smoothing_length=10.0)) <= RENDER_TOL
    noise = g.generate_noise(3)
    assert torch.equal(g.generate_from_noise(noise, smoothing_length=10.0),
                       field)
    key = threefry.key_from_seed(3)
    want = torch.stack(sample.nested_unit_draws(key, shape))
    assert _rel(noise.cpu(), want) <= K2_TOL


# ---- KB and the estimators on the card ---------------------------------------

# KB vs its plain version: the same float32 terms a mode, added in float64
# in another order (runs, warps, blocks vs index_add_); counts exactly
KB_SUM_RTOL = 1e-10
# a CUDA estimator vs the same estimator on the CPU: the hand FFTs against
# torch.fft (float32 rounding of the spectrum), the sums in float64 both
ESTIMATOR_RTOL = 1e-5

KB_CASES = [
    ("auto", (64, 32, 64), {}),
    ("auto", (64, 32, 64), dict(order=2)),
    ("auto", (32, 48, 30), dict(ells=(0, 2, 4), los_axis=1)),
    ("cross", (64, 32, 64), dict(nmu=4)),
    ("interlaced", (32, 32, 66), dict(order=3, ells=(2, 4))),
    ("grid", (48, 32, 40), dict(nmu=3, los_axis=0)),
    ("auto", (64, 64, 32), dict(y_off=16)),
    # kz lines of 16, 17, 18, 34 and 1024 floats: below, at and above a
    # step of 32 lanes, and a tile of 4 lines not a multiple of 16 bytes
    ("auto", (8, 6, 30), {}),
    ("cross", (6, 5, 32), dict(order=1)),
    ("interlaced", (4, 7, 34), dict(nmu=2)),
    ("grid", (3, 5, 66), dict(ells=(0, 4))),
    ("auto", (4, 4, 2046), dict(ells=(0, 2))),
    # one line; line counts that are not a multiple of the tile's 4; odd
    # ny_loc with y_off
    ("auto", (1, 1, 64), {}),
    ("grid", (5, 3, 64), dict(order=2)),
    ("cross", (8, 16, 64), dict(y_off=3, nmu=3)),
    ("interlaced", (3, 9, 30), dict(y_off=2)),
    # MAX_BINS with multipoles and with wedges (the shared memory's budget)
    ("auto", (16, 16, 64), dict(ells=(0, 2, 4), nbins=1024)),
    ("interlaced", (16, 8, 2046), dict(ells=(0, 2, 4), nbins=1024)),
    ("cross", (16, 16, 64), dict(nmu=4, nbins=256)),
]


@pytest.mark.parametrize("kind,shape,kw", KB_CASES)
def test_bin_spectrum_matches_plain(cuda, kind, shape, kw):
    from randomfield_tpu_torch.ops import binning

    nx, ny, nz = shape
    kw = dict(kw)
    nbins = kw.pop("nbins", 12)
    rows = ny - kw.get("y_off", 0)
    arrays = [_randn((nx, rows, nz // 2 + 1), cuda, 40 + i)
              for i in range(binning.KINDS[kind][1])]
    if kind == "grid":
        arrays = [a.abs() for a in arrays]
    edges, _ = stats.bin_setup(shape, SPACING, nbins)
    before = binning.KB_LAUNCHES
    got = binning.bin_spectrum(kind, arrays, shape, SPACING, edges,
                               factor=0.25, **kw)
    again = binning.bin_spectrum(kind, arrays, shape, SPACING, edges,
                                 factor=0.25, **kw)
    assert binning.KB_LAUNCHES == before + 2
    assert torch.equal(got, again)
    want = binning.bin_spectrum_plain(kind, arrays, shape, SPACING, edges,
                                      factor=0.25, **kw)
    assert torch.equal(got[:, 0], want[:, 0])
    scale = float(want[:, 1:].abs().max())
    assert float((got[:, 1:] - want[:, 1:]).abs().max()) <= KB_SUM_RTOL * scale


def test_bin_spectrum_keeps_its_geometry(cuda):
    """The counts and |k| sums come from one geometry pass a geometry:
    another spectrum or kind on the same bins reuses them, other wedges or
    other rows do not."""
    from randomfield_tpu_torch.ops import binning

    shape = (16, 12, 64)
    edges, _ = stats.bin_setup(shape, SPACING, 9)
    a = [_randn((16, 12, 33), cuda, 60 + i) for i in range(4)]
    binning._geometry.cache_clear()
    before = binning.KB_GEOMETRY_LAUNCHES
    auto = binning.bin_spectrum("auto", a[:2], shape, SPACING, edges)
    cross = binning.bin_spectrum("cross", a, shape, SPACING, edges,
                                 ells=(0, 2))
    assert binning.KB_GEOMETRY_LAUNCHES == before + 1
    assert torch.equal(auto[0, 0], cross[0, 0])
    assert torch.equal(auto[0, 2], cross[1, 2])
    binning.bin_spectrum("auto", a[:2], shape, SPACING, edges, nmu=3)
    binning.bin_spectrum("auto", [t[:, 2:] for t in a[:2]], shape, SPACING,
                         edges, y_off=2)
    assert binning.KB_GEOMETRY_LAUNCHES == before + 3


@pytest.mark.parametrize("n", [1, 2, 4])
def test_read_probe_sums_the_lattices(cuda, n):
    from randomfield_tpu_torch.ops import binning

    arrays = [_randn((6, 7, 33), cuda, 70 + i).abs() for i in range(n)]
    got = float(binning.read_probe(arrays))
    want = sum(float(a.double().sum()) for a in arrays)
    assert abs(got - want) <= 1e-5 * want


def test_bin_spectrum_raises_above_its_bins(cuda):
    from randomfield_tpu_torch.ops import binning

    re = torch.zeros((16, 16, 9), device=cuda)
    edges, _ = stats.bin_setup((16, 16, 16), SPACING, 300)
    with pytest.raises(ValueError, match="at most"):
        binning.bin_spectrum("auto", (re, re), (16, 16, 16), SPACING, edges,
                             nmu=4)


def test_estimators_on_the_card_match_the_cpu(cuda):
    from randomfield_tpu_torch.ops import binning
    from randomfield_tpu_torch.validate import bispectrum

    shape = (32, 32, 64)
    d, d2 = _randn(shape, cuda, 50), _randn(shape, cuda, 51)
    dc, d2c = d.cpu(), d2.cpu()
    calls = [
        lambda a, b: stats.calculate_power(a, SPACING, 10),
        lambda a, b: stats.calculate_power(a, SPACING, 10, window="cic",
                                           interlaced_with=b),
        lambda a, b: stats.calculate_power_multipoles(a, SPACING, 10),
        lambda a, b: stats.calculate_power_wedges(a, SPACING, 10, nmu=3),
        lambda a, b: stats.calculate_cross_power(a, b, SPACING, 10),
    ]
    before = (binning.KB_LAUNCHES, fft.K6_LAUNCHES, transform.TORCH_FFT_CALLS)
    for call in calls:
        for got, want in zip(call(d, d2), call(dc, d2c)):
            # of the largest value: a quadrupole bin may sit near 0
            np.testing.assert_allclose(
                got, want, rtol=ESTIMATOR_RTOL,
                atol=ESTIMATOR_RTOL * np.nanmax(np.abs(want)))
    assert binning.KB_LAUNCHES == before[0] + len(calls)
    assert fft.K6_LAUNCHES >= before[1] + len(calls)
    assert transform.TORCH_FFT_CALLS == before[2]
    for got, want in zip(stats.calculate_correlation(d, SPACING, 8),
                         stats.calculate_correlation(dc, SPACING, 8)):
        np.testing.assert_allclose(got, want, rtol=ESTIMATOR_RTOL,
                                   atol=ESTIMATOR_RTOL * np.abs(want).max())
    got = bispectrum.calculate_bispectrum(d, SPACING, nbins=4)
    want = bispectrum.calculate_bispectrum(dc, SPACING, nbins=4)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[3], want[3], rtol=1e-4)
    np.testing.assert_allclose(got[2], want[2], rtol=0,
                               atol=1e-3 * np.abs(want[2]).max())


def test_transforms_of_other_grids_go_to_torch_fft(cuda):
    x = _randn((24, 16, 20), cuda, 52)
    before = (transform.TORCH_FFT_CALLS, fft.K6_LAUNCHES)
    re, im = transform.rfftn(x)
    assert transform.TORCH_FFT_CALLS == before[0] + 1
    assert fft.K6_LAUNCHES == before[1]
    want = torch.fft.rfftn(x)
    assert torch.equal(re, want.real) and torch.equal(im, want.imag)
    k, p, n = stats.calculate_power(x, SPACING, 6)
    kc, pc, nc = stats.calculate_power(x.cpu(), SPACING, 6)
    np.testing.assert_array_equal(n, nc)
    np.testing.assert_allclose(p, pc, rtol=ESTIMATOR_RTOL)


def test_nongaussian_and_measure_methods_on_the_card(cuda):
    shape = (32, 32, 64)
    g = rft.Generator(*shape, grid_spacing=SPACING, device=cuda)
    gc = rft.Generator(*shape, grid_spacing=SPACING, device="cpu")
    for kind, fnl in (("field", 100.0), ("potential", 2e3)):
        got = g.generate_nongaussian_field(2, fnl, kind=kind)
        want = gc.generate_nongaussian_field(2, fnl, kind=kind)
        assert _rel(got.cpu(), want) <= RENDER_TOL
    assert torch.equal(g.generate_nongaussian_field(2, 0.0),
                       g.generate_delta_field(2, apply_lightcone=False))
    for name, kw in (("predicted_kaiser_multipoles", {}),
                     ("predicted_kaiser_wedges", dict(nmu=3)),
                     ("predicted_derived_power", dict(kind="velocity"))):
        got = getattr(g, name)(nbins=10, **kw)
        want = getattr(gc, name)(nbins=10, **kw)
        np.testing.assert_array_equal(got[2], want[2])
        # the table interpolated in float32 by two libraries' log10
        np.testing.assert_allclose(got[1], want[1], rtol=ESTIMATOR_RTOL)


# ---- KP, KC and K4L: the mock makers' kernels ----------------------------------

def _catalog(shape, n_extra, dev, seed=5):
    """float32 (3, n) positions: one a cell displaced, particles exactly on
    cell faces and at the box edge L, and a few outside [0, L)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = int(np.prod(shape))
    box = torch.tensor(shape, dtype=torch.float32)[:, None] * SPACING
    pos = torch.rand((3, n), generator=g) * box
    faces = (torch.randint(0, 2 * max(shape) + 1, (3, n_extra), generator=g)
             .to(torch.float32) * (SPACING / 2))
    faces[:, :3] = box[:, :1].expand(3, 3)
    faces[:, 3] = -SPACING / 2
    return torch.cat([pos, faces], 1).to(dev)


@pytest.mark.parametrize("window", ["ngp", "cic", "tsc"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shift", [0.0, SPACING / 2])
def test_paint_kernel_equals_plain_bit_for_bit(cuda, window, weighted, shift):
    from randomfield_tpu_torch.ops import paint

    shape = (16, 32, 24)
    pos = _catalog(shape, 64, cuda)
    w = (torch.rand(pos.shape[1], device=cuda) * 2.0 if weighted else 1.5)
    order = paint.ORDERS[window]
    s = paint.fixed_point_exponent(paint.total_abs_weight(pos, w))
    before = paint.KP_LAUNCHES
    got = paint.deposit(pos, shape, SPACING, w, order, shift, s)
    again = paint.deposit(pos, shape, SPACING, w, order, shift, s)
    assert paint.KP_LAUNCHES == before + 2
    want = paint.deposit_plain(pos, shape, SPACING, w, order, shift, s)
    assert torch.equal(got, want) and torch.equal(got, again)
    kpc = paint.KPC_LAUNCHES
    d, mean = paint.contrast(got, s)
    assert paint.KPC_LAUNCHES == kpc + 1
    dp, mp = paint.contrast_plain(want, s)
    assert mean == mp and torch.equal(d, dp)


def _paint_case(case, dev):
    """(float32 (3, n) positions, grid shape, weights) of one of the tiled
    deposit's edge cases."""
    g = torch.Generator(device="cpu").manual_seed(len(case))
    shape = {"edges": (17, 33, 5), "wrap": (32, 16, 20)}.get(case,
                                                             (16, 32, 24))
    box = torch.tensor(shape, dtype=torch.float32)[:, None] * SPACING
    n = int(np.prod(shape))
    w = 1.0
    if case in ("edges", "negative", "tiny"):
        pos = torch.rand((3, n), generator=g) * box
        w = torch.rand(n, generator=g) * 2.0 - (1.0 if case == "negative"
                                                else 0.0)
        if case == "tiny":  # 2^s beyond float32's range: float64 products
            w = w * 1e-25
    elif case == "wrap":  # half the particles outside [0, L)
        pos = (torch.rand((3, n), generator=g) * 2.0 - 0.5) * box
    elif case == "faces":  # on cell faces, at L and at -a/2
        pos = _catalog(shape, 4 * n, "cpu")[:, n:]
    elif case in ("lattice", "random"):  # displaced lattice points
        axes = [(torch.arange(d) + 0.5) * SPACING for d in shape]
        q = torch.stack(torch.meshgrid(*axes, indexing="ij")).reshape(3, -1)
        pos = torch.remainder(q + torch.randn((3, n), generator=g)
                              * 1.5 * SPACING, box)
        if case == "random":
            pos = pos[:, torch.randperm(n, generator=g)]
    elif case == "one_cell":
        pos = torch.full((3, 5000), 3.3 * SPACING)
    elif case == "one":
        pos = torch.tensor([[0.2], [31.9], [5.0]]) * SPACING
    else:  # "empty"
        pos = torch.zeros((3, 0))
    w = w.to(dev) if isinstance(w, torch.Tensor) else w
    return pos.to(torch.float32).contiguous().to(dev), shape, w


PAINT_CASES = ["edges", "wrap", "faces", "negative", "lattice", "random",
               "one_cell", "one", "empty", "tiny"]


@pytest.mark.parametrize("window", ["ngp", "cic", "tsc"])
@pytest.mark.parametrize("case", PAINT_CASES)
def test_paint_tiles_equal_plain_bit_for_bit(cuda, window, case):
    from randomfield_tpu_torch.ops import paint

    pos, shape, w = _paint_case(case, cuda)
    order = paint.ORDERS[window]
    shift = SPACING / 2 if PAINT_CASES.index(case) % 2 else 0.0
    s = paint.fixed_point_exponent(paint.total_abs_weight(pos, w))
    before = paint.KP_LAUNCHES
    got = paint.deposit(pos, shape, SPACING, w, order, shift, s)
    again = paint.deposit(pos, shape, SPACING, w, order, shift, s)
    assert paint.KP_LAUNCHES == before + 2
    want = paint.deposit_plain(pos, shape, SPACING, w, order, shift, s)
    assert torch.equal(got, want) and torch.equal(got, again)
    plan = paint.tile_plan_plain(pos, shape, SPACING, w, order, shift, s)
    assert torch.equal(plan.grid, want)


@pytest.mark.parametrize("window", ["ngp", "cic", "tsc"])
def test_paint_folded_total_equals_the_sum(cuda, window):
    from randomfield_tpu_torch.ops import paint

    pos, shape, w = _paint_case("negative", cuda)
    order = paint.ORDERS[window]
    s = paint.fixed_point_exponent(paint.total_abs_weight(pos, w))
    acc, total = paint._deposit(pos, shape, SPACING, w, order, 0.0, s)
    assert total.dtype == torch.int64 and total.device.type == "cuda"
    assert int(total) == int(acc.sum())
    d, mean = paint.paint(pos, shape, SPACING, w, order)
    dp, mp = paint.contrast_plain(acc, s)
    assert mean == mp and torch.equal(d, dp)


def _constraint_case(shape, m, dev, seed=3):
    from randomfield_tpu_torch.ops import constraint

    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1, (m, 3)) * np.asarray(shape) * SPACING
    pos[0] = np.asarray(shape) // 2 * SPACING  # on a grid point
    scales = rng.uniform(0, 3, m) * SPACING
    scales[-1] = 0.0
    return constraint.axis_tables(pos.astype(np.float32),
                                  scales.astype(np.float32), shape, SPACING,
                                  dev)


@pytest.mark.parametrize("shape", [(16, 16, 16), (32, 16, 30), (16, 24, 9)])
@pytest.mark.parametrize("m", [1, 8, 11, 40])
@pytest.mark.parametrize("smoothing", [0.0, 12.0])
@pytest.mark.parametrize("table_block", [0, 3])
def test_constraint_kernel_matches_plain(cuda, shape, m, smoothing,
                                         table_block, monkeypatch):
    """table_block 3: the kernels take three constraints a pass, the path
    of an M whose tables do not fit in shared memory at once."""
    from randomfield_tpu_torch.ops import constraint

    monkeypatch.setattr(constraint, "_PASS_CAP", table_block)
    tables = _constraint_case(shape, m, cuda)
    nzh = shape[2] // 2 + 1
    sig = torch.rand((shape[0], shape[1], nzh), device=cuda)
    re, im = _randn((shape[0], shape[1], nzh), cuda, 7), \
        _randn((shape[0], shape[1], nzh), cuda, 8)
    pr, pi = re.clone(), im.clone()
    before = constraint.KC_LAUNCHES
    got = constraint.measure(re, im, tables, sig, smoothing)
    want = constraint.measure_plain(pr, pi, tables, sig, smoothing)
    assert constraint.KC_LAUNCHES == before + 1
    assert torch.equal(re, pr) and torch.equal(im, pi)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-10, atol=1e-12)
    alpha = np.random.default_rng(m).normal(size=m).astype(np.float32)
    constraint.correct(re, im, tables, alpha, sig, smoothing)
    constraint.correct_plain(pr, pi, tables, alpha, sig, smoothing)
    assert torch.equal(re, pr) and torch.equal(im, pi)
    # the measurement of the corrected spectrum, without the scale
    got = constraint.measure(re, im, tables)
    want = constraint.measure_plain(pr, pi, tables)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-10, atol=1e-12)


def test_constraint_kernel_many_constraints(cuda):
    """M = 3000: more constraints than one block's shared memory holds,
    in the plan's own passes (no cap)."""
    from randomfield_tpu_torch.ops import constraint

    shape, m = (16, 16, 16), 3000
    tables = _constraint_case(shape, m, cuda)
    for correct, scale in ((False, False), (False, True), (True, True)):
        assert constraint.launch_plan(correct, scale, *shape, m)[0] < m
    nzh = shape[2] // 2 + 1
    sig = torch.rand((shape[0], shape[1], nzh), device=cuda)
    re, im = _randn((shape[0], shape[1], nzh), cuda, 7), \
        _randn((shape[0], shape[1], nzh), cuda, 8)
    pr, pi = re.clone(), im.clone()
    got = constraint.measure(re, im, tables, sig, 12.0)
    want = constraint.measure_plain(pr, pi, tables, sig, 12.0)
    assert torch.equal(re, pr) and torch.equal(im, pi)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-10, atol=1e-12)
    alpha = np.random.default_rng(m).normal(size=m).astype(np.float32)
    constraint.correct(re, im, tables, alpha, sig, 12.0)
    constraint.correct_plain(pr, pi, tables, alpha, sig, 12.0)
    assert torch.equal(re, pr) and torch.equal(im, pi)


@pytest.mark.parametrize("n", [1024, 2048])
def test_constraint_plans_fit_any_m(cuda, n):
    """Both kernels have a plan within one block's shared memory at the
    largest grids for any M: a pass's layout does not grow with M."""
    from randomfield_tpu_torch.ops import constraint

    for m in (1, 40, 64, 3000, 20000):
        for correct, scale in ((False, False), (False, True), (True, True)):
            cb, _, blocks, smem = constraint.launch_plan(correct, scale, n, n,
                                                         n, m)
            assert 1 <= cb <= m and blocks >= 1 and smem <= 232448


@pytest.mark.parametrize("nz", [32, 64, 256])
def test_lognormal_tail_matches_plain(cuda, nz):
    re = _randn((12, 8, nz // 2 + 1), cuda, 3)
    im = _randn((12, 8, nz // 2 + 1), cuda, 4)
    re[..., 0] = 0.0
    im[..., 0] = 0.0
    im[..., -1] = 0.0
    a = torch.rand(nz, device=cuda) * 0.01
    c = torch.rand(nz, device=cuda) * 0.1
    before, k4 = fft.K4L_LAUNCHES, fft.K4_LAUNCHES
    got = fft.c2r_tail_exp(re, im, nz, a, c)
    assert fft.K4L_LAUNCHES == before + 1 and fft.K4_LAUNCHES == k4
    want = fft.c2r_tail_exp_plain(re, im, nz, a, c)
    assert _rel(got, want) <= K4_TOL
    plain = fft.c2r_tail(re, im, nz, a)
    assert _rel(torch.expm1(plain - c), got) <= K4_TOL


def test_mock_makers_on_the_card_match_the_cpu(cuda):
    from randomfield_tpu_torch.models import lognormal, zeldovich

    shape = (32, 32, 32)
    g = rft.Generator(*shape, grid_spacing=SPACING, device=cuda)
    gc = rft.Generator(*shape, grid_spacing=SPACING, device="cpu")
    cons = [((64.0, 64.0, 64.0), 1.5, 24.0), ((97.3, 20.1, 300.0), -0.5, 0.0)]
    for name, args in (("generate_constrained_field", (3, cons)),
                       ("constrained_mean_field", (cons,))):
        got = getattr(g, name)(*args)
        want = getattr(gc, name)(*args)
        assert _rel(got.cpu(), want) <= RENDER_TOL
    np.testing.assert_allclose(g.measure_constraints(got, cons),
                               gc.measure_constraints(want, cons), atol=1e-5)
    data = gc.generate_delta_field(9, apply_lightcone=False)
    for name, args in (("wiener_filter", (data, 4.0)),
                       ("generate_posterior_field", (2, data, 4.0))):
        got = getattr(g, name)(*[a.to(cuda) if torch.is_tensor(a) else a
                                 for a in args])
        want = getattr(gc, name)(*args)
        assert _rel(got.cpu(), want) <= RENDER_TOL
    lg = lognormal.LognormalGenerator(*shape, SPACING, device=cuda)
    lc = lognormal.LognormalGenerator(*shape, SPACING, device="cpu")
    assert _rel(lg.generate_delta_field(4).cpu(),
                lc.generate_delta_field(4)) <= RENDER_TOL
    q = zeldovich.lagrangian_positions(shape, SPACING)  # on the card
    assert q.device.type == "cuda"
    assert torch.equal(q.cpu(), zeldovich.lagrangian_positions(
        shape, SPACING, device="cpu"))
    psi = gc.generate_displacement(6)
    pos = zeldovich.zeldovich_positions(psi, SPACING, f=0.5)
    got = zeldovich.catalog_power(pos.to(cuda), SPACING, window="tsc",
                                  interlaced=True, nbins=8)
    want = zeldovich.catalog_power(pos, SPACING, window="tsc",
                                   interlaced=True, nbins=8)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)


# ---- KM and KX: the morphology kernels -----------------------------------------

@pytest.mark.parametrize("shape,nbins", [((32, 32, 32), 24), ((16, 8, 15), 1),
                                         ((24, 16, 10), 64), ((8, 8, 9), 200)])
def test_minkowski_kernel_matches_plain(cuda, shape, nbins):
    from randomfield_tpu_torch.ops import minkowski

    u = _randn(shape, cuda, 60)
    derivs = [_randn(shape, cuda, 61 + i) for i in range(9)]
    for t in derivs[:3]:
        t[0, 0, :4] = 0.0  # |g| = 0 voxels
    edges = np.linspace(-2.5, 2.5, nbins + 1)
    before = minkowski.KM_LAUNCHES
    counts, sums = minkowski.threshold_sums(u, derivs, edges)
    assert minkowski.KM_LAUNCHES == before + 1
    again = minkowski.threshold_sums(u, derivs, edges)
    assert torch.equal(counts, again[0]) and torch.equal(sums, again[1])
    pc, ps = minkowski.threshold_sums_plain(u, derivs, edges)
    assert torch.equal(counts, pc)
    assert int(counts.sum()) == int(((u >= float(np.float32(edges[0])))).sum())
    for q in range(3):
        assert _rel(sums[q], ps[q]) <= 1e-10


# KX's shapes: axes of 1 and 2 cells, ny and nz below the (16, 64) tile,
# several x runs with a remainder, nx below a run
KX_SHAPES = [(32, 32, 32), (17, 9, 33), (1, 8, 40), (2, 2, 2), (40, 16, 70),
             (130, 20, 70), (5, 40, 130)]


def _with_nan(d):
    d = d.clone()
    d.view(-1)[d.numel() // 3] = float("nan")
    return d


@pytest.mark.parametrize("shape", KX_SHAPES)
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_extrema_peak_kernel_matches_plain(cuda, shape, sign, monkeypatch):
    from randomfield_tpu_torch.ops import extrema

    d = torch.round(_randn(shape, cuda, 70) * 3) / 3  # plateaus: ties
    edges = np.linspace(-2.0, 4.0, 9)
    # the plan's runs, runs of 64 planes (all of nx below that), and the
    # 64-bit plane offsets
    for fill, wide in ((extrema._FILL, False), (1, False), (1, True)):
        monkeypatch.setattr(extrema, "_FILL", fill)
        monkeypatch.setattr(extrema, "_WIDE", wide)
        for field in (d, _with_nan(d)):
            before = extrema.KX_LAUNCHES
            got = extrema.peak_counts(field, 0.7, edges, sign,
                                      band=(0.5, None))
            assert extrema.KX_LAUNCHES == before + 1
            want = extrema.peak_counts_plain(field, 0.7, edges, sign,
                                             band=(0.5, None))
            for g, w in zip(got, want):
                assert torch.equal(g, w)
        got = extrema.peak_counts(d, 0.7, edges, sign, band=(0.5, None))
        assert int(got[1]) > 0


@pytest.mark.parametrize("shape", [(32, 32, 32), (17, 9, 33), (2, 8, 10),
                                   (130, 20, 70), (5, 40, 130)])
def test_extrema_void_kernel_matches_plain(cuda, shape, monkeypatch):
    from randomfield_tpu_torch.ops import extrema

    g = torch.Generator(device="cpu").manual_seed(71)
    rv = (torch.randint(0, 3, shape, generator=g) * 4.0).to(cuda)
    d = torch.round(_randn(shape, cuda, 72) * 5) / 5
    for fill, wide in ((extrema._FILL, False), (1, False), (1, True)):
        monkeypatch.setattr(extrema, "_FILL", fill)
        monkeypatch.setattr(extrema, "_WIDE", wide)
        for field in (d, _with_nan(d)):
            want = extrema.void_candidates_plain(rv, field)
            assert want.size > 2 or field is not d
            # 2: the list overflows and is launched again
            for cap in (1 << 16, 2):
                monkeypatch.setattr(extrema, "_VOID_CAP", cap)
                before = extrema.KX_LAUNCHES
                got = extrema.void_candidates(rv, field)
                np.testing.assert_array_equal(got, want)
                assert extrema.KX_LAUNCHES == before + (
                    1 if cap > want.size else 2)


def test_extrema_instances_fit(cuda):
    from randomfield_tpu_torch.ops import extrema

    for voids, mask in ((False, False), (False, True), (True, False)):
        regs, blocks, threads, smem = extrema.kernel_attributes(voids, 14,
                                                                mask)
        assert regs > 0 and blocks >= 2 and threads == 256 and smem > 0


def test_morphology_methods_on_the_card_match_the_cpu(cuda):
    from randomfield_tpu_torch.ops import extrema, minkowski

    shape = (32, 32, 32)
    g = rft.Generator(*shape, grid_spacing=SPACING, device=cuda)
    gc = rft.Generator(*shape, grid_spacing=SPACING, device="cpu")
    dc = gc.generate_delta_field(3, smoothing_length=32.0,
                                 apply_lightcone=False)
    d = dc.to(cuda)
    before = (minkowski.KM_LAUNCHES, extrema.KX_LAUNCHES)
    got, want = g.calculate_minkowski(d, sigma0=0.1), gc.calculate_minkowski(
        dc, sigma0=0.1)
    np.testing.assert_array_equal(got[1], want[1])
    for k in (2, 3, 4):
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-4 * np.abs(want[k]).max())
    for name, args in (("calculate_peaks", (d, 9, -1.0, 3.0, 0.1)),
                       ("find_voids", (d, (32.0, 48.0, 64.0), -0.05))):
        got = getattr(g, name)(*args)
        want = getattr(gc, name)(dc, *args[1:])
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    got = g.calculate_peak_profile(d, 0.0, None, 6, 32.0)
    want = gc.calculate_peak_profile(dc, 0.0, None, 6, 32.0)
    assert got[2] == want[2]
    np.testing.assert_allclose(got[1], want[1], rtol=0,
                               atol=1e-5 * np.nanmax(np.abs(want[1])))
    counts = torch.zeros(shape, device=cuda)
    counts.view(-1)[torch.randint(0, counts.numel(), (400,), device=cuda)] = 1.0
    np.testing.assert_array_equal(g.calculate_knn_cdf(counts, (16.0, 32.0)),
                                  gc.calculate_knn_cdf(counts.cpu(),
                                                       (16.0, 32.0)))
    assert minkowski.KM_LAUNCHES == before[0] + 1
    assert extrema.KX_LAUNCHES >= before[1] + 3


# ---- KQ: the pair counts, and K2's amplitude against its plain version --------

def _pair_catalog(n, box, seed):
    """float32 (n, 3) positions: uniform, then a line of points 4 apart
    (pairs exactly on integer edges), points on the box's faces (0 and L,
    one image apart, and L/2 apart, round half to even) and duplicates."""
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 3)) * np.asarray(box)).astype(np.float32)
    k = min(24, n // 4)
    pos[:k] = [10.0, 12.0, 14.0]
    pos[:k, 0] += 4.0 * np.arange(k, dtype=np.float32) % box[0]
    pos[k:k + 4] = [[0.0, 5.0, 5.0], [box[0], 5.0, 5.0],
                    [box[0] / 2, 5.0, 5.0], [0.0, box[1] / 2, 0.0]]
    pos[k + 4:k + 8] = pos[k + 8:k + 12]
    return pos


def _pair_setup(n1, n2, weighted, seed=0):
    from randomfield_tpu_torch.ops import paircount as pc

    box = (96.0, 96.0, 120.0)
    r_edges = np.array([0.0, 2.0, 4.0, 8.0, 12.0, 16.0, 24.0, 32.0, 48.0])
    rng = np.random.default_rng(seed + 1)
    cats = []
    for n, s in ((n1, seed), (n2, seed + 7)):
        w = (rng.random(n) + 0.25) if weighted else np.ones(n)
        cats.append(pc.pack(torch.as_tensor(_pair_catalog(n, box, s)),
                            torch.as_tensor(w)))
    return pc, box, r_edges, cats


@pytest.mark.parametrize("mode,nmu,ells", [
    ("isotropic", 1, ()), ("wedges", 7, ()), ("ells", 1, (0, 2, 4)),
    ("ells", 1, (4,))])
@pytest.mark.parametrize("cross", [False, True])
def test_pair_kernel_equals_plain_bit_for_bit(cuda, mode, nmu, ells, cross):
    pc, box, r_edges, (a, b) = _pair_setup(1100, 700, weighted=True)
    rows1 = a.to(cuda)
    rows2 = b.to(cuda) if cross else rows1
    edges2 = torch.as_tensor((r_edges**2).astype(np.float32))
    n2 = rows2.shape[0]
    s = pc.fixed_point_exponent(rows1.shape[0], n2, 1.25, 1.25, r_edges[-1],
                                ells)
    m = pc.MODES[mode]
    before = pc.KQ_LAUNCHES, pc.KQ_SORT_LAUNCHES
    got, seen = pc.pair_sums(rows1, rows2, box, edges2, s, m, nmu, ells)
    assert pc.KQ_LAUNCHES == before[0] + 1
    assert pc.KQ_SORT_LAUNCHES == before[1] + (2 if cross else 1)
    again, _ = pc.pair_sums(rows1, rows2, box, edges2, s, m, nmu, ells)
    want, _ = pc.pair_sums_plain(rows1, rows2, box, edges2, s, m, nmu, ells)
    plan = pc._plan_of(rows1, rows2, torch.tensor(box, device=cuda),
                       edges2.to(cuda), m, nmu, len(ells))
    assert int(seen) == pc.expected_pairs(pc.cell_counts(rows1, plan),
                                          pc.cell_counts(rows2, plan),
                                          plan.cells)
    assert torch.equal(got, want) and torch.equal(got, again)
    assert int(got[0].sum()) > 0


def test_pair_kernel_raises_on_a_short_walk(cuda, monkeypatch):
    """pair_sums holds the kernel's count of pairs examined to the cell
    walk's own and raises where they differ."""
    pc, box, r_edges, (a, _) = _pair_setup(900, 700, weighted=False)
    rows = a.to(cuda)
    edges2 = torch.as_tensor((r_edges**2).astype(np.float32))
    s = pc.fixed_point_exponent(900, 900, 1.0, 1.0, r_edges[-1])
    expected = pc._expected
    monkeypatch.setattr(pc, "_expected", lambda *c: expected(*c) + 1)
    with pytest.raises(RuntimeError, match="not the walk's"):
        pc.pair_sums(rows, rows, box, edges2, s)


def _cell_case(name, dev):
    """(rows1, rows2, box, r_edges) of a cell-list case on ``dev``: a
    clustered catalog, a non-cubic box with 2 cells on an axis, one cell
    (the last edge at box / 2), a small reach whose cells the cap limits,
    and objects on the faces and outside [0, box)."""
    from randomfield_tpu_torch.ops import paircount as pc

    rng = np.random.default_rng(len(name))
    box, p2 = (200.0,) * 3, None
    if name == "clustered":
        centres = rng.random((20, 3)) * 200.0
        p1 = np.concatenate([c + 5.0 * rng.standard_normal((80, 3))
                             for c in centres])
        p2 = np.concatenate([rng.random((500, 3)) * 200.0, p1[::2]])
        r_edges = np.linspace(0.0, 30.0, 9)
    elif name == "two_cells":
        box = (96.0, 96.0, 120.0)
        p1 = rng.random((1200, 3)) * np.asarray(box)
        r_edges = np.linspace(0.0, 40.0, 9)
    elif name == "one_cell":
        p1 = rng.random((1000, 3)) * 200.0
        r_edges = np.linspace(0.0, 100.0, 11)
    elif name == "cap":
        box = (2048.0,) * 3
        p1 = rng.random((3000, 3)) * 2048.0
        p1[1500:] = p1[:1500] + rng.random((1500, 3)) * 1.5
        r_edges = np.linspace(0.0, 2.0, 5)
    else:  # faces
        p1 = rng.random((1000, 3)) * 200.0
        p1[:10] = [[0.0, 5.0, 5.0], [200.0, 5.0, 5.0], [-0.5, 9.0, 9.0],
                   [200.5, 9.0, 9.0], [-200.0, 0.0, 0.0], [399.0, 3.0, 197.0],
                   [-37.0, 450.0, -99.0], [50.0, 200.0, 80.0],
                   [20.0, 20.0, 0.0], [20.0, 20.0, 200.0]]
        p1[10:14] = p1[20:24]
        r_edges = np.linspace(0.0, 40.0, 9)
    w = rng.random(len(p1)) + 0.25
    rows1 = pc.pack(torch.as_tensor(p1), torch.as_tensor(w)).to(dev)
    rows2 = rows1 if p2 is None else pc.pack(
        torch.as_tensor(p2), torch.ones(len(p2))).to(dev)
    return rows1, rows2, box, r_edges


@pytest.mark.parametrize("name", ["clustered", "two_cells", "one_cell",
                                  "cap", "faces"])
@pytest.mark.parametrize("mode,nmu,ells", [(0, 1, ()), (1, 5, ()),
                                           (2, 1, (0, 2, 4))])
def test_pair_kernel_cell_cases(cuda, name, mode, nmu, ells):
    from randomfield_tpu_torch.ops import paircount as pc

    rows1, rows2, box, r_edges = _cell_case(name, cuda)
    edges2 = torch.as_tensor((r_edges**2).astype(np.float32))
    plan = pc._plan_of(rows1, rows2, torch.tensor(box, device=cuda),
                       edges2.to(cuda), mode, nmu, len(ells))
    if name == "two_cells":
        assert 2 in plan.cells
    if name == "one_cell":
        assert plan.cells == (1, 1, 1)
    if name == "cap":
        assert math.prod(plan.cells) <= max(rows2.shape[0], pc.MIN_CELL_CAP)
    s = pc.fixed_point_exponent(rows1.shape[0], rows2.shape[0], 1.25, 1.0,
                                r_edges[-1], ells)
    args = (rows1, rows2, box, edges2, s, mode, nmu, ells, 2)
    got, seen = pc.pair_sums(*args)
    again, _ = pc.pair_sums(*args)
    want, _ = pc.pair_sums_plain(*args)
    assert torch.equal(got, want) and torch.equal(got, again)
    assert int(seen) == pc.expected_pairs(pc.cell_counts(rows1, plan),
                                          pc.cell_counts(rows2, plan),
                                          plan.cells)
    assert int(got[0].sum()) > 0
    # the count pass puts every object in the plain version's cell
    from randomfield_tpu_torch.ops import _build

    lib = _build.library()
    for r in (rows1, rows2):
        cell, counts = pc._count(r, plan, lib, _build.current_stream(r))
        assert torch.equal(cell.long(), pc.cell_index(r, plan))
        assert torch.equal(counts, pc.cell_counts(r, plan))
    # the replay of the walk on the CPU examines the same pairs
    cpu = [r.cpu() for r in (rows1, rows2)]
    if rows2 is rows1:
        cpu[1] = cpu[0]
    walk, examined = pc.pair_sums_walk_plain(cpu[0], cpu[1], *args[2:])
    assert examined == int(seen) and torch.equal(walk, want.cpu())


def test_pair_kernel_instances_and_plans_fit(cuda):
    from randomfield_tpu_torch.ops import paircount as pc

    for mode, nmu, n_ells in ((0, 1, 0), (1, 10, 0), (2, 1, 3)):
        regs, blocks, threads, smem = pc.kernel_attributes(mode, 30, nmu,
                                                           n_ells)
        assert regs > 0 and blocks >= 1 and threads == pc.THREADS
    for name in pc.SORT_PASSES:
        regs, blocks, threads, _ = pc.kernel_attributes(name)
        assert regs > 0 and blocks >= 1
    # one histogram a block where eight do not fit
    plan = pc.launch_plan(600, 600, (96.0, 96.0, 120.0), 48.0**2, 120.0, 600,
                          pc.MODES["wedges"], 10)
    assert plan.copies == 1
    _, box, _, (a, _) = _pair_setup(600, 600, weighted=False)
    rows = a.to(cuda)
    e2 = torch.as_tensor((np.linspace(0, 48, 601) ** 2).astype(np.float32))
    s = pc.fixed_point_exponent(600, 600, 1.0, 1.0, 48.0)
    got, _ = pc.pair_sums(rows, rows, box, e2, s, 1, 10)
    want, _ = pc.pair_sums_plain(rows, rows, box, e2, s, 1, 10)
    assert torch.equal(got, want)


def test_pair_counts_on_the_card_match_the_cpu(cuda):
    from randomfield_tpu_torch.validate import paircount

    box = (96.0, 96.0, 120.0)
    pos = _pair_catalog(1500, box, 4)
    pos2 = _pair_catalog(800, box, 5)
    w = np.random.default_rng(6).random(1500) + 0.5
    edges = np.geomspace(2.0, 48.0, 10)
    for kw in (dict(), dict(nmu=5), dict(positions2=pos2)):
        got = paircount.catalog_correlation(pos, box, edges, weights=w,
                                            device=cuda, **kw)
        want = paircount.catalog_correlation(pos, box, edges, weights=w,
                                             device="cpu", **kw)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
    got = paircount.catalog_correlation_multipoles(torch.as_tensor(pos)
                                                   .to(cuda), box, edges)
    want = paircount.catalog_correlation_multipoles(pos, box, edges,
                                                    device="cpu")
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


def test_numpy_fields_run_on_the_card(cuda):
    """A numpy field, the JAX package's usual input, runs the marked and
    velocity estimators on the card: their hand transforms launch."""
    from randomfield_tpu_torch.validate import marked, velocity

    shape = (32, 32, 32)
    rng = np.random.default_rng(8)
    d = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    v = rng.standard_normal((3, *shape)).astype(np.float32)
    before = (fft.K6_LAUNCHES, fft.K4_LAUNCHES)
    out = marked.smooth_field(d, SPACING, 9.0)
    assert out.device.type == "cuda"
    assert (fft.K6_LAUNCHES, fft.K4_LAUNCHES) == (before[0] + 1,
                                                  before[1] + 1)
    for fn, k6 in ((lambda: marked.calculate_marked_power(d, SPACING,
                                                          nbins=8), 2),
                   (lambda: velocity.density_velocity_correlation(
                       d, v, SPACING, nbins=8), 4)):
        before = fft.K6_LAUNCHES
        assert np.isfinite(fn()[1]).any()
        assert fft.K6_LAUNCHES == before + k6


@pytest.mark.parametrize("shape", [(64, 32, 64), (32, 64, 30)])
@pytest.mark.parametrize("smoothing", [0.0, 8.0])
def test_k2_amplitude_bit_equal_to_plain(cuda, shape, smoothing):
    """ROADMAP F6: each step of K2's amplitude, K2, K2F and K2F's fixed
    mode equal to their plain versions bit for bit."""
    table = sampler.make_sigma_table(rft.load_default_power(), shape, SPACING,
                                     device=cuda)
    ksq = grid.ksq(shape, SPACING, torch.float32, cuda)
    got = sampler.sigma_steps(table, ksq, smoothing, 0.5 ** 0.5)
    want = sampler.sigma_steps_plain(table, ksq, smoothing, 0.5 ** 0.5)
    for k in ("lk", "t", "i0", "frac", "amp"):
        assert torch.equal(got[k], want[k]), k
    nzh = shape[2] // 2 + 1
    re, im = _randn((shape[0], shape[1], nzh), cuda, 3), _randn(
        (shape[0], shape[1], nzh), cuda, 4)
    a = sampler.scale_sigma(re.clone(), im.clone(), table, shape, SPACING,
                            smoothing, gain=0.5 ** 0.5)
    b = sampler.scale_sigma_plain(re.clone(), im.clone(), table, shape,
                                  SPACING, smoothing, gain=0.5 ** 0.5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(sampler.draw_scale(5, table, shape, SPACING, smoothing),
                       sampler.draw_scale_plain(5, table, shape, SPACING,
                                                smoothing))
    assert torch.equal(sampler.draw_fixed(5, table, shape, SPACING, smoothing),
                       sampler.draw_fixed_plain(5, table, shape, SPACING,
                                                smoothing))


# ---- KH, KD's 'deriv' and 'recon' kinds, the device models ----------------

def _poisson_case(name, dev):
    """(g, keys, kwargs) of one KH case: the halo form on a Gaussian field
    with a bin past lambda = 10 (the rejection passes), or the linear form
    with clipped, zero and lambda >= 10 cells."""
    from randomfield_tpu_torch.ops import threefry as tfry

    rng = np.random.default_rng(len(name))
    g = torch.as_tensor(rng.normal(0.0, 1.0, (32, 32, 32)),
                        dtype=torch.float32, device=dev)
    if name == "halos":
        keys = [tfry.key_from_seed(s) for s in (3, 4, 5, 6)]
        return g, keys, dict(form="lognormal", lam0=[1e-3, 0.05, 0.6, 14.0],
                             bias=[0.9, 1.3, 2.1, 0.5], sigma_g2=0.8)
    if name == "halos, all below 10":
        keys = [tfry.key_from_seed(s) for s in (3, 4)]
        return g, keys, dict(form="lognormal", lam0=[1e-3, 0.05],
                             bias=[0.9, 1.3], sigma_g2=0.8)
    if name == "linear, mostly 10 or more":
        # 99% of the cells at lambda >= 10: the rejection passes on dense marks
        return 1.0 + 0.3 * g, [tfry.key_from_seed(12)], dict(form="linear",
                                                            scale=8.0)
    g = g * 2.0
    g[0, 0, :4] = torch.tensor([-1.0, float("nan"), 1e3, 0.0])
    return g, [tfry.key_from_seed(9)], dict(form="linear", scale=6.0)


@pytest.mark.parametrize("name", ["halos", "halos, all below 10", "linear",
                                  "linear, mostly 10 or more"])
def test_poisson_kernel_equals_plain_bit_for_bit(cuda, name):
    from randomfield_tpu_torch.ops import poisson

    g, keys, kw = _poisson_case(name, cuda)
    before = poisson.KH_LAUNCHES
    got = poisson.poisson_counts(g, keys, **kw)
    torch.cuda.synchronize()
    assert poisson.KH_LAUNCHES == before + 1
    want = poisson.poisson_counts_plain(g, keys, **kw)
    assert torch.equal(got, want)
    on_cpu = poisson.poisson_counts(g.cpu(), keys, **kw)
    assert torch.equal(got.cpu(), on_cpu)


@pytest.mark.parametrize("table", [0, 3])
@pytest.mark.parametrize("name", ["halos", "linear",
                                  "linear, mostly 10 or more"])
def test_poisson_kernel_derives_keys_past_its_table(cuda, name, table):
    """A short key table: the threads derive every later subkey of both
    chains (Chain::at past the table), and the counts stay the plain
    version's bit for bit."""
    from randomfield_tpu_torch.ops import poisson

    g, keys, kw = _poisson_case(name, cuda)
    got = poisson.poisson_counts(g, keys, table=table, **kw)
    assert torch.equal(got, poisson.poisson_counts_plain(g, keys, **kw))


def test_poisson_kernel_instances_fit(cuda):
    from randomfield_tpu_torch.ops import poisson

    for mode in range(3):
        regs, blocks, threads = poisson.kernel_attributes(mode)
        assert 0 < regs <= 255 and blocks >= 1 and threads == 256


@pytest.mark.parametrize("kind,comp,pref,los", [
    ("deriv", 0, 1e-3, 2), ("deriv", 2, 1.0, 2),
    ("recon", 1, (1e-3, 1.5, 0.7, 10.0), 2),
    ("recon", 2, (2e-3, 2.0, 0.4, 15.0), 0),
])
def test_kd_new_kinds_bit_for_bit(cuda, kind, comp, pref, los):
    shape = (64, 32, 30)
    re0 = _randn((64, 32, 16), cuda, 5)
    im0 = _randn((64, 32, 16), cuda, 6)
    before = derived.KD_LAUNCHES
    a = derived.apply_kernel(re0.clone(), im0.clone(), shape, SPACING, kind,
                             comp, pref, los_axis=los)
    assert derived.KD_LAUNCHES == before + 1
    b = derived.apply_kernel_plain(re0.clone(), im0.clone(), shape, SPACING,
                                   kind, comp, pref, los_axis=los)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, bar):
    got, want = _host(got).astype(np.float64), _host(want).astype(np.float64)
    return float(np.nanmax(np.abs(got - want)) / np.nanmax(np.abs(want))) \
        <= bar


TREE_TRIPLE_BAR = 2e-3


def test_device_models_on_the_card_match_the_cpu(cuda):
    """Each model of the slice at 32^3: the CUDA output against the CPU
    output (float32 transforms of two libraries: 1e-5 of the peak; counts
    equal, or at ties of the two renders' intensities)."""
    from randomfield_tpu_torch.models import (fisher, halos, lensing,
                                              multitracer, reconstruction,
                                              spt, zeldovich)
    from randomfield_tpu_torch.ops import poisson

    shape = (32, 32, 32)
    power = rft.load_default_power()
    hg = {d: halos.HaloGenerator(*shape, SPACING, device=d, nbins_mass=3,
                                 mmin=1e12) for d in (cuda, "cpu")}
    c_dev = hg[cuda].generate_halo_counts(4).cpu()
    c_cpu = hg["cpu"].generate_halo_counts(4)
    diff = torch.nonzero(c_dev != c_cpu)
    g = {d: hg[d].lognormal.gaussian.generate_delta_field(
        4, apply_lightcone=False).cpu() for d in (cuda, "cpu")}
    keys = halos.halo_keys(4, 3)
    for b, *cell in diff.tolist():
        for d, c in ((cuda, c_dev), ("cpu", c_cpu)):
            lam = poisson.intensity(g[d], "lognormal", b,
                                    hg[d].nbar * hg[d]._cell_volume,
                                    hg[d].bias, hg[d].lognormal.sigma_g2)
            assert int(poisson.poisson_plain(keys[b], lam)[tuple(cell)]) == \
                int(c[b][tuple(cell)])
    assert len(diff) <= 1e-3 * c_dev.numel()
    rng = np.random.default_rng(1)
    delta = torch.as_tensor(0.5 * rng.standard_normal(shape),
                            dtype=torch.float32)
    assert torch.equal(zeldovich.poisson_sample(delta.to(cuda), 0.01, 8.0,
                                                seed=2).cpu(),
                       zeldovich.poisson_sample(delta, 0.01, 8.0, seed=2))
    assert _close(spt.second_order_density(delta.to(cuda), SPACING),
                  spt.second_order_density(delta, SPACING), 1e-5)
    tb = [spt.predicted_tree_bispectrum(power, shape, SPACING, nbins=4,
                                        device=d) for d in (cuda, "cpu")]
    np.testing.assert_array_equal(tb[0][1], tb[1][1])
    # a triple at a time: the sound tree reads 1.9e-5 here, the tree
    # without the Hermitian projection of its syntheses 3.1e-2
    # (scripts/tree_bispectrum_residual.py)
    rel = np.abs(tb[0][2] - tb[1][2]) / np.abs(tb[1][2])
    assert rel.max() <= TREE_TRIPLE_BAR
    rec = [reconstruction.reconstruct_field(delta.to(d), SPACING)
           for d in (cuda, "cpu")]
    assert _close(rec[0][0], rec[1][0], 1e-5) and \
        _close(rec[0][1], rec[1][1], 1e-5)
    kap = [lensing.convergence_map(delta.to(d), "Planck13", SPACING, 1.0)
           for d in (cuda, "cpu")]
    assert _close(kap[0], kap[1], 1e-5)
    shear = [lensing.convergence_to_shear(k, SPACING) for k in kap]
    assert all(_close(a, b, 1e-5) for a, b in zip(*shear))
    peb = [lensing.shear_power_eb(*s, SPACING) for s in shear]
    assert _close(peb[0][1], peb[1][1], 1e-5)
    mt = [multitracer.MultiTracerGenerator(*shape, SPACING, device=d)
          .generate_fields(5) for d in (cuda, "cpu")]
    assert all(_close(a, b, 1e-5) for a, b in zip(*mt))
    fm = []
    for d in (cuda, "cpu"):
        model, theta = fisher.make_kaiser_model(power, shape, SPACING,
                                                params=("bias", "f"),
                                                fixed={"f": 0.5}, device=d)
        fm.append(fisher.fisher_matrix_multipoles(model, theta, shape,
                                                  SPACING, nbins=8))
    assert _close(fm[0], fm[1], 1e-5)


# ---- the entry points: the command line and the examples ------------------------

def test_cli_field_equals_the_api(cuda, tmp_path):
    """``python -m randomfield_tpu_torch``'s 128^3 field on the card (its
    ``--out`` file) equals ``Generator.generate_delta_field`` bit for bit,
    and its run launched the render's kernels."""
    from randomfield_tpu_torch import __main__ as cli
    from randomfield_tpu_torch.utils import io

    sampler.K2F_LAUNCHES = fft.K3_LAUNCHES = fft.K4_LAUNCHES = 0
    rc = cli.main(["--nx", "128", "--spacing", "8", "--seed", "3",
                   "--quiet", "--out", str(tmp_path / "f_{seed}.npz")])
    assert rc == 0
    assert (sampler.K2F_LAUNCHES, fft.K3_LAUNCHES, fft.K4_LAUNCHES) == (1, 2, 1)
    field, meta = io.load_field(tmp_path / "f_3.npz")
    want = rft.Generator(128, 128, 128, grid_spacing=8.0,
                         device=cuda).generate_delta_field(3)
    assert meta["seed"] == 3
    assert np.array_equal(field, want.cpu().numpy())


@pytest.mark.parametrize("name, n", [
    ("quickstart", None), ("ensemble_covariance", None),
    ("lensing_map", None), ("variance_reduction", 64), ("mock_catalog", None),
    ("constrained_field", None), ("morphology", None), ("forecast_rsd", None),
    ("galaxy_survey", None)])
def test_examples_run_on_the_card(cuda, capsys, name, n):
    """Each example at its own size on the card (variance_reduction's zoom
    at 32^3 and 64^3: the kernels take nz/2 >= 16) returns finite
    numbers."""
    import importlib

    module = importlib.import_module(f"randomfield_tpu_torch.examples.{name}")
    out = module.main(device="cuda", n=n)
    capsys.readouterr()
    for key, value in out.items():
        value = np.asarray(value, np.float64)
        assert np.isfinite(value[~np.isnan(value)]).all(), key


# ---- the slab mesh's shard instances of KN, K2F's fixed mode and KD ----------------

SHARD_CASES = [((16, 16, 16), 2), ((64, 32, 64), 4), ((32, 16, 30), 4),
               ((32, 64, 18), 8), ((16, 16, 16), 16)]


@pytest.mark.parametrize("shape,ranks", SHARD_CASES)
@pytest.mark.parametrize("mode", list(sampler.NESTED_MODES))
def test_nested_shards_union_is_kn(cuda, shape, ranks, mode):
    table = _table(shape, cuda)
    whole = sampler.sample_nested(4, table, shape, SPACING, 8.0, mode=mode,
                                  flip=True)
    ny_loc = shape[1] // ranks
    before = sampler.KN_LAUNCHES
    parts = [sampler.sample_nested(4, table, shape, SPACING, 8.0, mode=mode,
                                   flip=True, y_off=r * ny_loc, ny_loc=ny_loc)
             for r in range(ranks)]
    assert sampler.KN_LAUNCHES == before + ranks
    assert torch.equal(torch.cat(parts, dim=2), whole)
    if mode == "bits":  # the shard's own plain version, bit for bit
        want = sampler.sample_nested_plain(4, table, shape, SPACING, 8.0,
                                           mode=mode, y_off=ny_loc,
                                           ny_loc=ny_loc)
        assert torch.equal(parts[1], want)


@pytest.mark.parametrize("shape,ranks", SHARD_CASES)
@pytest.mark.parametrize("flip", [False, True])
def test_draw_fixed_shards_union_is_k2fx(cuda, shape, ranks, flip):
    table = _table(shape, cuda)
    whole = sampler.draw_fixed(4, table, shape, SPACING, 8.0, flip)
    ny_loc = shape[1] // ranks
    before = sampler.K2FX_LAUNCHES
    parts = [sampler.draw_fixed(4, table, shape, SPACING, 8.0, flip,
                                r * ny_loc, ny_loc) for r in range(ranks)]
    assert sampler.K2FX_LAUNCHES == before + ranks
    assert torch.equal(torch.cat(parts, dim=2), whole)
    want = sampler.draw_fixed_plain(4, table, shape, SPACING, 8.0, flip,
                                    ny_loc, ny_loc)
    assert _rel(parts[1], want) <= K2_TOL


@pytest.mark.parametrize("shape,ranks", SHARD_CASES[:4])
@pytest.mark.parametrize("kind,comp", KD_CASES + [("deriv", 1)])
def test_spectral_kernel_shards_union_is_kd(cuda, shape, ranks, kind, comp):
    nzh = shape[2] // 2 + 1
    re0 = _randn((shape[0], shape[1], nzh), cuda, 25)
    im0 = _randn((shape[0], shape[1], nzh), cuda, 26)
    pref = (1.5, 0.6) if kind == "kaiser" else -0.37
    whole = derived.apply_kernel(re0.clone(), im0.clone(), shape, SPACING,
                                 kind, comp, pref, grad_diag=True)
    ny_loc = shape[1] // ranks
    before = derived.KD_LAUNCHES
    for r in range(ranks):
        rows = slice(r * ny_loc, (r + 1) * ny_loc)
        a, b = derived.apply_kernel(re0[:, rows].contiguous(),
                                    im0[:, rows].contiguous(), shape,
                                    SPACING, kind, comp, pref,
                                    grad_diag=True, y_off=r * ny_loc)
        c, d = derived.apply_kernel_plain(re0[:, rows].clone(),
                                          im0[:, rows].clone(), shape,
                                          SPACING, kind, comp, pref,
                                          grad_diag=True, y_off=r * ny_loc)
        assert torch.equal(a, whole[0][:, rows])
        assert torch.equal(b, whole[1][:, rows])
        assert torch.equal(a, c) and torch.equal(b, d)
    assert derived.KD_LAUNCHES == before + ranks


# ---- item 8b: the shard instances of KP, KH, KC and K4L ---------------------

def _thread_ranks():
    """chip_smoke.py's ThreadMesh helper: ``work(rank, mesh)`` on threads
    standing for a mesh's ranks (ring exchange and maximum between them)."""
    import pathlib
    import sys

    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke.on_thread_ranks


@pytest.mark.parametrize("window", ["ngp", "cic", "tsc"])
@pytest.mark.parametrize("ranks", [1, 2, 4])
@pytest.mark.parametrize("case", ["wrap", "faces", "negative", "random"])
def test_paint_window_equals_plain_bit_for_bit(cuda, window, ranks, case):
    """KP on each rank's x window (nx/P + 2m planes: 18 at P = 4, not a
    multiple of the 16^3 tile) equals its plain version and its plan's
    replay bit for bit, counted in KPS_LAUNCHES, and the windows folded by
    parallel/paint.py:fold_margins (threads as ranks) equal the whole-grid
    deposit."""
    from randomfield_tpu_torch.ops import paint
    from randomfield_tpu_torch.parallel import paint as ppaint

    pos, shape, w = _paint_case(case, cuda)
    pos[0] *= 64 // shape[0]  # the case's x range stretched over 64 planes
    shape = (64, shape[1], shape[2])
    order = paint.ORDERS[window]
    shift = SPACING / 2 if ranks % 2 else 0.0
    s = paint.fixed_point_exponent(paint.total_abs_weight(pos, w))
    nx_loc = shape[0] // ranks
    windows = []
    for r in range(ranks):
        rows = (r * nx_loc, nx_loc)
        before, kp = paint.KPS_LAUNCHES, paint.KP_LAUNCHES
        got = paint.deposit(pos, shape, SPACING, w, order, shift, s, rows)
        assert paint.KPS_LAUNCHES == before + 1 and paint.KP_LAUNCHES == kp
        assert tuple(got.shape) == paint.window_shape(shape, order, rows)
        want = paint.deposit_plain(pos, shape, SPACING, w, order, shift, s,
                                   rows)
        assert torch.equal(got, want)
        plan = paint.tile_plan_plain(pos, shape, SPACING, w, order, shift, s,
                                     x_rows=rows)
        assert torch.equal(plan.grid, want)
        windows.append(got)
    whole = paint.deposit(pos, shape, SPACING, w, order, shift, s)
    rows = _thread_ranks()(ranks, lambda r, m: ppaint.fold_margins(
        windows[r].clone(), order, m))
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(rows), whole)


def test_paint_sharded_one_rank_equals_paint(cuda):
    from randomfield_tpu_torch.ops import paint
    from randomfield_tpu_torch.parallel import mesh as pmesh
    from randomfield_tpu_torch.parallel import paint as ppaint

    pos, shape, w = _paint_case("random", cuda)
    mesh = pmesh.make_mesh(space=1, device=cuda)
    for window in ("ngp", "cic", "tsc"):
        d, mean = ppaint.paint_sharded(pos, shape, SPACING, mesh, w, window)
        want = paint.paint(pos, shape, SPACING, w, paint.ORDERS[window])
        assert torch.equal(d, want[0]) and mean == want[1]


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("name", ["halos", "linear",
                                  "linear, mostly 10 or more"])
def test_poisson_slabs_with_the_whole_maximum(cuda, ranks, name):
    """KH on x slabs at their global cells, the state's maximum taken over
    the ranks between the passes (threads stand for ranks): the union
    equals the whole-grid launch and each slab its plain version, bit for
    bit, counted in KHS_LAUNCHES."""
    from randomfield_tpu_torch.ops import poisson

    g, keys, kw = _poisson_case(name, cuda)
    whole = poisson.poisson_counts(g, keys, **kw)
    nx_loc = g.shape[0] // ranks
    cells = nx_loc * g.shape[1] * g.shape[2]
    before = poisson.KHS_LAUNCHES

    def slab(r, mesh, plain=False):
        part = g[r * nx_loc:(r + 1) * nx_loc].contiguous()
        fn = poisson.poisson_counts_plain if plain else poisson.poisson_counts
        out = fn(part, keys, **kw, offset=r * cells, mesh=mesh)
        torch.cuda.synchronize()
        return out

    got = torch.cat(_thread_ranks()(ranks, slab), dim=1)
    assert poisson.KHS_LAUNCHES == before + ranks
    assert torch.equal(got, whole)
    plain = torch.cat(_thread_ranks()(
        ranks, lambda r, m: slab(r, m, plain=True)), dim=1)
    assert torch.equal(plain, whole)


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("m", [1, 8, 11])
@pytest.mark.parametrize("smoothing", [0.0, 12.0])
def test_constraint_ky_blocks(cuda, ranks, m, smoothing):
    """KC on each rank's ky block: MEASURE within float64 reordering of its
    plain version, the blocks' sums of the whole grid's; CORRECT bit for
    bit, its blocks the whole grid's rows; counted in KCS_LAUNCHES."""
    from randomfield_tpu_torch.ops import constraint

    shape = (16, 32, 30)
    tables = _constraint_case(shape, m, cuda)
    nzh = shape[2] // 2 + 1
    sig = torch.rand((shape[0], shape[1], nzh), device=cuda)
    re, im = _randn((shape[0], shape[1], nzh), cuda, 7), \
        _randn((shape[0], shape[1], nzh), cuda, 8)
    alpha = np.random.default_rng(m).normal(size=m).astype(np.float32)
    wr, wi = re.clone(), im.clone()
    whole = constraint.measure(wr, wi, tables, sig, smoothing)
    constraint.correct(wr, wi, tables, alpha, sig, smoothing)
    ny_loc = shape[1] // ranks
    total = torch.zeros_like(whole)
    for r in range(ranks):
        rows = slice(r * ny_loc, (r + 1) * ny_loc)
        block = constraint.ky_block(tables, r * ny_loc, ny_loc)
        s = sig[:, rows].contiguous()
        br, bi = re[:, rows].contiguous(), im[:, rows].contiguous()
        pr, pi = br.clone(), bi.clone()
        before, kc = constraint.KCS_LAUNCHES, constraint.KC_LAUNCHES
        got = constraint.measure(br, bi, block, s, smoothing)
        want = constraint.measure_plain(pr, pi, block, s, smoothing)
        assert torch.equal(br, pr) and torch.equal(bi, pi)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-10, atol=1e-12)
        total += got
        constraint.correct(br, bi, block, alpha, s, smoothing)
        constraint.correct_plain(pr, pi, block, alpha, s, smoothing)
        assert constraint.KCS_LAUNCHES == before + 2
        assert constraint.KC_LAUNCHES == kc
        assert torch.equal(br, pr) and torch.equal(bi, pi)
        assert torch.equal(br, wr[:, rows]) and torch.equal(bi, wi[:, rows])
    np.testing.assert_allclose(total.cpu().numpy(), whole.cpu().numpy(),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("ranks", [1, 2, 4])
@pytest.mark.parametrize("nz", [32, 256])
def test_lognormal_tail_on_x_slabs(cuda, ranks, nz):
    """K4L takes an x slab as it stands: on each rank's slab it equals its
    plain version, and the slabs the whole-grid launch's rows bit for bit;
    one K4L launch a slab."""
    re = _randn((16, 8, nz // 2 + 1), cuda, 3)
    im = _randn((16, 8, nz // 2 + 1), cuda, 4)
    im[..., 0] = 0.0
    im[..., -1] = 0.0
    a = torch.rand(nz, device=cuda) * 0.01
    c = torch.rand(nz, device=cuda) * 0.1
    whole = fft.c2r_tail_exp(re, im, nz, a, c)
    nx_loc = 16 // ranks
    for r in range(ranks):
        rows = slice(r * nx_loc, (r + 1) * nx_loc)
        sr, si = re[rows].contiguous(), im[rows].contiguous()
        before = fft.K4L_LAUNCHES
        got = fft.c2r_tail_exp(sr, si, nz, a, c)
        assert fft.K4L_LAUNCHES == before + 1
        assert torch.equal(got, whole[rows])
        assert _rel(got, fft.c2r_tail_exp_plain(sr, si, nz, a, c)) <= K4_TOL


def test_mesh_mock_makers_one_rank_on_the_card(cuda):
    """The item-8b paths on a one-rank mesh on the card: the lognormal and
    constrained fields and the halo counts equal the single device's bit
    for bit (the same kernels; the exchanges are identities)."""
    from randomfield_tpu_torch.models import halos, lognormal
    from randomfield_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(space=1, device=cuda)
    shape = (32, 32, 32)
    ln = [lognormal.LognormalGenerator(*shape, SPACING, **kw)
          for kw in (dict(device=cuda), dict(mesh=mesh))]
    assert torch.equal(ln[0].generate_delta_field(3),
                       ln[1].generate_delta_field(3))
    hg = [halos.HaloGenerator(*shape, SPACING, **kw)
          for kw in (dict(device=cuda), dict(mesh=mesh))]
    assert torch.equal(hg[0].generate_halo_counts(3),
                       hg[1].generate_halo_counts(3))
    cons = [((100.0, 200.0, 300.0), 1.5, 40.0), ((30.0, 60.0, 90.0), -1.0,
                                                 20.0)]
    gs = [rft.Generator(*shape, grid_spacing=SPACING, **kw)
          for kw in (dict(device=cuda), dict(mesh=mesh))]
    assert torch.equal(gs[0].generate_constrained_field(4, cons),
                       gs[1].generate_constrained_field(4, cons))
