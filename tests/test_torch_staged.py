"""The staged variants (engine/staged.py: v5, v4 on K9, v6 on K10, the seed
batch, the Threefry staged render) vs the JAX package.

(a) K9's plain version vs the JAX sublane kernel in interpret mode (its raw
    digit order undone) and vs numpy;
(e) the v4 and v6 slices as a whole at (128, 128, 64): the JAX side composed
    from its kernels in interpret mode, called directly (its _stages_v4 /
    _stages_v6 build them compiled), on the zero bits the interpreter's PRNG
    yields; the port's stages on the same zero bits.  The JAX c2r tail kernel
    needs nz/2 = A * 128, which this grid is too small for, so both sides'
    tails are held to numpy's irfft (tests/test_torch_kernels.py holds K4 to
    that kernel);
(f) the port's public API on the CPU under RF_STAGED_PIPELINE.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import randomfield_tpu as rf  # noqa: E402
import randomfield_tpu_torch as rft  # noqa: E402
from randomfield_tpu.ops import pallas_fft as jfft  # noqa: E402
from randomfield_tpu.ops import pallas_genfft as jgf  # noqa: E402
from randomfield_tpu.ops import pallas_sampler as jps  # noqa: E402
from randomfield_tpu_torch.engine import staged  # noqa: E402
from randomfield_tpu_torch.ops import fft, genfft, sampler, transform  # noqa: E402
from randomfield_tpu_torch.parallel import mesh as pmesh  # noqa: E402

SPACING = 16.0
# (a): the bar of tests/test_pallas_fft.py:test_sublane_matches_numpy
K9_TOL = 3e-6
# (e): the same spectrum through float32 transforms of two libraries
SLICE_TOL = 1e-5
# (f): v4 vs the default render, the same butterflies in another layout
V4_TOL = 1e-6
# (f): the JAX CPU path scales by its per-mode sigma grid, the port by the
# uniform table (tests/test_torch_generator.py's public bar)
PUBLIC = 1e-3
SLICE_SHAPE = (128, 128, 64)


def _max_rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---- (a) K9 --------------------------------------------------------------------------

@pytest.mark.parametrize("n,groups,cols", [(128, 2, 256), (256, 1, 128),
                                           (512, 3, 128)])
def test_ifft_rotate_plain_matches_pallas_sublane(n, groups, cols):
    rng = np.random.RandomState(7)
    x = (rng.normal(size=(groups * n, cols))
         + 1j * rng.normal(size=(groups * n, cols))).astype(np.complex64)
    gre, gim = jfft.ifft_sublane_pallas_reim(
        jnp.asarray(x.real), jnp.asarray(x.imag), n, interpret=True)
    want = (np.asarray(gre) + 1j * np.asarray(gim))[:, jfft.digit_perm(n)]
    re, im = fft.ifft_rotate(torch.as_tensor(x.real.copy()),
                             torch.as_tensor(x.imag.copy()), groups, n, cols)
    got = re.numpy() + 1j * im.numpy()
    assert got.shape == want.shape == (groups * cols, n)
    assert _max_rel(got, want) <= K9_TOL
    ref = np.stack([np.fft.ifft(x[g * n:(g + 1) * n, col], norm="forward")
                    for g in range(groups) for col in range(cols)])
    assert _max_rel(got, ref) <= K9_TOL


@pytest.mark.parametrize("groups,n,cols", [(1, 16, 40), (3, 32, 5), (2, 48, 7)])
def test_ifft_rotate_is_ifft_axis_rotated(groups, n, cols):
    rng = np.random.RandomState(3)
    re0 = torch.as_tensor(rng.normal(size=(groups * n, cols)).astype(np.float32))
    im0 = torch.as_tensor(rng.normal(size=(groups * n, cols)).astype(np.float32))
    keep = re0.clone()
    a, b = fft.ifft_rotate(re0, im0, groups, n, cols)
    assert torch.equal(re0, keep), "ifft_rotate must leave its input alone"
    c, d = fft.ifft_axis(re0.clone(), im0.clone(), groups, n, cols)
    assert torch.equal(a.view(groups, cols, n), c.view(groups, n, cols).transpose(1, 2))
    assert torch.equal(b.view(groups, cols, n), d.view(groups, n, cols).transpose(1, 2))
    with pytest.raises(ValueError, match="lattice"):
        fft.ifft_rotate(re0, im0, groups, n, cols + 1)
    with pytest.raises(ValueError, match="float32"):
        fft.ifft_rotate(re0.double(), im0.double(), groups, n, cols)
    with pytest.raises(ValueError, match="contiguous"):
        fft.ifft_rotate(re0.t(), im0.t(), groups, n, cols)


# ---- (e) the slices as a whole -----------------------------------------------------

@pytest.fixture(scope="module")
def jax_gen():
    return rf.Generator(*SLICE_SHAPE, grid_spacing=SPACING, sampler="pallas")


@pytest.fixture(scope="module")
def state(jax_gen):
    lk0, dlk, stab = jax_gen._pallas_table
    return sampler.load_reference_state(
        stab, lk0, dlk, jax_gen.state.lightcone_weights, jax_gen.power.k,
        jax_gen.power.Pk)


def _numpy_tail(re, im, nz, weights):
    c = np.asarray(re).astype(np.float64) + 1j * np.asarray(im)
    return np.fft.irfft(c, n=nz, axis=-1, norm="forward") * weights


def _port_tail_stages(variant, state, smoothing):
    """The port's stages after the sampling ones: K1, which fixes the planes
    itself (v4), or plane_spectra and K10 (v6)."""
    stages = staged.variant_stages(variant, 7, state.table, SLICE_SHAPE, SPACING,
                                   state.lightcone_weights, smoothing)
    return list(stages.values())[2 if variant == "v6" else 1:]


@pytest.mark.parametrize("smoothing", [0.0, 32.0])
def test_v4_slice_matches_jax_kernels_composed(jax_gen, state, smoothing):
    nx, ny, nz = SLICE_SHAPE
    nzh = nz // 2 + 1
    weights = np.asarray(jax_gen.state.lightcone_weights, np.float64)
    # JAX: zero-bit K1 ('xzy', symmetrized) -> K9 x -> K9 y -> the take and
    # transpose of _stages_v4 -> natural (nx, ny, nzh) -> c2r
    jre, jim = jps.sample_spectrum_pallas_reim(
        7, jax_gen._pallas_table, SLICE_SHAPE, SPACING, smoothing,
        interpret=True)
    gre, gim = jfft.ifft_sublane_pallas_reim(
        jre.reshape(nx, nzh * ny), jim.reshape(nx, nzh * ny), nx, interpret=True)
    gre, gim = jfft.ifft_sublane_pallas_reim(gre, gim, ny, interpret=True)
    px, py = jfft.digit_perm(nx), jfft.digit_perm(ny)

    def close(g):
        g = jnp.take(g.reshape(nzh, nx, ny), px, axis=1).transpose(1, 0, 2)
        return jnp.take(g, py, axis=2).transpose(0, 2, 1)  # (nx, ny, nzh)

    want = _numpy_tail(close(gre), close(gim), nz, weights)

    zeros = torch.zeros((nx, ny, nzh), dtype=torch.int64)
    out = sampler.sample_modes_plain(zeros, zeros.clone(), state.table,
                                     SLICE_SHAPE, SPACING, smoothing)
    out = transform.symmetrize_with_shape_reim(*out, nz)
    for stage in _port_tail_stages("v4", state, smoothing):
        out = stage(out)
    assert tuple(out.shape) == SLICE_SHAPE and np.abs(want).max() > 0
    assert _max_rel(out.numpy(), want) <= SLICE_TOL


@pytest.mark.parametrize("smoothing", [0.0, 32.0])
def test_v6_slice_matches_jax_kernels_composed(jax_gen, state, smoothing):
    nx, ny, nz = SLICE_SHAPE
    nzh = nz // 2 + 1
    weights = np.asarray(jax_gen.state.lightcone_weights, np.float64)
    # JAX: zero-bit K10 -> the transpose, y transform and close of _stages_v6
    jre, jim = jgf.sample_fftx_pallas(7, jax_gen._pallas_table, SLICE_SHAPE,
                                      SPACING, smoothing, interpret=True)
    tre = jnp.transpose(jre.reshape(nzh, ny, nx), (0, 2, 1))
    tim = jnp.transpose(jim.reshape(nzh, ny, nx), (0, 2, 1))
    gre, gim = jfft.ifft_minor_pallas_reim(tre, tim, interpret=True,
                                           reorder=False)

    def close(g):
        g5 = g.reshape(nzh, nx // 128, 128, ny // 128, 128)
        return g5.transpose(2, 1, 4, 3, 0).reshape(nx, ny, nzh)

    want = _numpy_tail(close(gre), close(gim), nz, weights)

    zeros = torch.zeros((nzh, ny, nx), dtype=torch.int64)
    planes = genfft.plane_spectra(7, state.table, SLICE_SHAPE, SPACING, smoothing)
    out = genfft.sample_fftx_plain(zeros, zeros.clone(), *planes, state.table,
                                   SLICE_SHAPE, SPACING, smoothing)
    for stage in _port_tail_stages("v6", state, smoothing):
        out = stage(out)
    assert tuple(out.shape) == SLICE_SHAPE and np.abs(want).max() > 0
    assert _max_rel(out.numpy(), want) <= SLICE_TOL


# ---- (f) the public API ------------------------------------------------------------

@pytest.fixture(scope="module")
def gen32():
    return rft.Generator(32, 32, 32, grid_spacing=SPACING, device="cpu",
                         sampler="pallas")


@pytest.mark.parametrize("shape,smoothing,lightcone", [
    ((32, 32, 32), 0.0, True), ((64, 32, 32), 20.0, False),
    ((24, 20, 18), 0.0, True),  # a grid the kernels refuse: the default
])
def test_v4_render_equals_the_default_render(monkeypatch, shape, smoothing,
                                             lightcone):
    g = rft.Generator(*shape, grid_spacing=SPACING, device="cpu",
                      sampler="pallas")
    monkeypatch.delenv(staged.PIPELINE_ENV, raising=False)
    want = g.generate_delta_field(3, smoothing, lightcone)
    monkeypatch.setenv(staged.PIPELINE_ENV, "v4")
    assert staged.selected_variant(shape) == ("v4" if staged.can_v4(shape)
                                              else "v5")
    got = g.generate_delta_field(3, smoothing, lightcone)
    assert float((got - want).abs().max()) <= V4_TOL * float(want.abs().max())
    assert got.dtype == torch.float32 and tuple(got.shape) == shape


def test_v6_render_is_its_own_deterministic_family(monkeypatch, gen32):
    monkeypatch.delenv(staged.PIPELINE_ENV, raising=False)
    v5 = gen32.generate_delta_field(5)
    monkeypatch.setenv(staged.PIPELINE_ENV, "v6")
    a = gen32.generate_delta_field(5)
    assert torch.equal(gen32.generate_delta_field(5), a)
    assert not torch.equal(gen32.generate_delta_field(6), a)
    assert float((a - v5).abs().max()) > 0.1 * float(v5.abs().max())
    assert bool(torch.isfinite(a).all()) and tuple(a.shape) == (32, 32, 32)
    # the render is K10, the y transform and the c2r of its spectrum
    re, im = genfft.sample_fftx(5, gen32.state.table, gen32.shape, SPACING)
    spec = torch.fft.ifft(torch.complex(re, im).view(17, 32, 32), dim=1,
                          norm="forward").permute(2, 1, 0)
    want = torch.fft.irfft(spec, n=32, dim=-1, norm="forward") \
        * gen32.state.lightcone_weights
    assert float((a - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_v6_variance_tracks_the_prediction(monkeypatch, gen32):
    monkeypatch.setenv(staged.PIPELINE_ENV, "v6")
    fields = gen32.generate_delta_fields(range(4), apply_lightcone=False)
    var = float(fields.to(torch.float64).var(dim=(1, 2, 3)).mean())
    # the bar a single 1024^3 seed is held to on the card; four 32^3 seeds
    assert abs(var / gen32.predicted_variance() - 1.0) <= 0.10


@pytest.mark.parametrize("value", ["", "v3", "v5", "v7", "V4", "fused"])
def test_unknown_switch_values_select_the_default(monkeypatch, gen32, value):
    monkeypatch.delenv(staged.PIPELINE_ENV, raising=False)
    want = gen32.generate_delta_field(2)
    monkeypatch.setenv(staged.PIPELINE_ENV, value)
    assert staged.selected_variant(gen32.shape) == "v5"
    assert torch.equal(gen32.generate_delta_field(2), want)


@pytest.mark.parametrize("shape,v5,v6", [
    ((1024, 1024, 1024), True, True), ((16, 2048, 32), True, True),
    ((128, 128, 64), True, True),
    ((48, 32, 32), False, False),    # nx not a power of two
    ((32, 40, 32), False, False),    # ny not a power of two
    ((32, 32, 31), False, False),    # odd nz
    ((32, 32, 24), False, False),    # nz/2 not a power of two
    ((8, 32, 32), False, False),     # below the kernels' shortest line
    ((32, 4096, 32), False, False),  # above their longest
])
def test_can_v4_v5_v6_are_the_kernels_rules(monkeypatch, shape, v5, v6):
    assert staged.can_v5(shape) is v5
    assert staged.can_v4(shape) is v5
    assert staged.can_v6(shape) is v6
    assert genfft.can_genfft(shape) or not v6
    for value in ("v4", "v6"):
        monkeypatch.setenv(staged.PIPELINE_ENV, value)
        assert staged.selected_variant(shape) == (value if v5 else "v5")


@pytest.mark.parametrize("variant", ["v5", "v4", "v6"])
def test_batch_rows_equal_single_renders(monkeypatch, gen32, variant):
    monkeypatch.setenv(staged.PIPELINE_ENV, variant)
    seeds = [4, 9, 2**31 + 4]
    batch = gen32.generate_delta_fields(seeds, smoothing_length=6.0)
    assert tuple(batch.shape) == (3, 32, 32, 32) and batch.is_contiguous()
    for row, seed in zip(batch, seeds):
        assert torch.equal(row, gen32.generate_delta_field(seed, 6.0))
    assert torch.equal(batch[0], batch[2])  # seeds are masked to 31 bits
    assert staged.can_batch_staged(gen32.shape, 10**6, "cpu")
    direct = staged.render_v3_batch(
        seeds[:2], gen32.state.table, gen32.shape, SPACING,
        gen32.state.lightcone_weights, 6.0)
    assert torch.equal(direct, batch[:2])
    with pytest.raises(ValueError, match="out must be"):
        staged.render_v3(4, gen32.state.table, gen32.shape, SPACING,
                         gen32.state.lightcone_weights,
                         out=torch.empty((32, 32, 31)))
    with pytest.raises(ValueError, match="unknown staged variant"):
        staged.variant_stages("v3", 4, gen32.state.table, gen32.shape, SPACING,
                              gen32.state.lightcone_weights)


@pytest.mark.parametrize("smoothing,lightcone", [(0.0, True), (8.0, False)])
def test_staged_threefry_equals_auto_and_jax(smoothing, lightcone):
    shape = (32, 32, 32)
    auto = rft.Generator(*shape, grid_spacing=SPACING, device="cpu")
    stg = rft.Generator(*shape, grid_spacing=SPACING, device="cpu",
                        pipeline="staged")
    assert stg.pipeline == "staged" and auto.pipeline == "auto"
    got = stg.generate_delta_field(5, smoothing, lightcone)
    assert torch.equal(got, auto.generate_delta_field(5, smoothing, lightcone))
    batch = stg.generate_delta_fields([5, 6], smoothing, lightcone)
    assert torch.equal(batch[0], got)
    want = np.asarray(rf.Generator(*shape, grid_spacing=SPACING).generate_delta_field(
        5, smoothing_length=smoothing, apply_lightcone=lightcone))
    assert _max_rel(got.numpy(), want) <= PUBLIC


@pytest.mark.parametrize("name", ["threefry", "pallas"])
def test_staged_with_a_mesh_raises(name):
    with pytest.raises(ValueError, match="incompatible with mesh"):
        rft.Generator(16, 16, 16, grid_spacing=SPACING, sampler=name,
                      pipeline="staged",
                      mesh=pmesh.make_mesh(device="cpu"))
