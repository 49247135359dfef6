"""K2 fused with its draws (``ops/sampler.py:draw_scale``) on the CPU.

Torch only: the CPU path runs the plain version, which must be, bit for bit,
the chain a render ran before the fused kernel existed (canonical unit draws
-> Hermitian fix -> ``scale_sigma_plain``).  That chain is held to the JAX
package at the same seed by tests/test_torch_threefry.py and
tests/test_torch_generator.py.  The kernel itself is held to this plain
version on the card (tests/test_torch_cuda.py, ``gpu``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import randomfield_tpu_torch as rft  # noqa: E402
from randomfield_tpu_torch.ops import grid, sample, sampler  # noqa: E402
from randomfield_tpu_torch.ops import threefry, transform  # noqa: E402
from randomfield_tpu_torch.parallel import render  # noqa: E402

SPACING = 8.0
SEED = 11
GAIN = float(np.float32(0.5 ** 0.5))


def _table(shape):
    return sampler.make_sigma_table(rft.load_default_power(), shape, SPACING)


def _chain(seed, table, shape, smoothing):
    """The render's draw stage before the fused kernel."""
    re, im = sample.unit_draws_reim(threefry.key_from_seed(seed), shape)
    transform.symmetrize_with_shape_reim(re, im, shape[2])
    sampler.scale_sigma_plain(re, im, table, shape, SPACING, smoothing,
                              gain=GAIN)
    return re, im


@pytest.mark.parametrize("shape", [(8, 8, 8), (12, 6, 10), (32, 16, 9),
                                   (16, 16, 16)])
@pytest.mark.parametrize("smoothing", [0.0, 20.0])
def test_plain_equals_the_chain(shape, smoothing):
    table = _table(shape)
    re, im = _chain(SEED, table, shape, smoothing)
    before = sampler.K2F_LAUNCHES
    got = sampler.draw_scale(SEED, table, shape, SPACING, smoothing)
    assert sampler.K2F_LAUNCHES == before  # the CPU path launches nothing
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, shape[0], shape[1], shape[2] // 2 + 1)
    assert torch.equal(got[0], re) and torch.equal(got[1], im)
    assert torch.equal(sampler.draw_scale_plain(SEED, table, shape, SPACING,
                                                smoothing), got)


@pytest.mark.parametrize("shape,smoothing", [((16, 16, 16), 0.0),
                                             ((12, 8, 10), 20.0),
                                             ((32, 16, 9), 20.0)])
@pytest.mark.parametrize("ranks", [2, 4])
def test_shards_union_is_the_whole_grid(shape, smoothing, ranks):
    table = _table(shape)
    whole = sampler.draw_scale(SEED, table, shape, SPACING, smoothing)
    ny_loc = shape[1] // ranks
    before = sampler.K7_LAUNCHES
    parts = [sampler.draw_scale_shard(SEED, table, shape, SPACING, smoothing,
                                      r * ny_loc, ny_loc)
             for r in range(ranks)]
    assert sampler.K7_LAUNCHES == before
    assert torch.equal(torch.cat(parts, dim=2), whole)


@pytest.mark.parametrize("unit", [False, True])
def test_blocks_are_slices_of_the_whole_grid(unit):
    shape = (16, 12, 10)
    table = _table(shape)
    whole = sampler.draw_scale(SEED, table, shape, SPACING, 20.0, unit=unit)
    for x_off, y_off, nx_loc, ny_loc in ((4, 3, 8, 6), (0, 7, 16, 5),
                                         (15, 0, 1, 12)):
        got = sampler.draw_scale(SEED, table, shape, SPACING, 20.0, x_off,
                                 y_off, nx_loc, ny_loc, unit=unit)
        want = whole[:, x_off:x_off + nx_loc, y_off:y_off + ny_loc]
        assert torch.equal(got, want), (x_off, y_off)


class _NoExchangeMesh:
    """The parts of a slab mesh the threefry render may use: its rows and
    device.  Any collective fails."""

    def __init__(self, rank, size):
        self.rank, self.size, self.device = rank, size, torch.device("cpu")

    def rows(self, n):
        return self.rank * (n // self.size), n // self.size

    def all_gather(self, *args, **kwargs):
        raise AssertionError("the threefry spectrum exchanged data")

    all_to_all = all_reduce_sum = all_gather


def test_threefry_mesh_spectrum_needs_no_exchange():
    shape, ranks = (16, 16, 12), 4
    table = _table(shape)
    parts = [render.threefry_spectrum(SEED, table, shape, SPACING, 5.0,
                                      _NoExchangeMesh(r, ranks))
             for r in range(ranks)]
    got = torch.stack([torch.cat([p[i] for p in parts], dim=1)
                       for i in (0, 1)])
    assert torch.equal(got, sampler.draw_scale(SEED, table, shape, SPACING,
                                               5.0))


@pytest.mark.parametrize("shape", [(8, 8, 8), (12, 6, 10), (16, 12, 7)])
def test_unit_mode_equals_unit_draws(shape):
    table = _table(shape)
    re, im = sample.unit_draws_reim(threefry.key_from_seed(SEED), shape)
    got = sampler.draw_scale(SEED, table, shape, SPACING, unit=True)
    assert torch.equal(got[0], re) and torch.equal(got[1], im)


@pytest.mark.parametrize("shape", [(8, 8, 8), (48, 6, 9)])
def test_bits_are_the_canonical_counters(shape):
    # the counter of ops/sample.py's docstring, spelled out afresh: chunk
    # x // cx, flat index ((c cx + x mod cx) nzh + kz) ny + y
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    cx = nx // sample.canonical_chunks(nx)
    key = threefry.key_from_seed(SEED)
    c, x, y, z = np.meshgrid(np.arange(2), np.arange(nx), np.arange(ny),
                             np.arange(nzh), indexing="ij")
    idx = torch.as_tensor(((c * cx + x % cx) * nzh + z) * ny + y)
    want = torch.empty(idx.shape, dtype=torch.int64)
    for i in range(nx // cx):
        rows = slice(i * cx, (i + 1) * cx)
        want[:, rows] = threefry.bits_at(threefry.fold_in(key, i),
                                         idx[:, rows])
    got = sampler.draw_bits(SEED, _table(shape), shape)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    unit = sampler.draw_scale(SEED, _table(shape), shape, SPACING, unit=True)
    assert torch.equal(unit, threefry._normal_from_bits(want))


def test_spectrum_is_hermitian_on_its_planes():
    shape = (12, 10, 8)
    got = sampler.draw_scale(SEED, _table(shape), shape, SPACING, 20.0)
    self_conj, _ = grid.hermitian_plane_masks(*shape[:2])
    for p in grid.self_conjugate_kz_planes(shape[2]):
        re, im = got[0, ..., p], got[1, ..., p]
        assert torch.equal(re, grid.conjugate_plane(re))
        assert torch.equal(im, -grid.conjugate_plane(im))
        assert not im[torch.as_tensor(self_conj)].any()


def test_generate_noise_is_the_unit_mode():
    g = rft.Generator(16, 8, 12, grid_spacing=SPACING, device="cpu")
    noise = g.generate_noise(SEED)
    assert noise.dtype == torch.float32 and tuple(noise.shape) == (2, 16, 8, 7)
    assert torch.equal(noise, sampler.draw_scale(SEED, g.state.table, g.shape,
                                                 SPACING, unit=True))
    assert torch.equal(g.generate_from_noise(noise, 6.0),
                       g.generate_delta_field(SEED, 6.0))


def test_wrappers_raise_on_blocks_outside_the_grid():
    shape = (8, 8, 8)
    table = _table(shape)
    for block in ((0, 0, 9, None), (4, 0, 5, None), (0, 6, None, 3),
                  (-1, 0, None, None), (0, 0, 0, None)):
        with pytest.raises(ValueError, match="outside the grid"):
            sampler.draw_scale(SEED, table, shape, SPACING, 0.0, block[0],
                               block[1], block[2], block[3])
    with pytest.raises(ValueError, match="outside the grid"):
        sampler.draw_scale_shard(SEED, table, shape, SPACING, 0.0, 6, 4)


def test_draw_normals_on_the_cpu_are_the_plain_normals():
    # the check entry of the fused kernel's jax_normal runs its plain
    # version on CPU tensors, launching nothing
    bits = torch.arange(0, 2**32, 2**20 + 7, dtype=torch.int64)
    before = sampler.K2F_LAUNCHES
    got = sampler.draw_normals(bits)
    assert sampler.K2F_LAUNCHES == before
    assert got.dtype == torch.float32 and got.shape == bits.shape
    assert torch.equal(got, threefry._normal_from_bits(bits))
    with pytest.raises(ValueError, match="int64"):
        sampler.draw_normals(bits.to(torch.int32))
