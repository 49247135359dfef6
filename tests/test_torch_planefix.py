"""The Hermitian plane fix drawn in the thread (K1, K8, K5) on the CPU.

K1 and K8 (``csrc/sample_modes.cu``) and K5 (``csrc/sample_power_bins.cu``)
make the kz = 0 and Nyquist planes Hermitian as they draw them: a mode that
is not canonical draws its partner's counter, a self-conjugate mode keeps
re * sqrt(2).  Held here:

* the selection (``csrc/hermitian.cuh``, mirrored by
  ``sampler.plane_partner``) against ``grid.hermitian_plane_masks``;
* host mirrors of the two kernels' walks (which thread draws which mode at
  which counter, K5's carried bin, runs and weights) against the plain
  versions;
* the fused plain K1 against ``symmetrize_with_shape_reim`` of the raw
  draws, bit for bit, on the whole grid and on ky shards;
* the fused plain K5 against binning K1's fused spectrum, and
  ``sample_power_batch`` rows against single ``sample_power`` calls, bit
  for bit.

Tolerances: exact, except K5's float64 sums, which the mirror adds in the
kernel's order and the plain version by ``index_add_`` (1e-12 relative),
and the sums against binning K1's spectrum (float32 |c|^2 either way, the
bar of tests/test_torch_sampler_pallas.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import randomfield_tpu_torch as rft  # noqa: E402
from randomfield_tpu_torch.ops import grid, modestream, sampler  # noqa: E402
from randomfield_tpu_torch.ops import transform  # noqa: E402
from randomfield_tpu_torch.validate import stats  # noqa: E402

SPACING = 8.0
NBINS = 7
# even and odd nz, odd nx and ny, one x plane
SHAPES = [(16, 16, 16), (8, 12, 10), (16, 16, 15), (7, 5, 9), (1, 4, 6)]
MIRROR_RTOL = 1e-12
SUM_RTOL = 3e-5


def _table(shape):
    return sampler.make_sigma_table(rft.load_default_power(), shape, SPACING)


# ---- the selection -------------------------------------------------------------

@pytest.mark.parametrize("nx,ny", [(8, 8), (6, 10), (7, 5), (5, 8), (1, 4),
                                   (16, 3)])
def test_plane_partner_is_the_hermitian_plane_masks(nx, ny):
    x = torch.arange(nx)[:, None]
    y = torch.arange(ny)[None, :]
    px, py, moved, self_conj = sampler.plane_partner(x, y, nx, ny)
    want_self, want_canonical = grid.hermitian_plane_masks(nx, ny)
    np.testing.assert_array_equal(self_conj.numpy(), want_self)
    np.testing.assert_array_equal(moved.numpy(), ~want_canonical)
    # the partner is conjugate_plane's map, and a pair has one mover
    flat = (x * ny + y).expand(nx, ny).to(torch.float64)
    np.testing.assert_array_equal((px * ny + py).numpy(),
                                  grid.conjugate_plane(flat).numpy())
    partner_moved = moved[px, py]
    assert torch.equal(moved ^ partner_moved, ~self_conj)


# ---- K1's walk ------------------------------------------------------------------

def _k1_walk(shape, y_off, ny_loc, blocks=None):
    """A host mirror of csrc/sample_modes.cu's index walk: for every mode of
    the (nx, ny_loc, nzh) output, the counter it hashes, whether im is
    negated and whether it is self-conjugate, and how often it is written
    (twice in the rows x = 0 and nx/2, which pair with themselves)."""
    warps_per_block, pairs_per_warp = 8, 32
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    top = nzh - 1 if nz % 2 == 0 else 0
    n_pairs = (nx // 2 + 1) * ny_loc
    groups = -(-n_pairs // pairs_per_warp)
    if blocks is None:
        blocks = min(-(-groups // warps_per_block), 65535)
    counter = np.full((nx, ny_loc, nzh), -1, np.int64)
    negated = np.zeros((nx, ny_loc, nzh), bool)
    selfc = np.zeros((nx, ny_loc, nzh), bool)
    writes = np.zeros((nx, ny_loc, nzh), np.int64)

    def draw(q, z):
        xp, yl = divmod(q, ny_loc)
        y = yl + y_off
        x = (xp, 0 if xp == 0 else nx - xp)
        py = 0 if y == 0 else ny - y
        fixed = z in (0, top)
        for r in range(2):
            px = x[1 - r]
            nc = x[r] > px or (x[r] == px and y > py)
            sc = x[r] == px and y == py
            partner = fixed and nc
            row = (px * ny + py) if partner else (x[r] * ny + y)
            counter[x[r], yl, z] = row * nzh + z
            negated[x[r], yl, z] = partner
            selfc[x[r], yl, z] = fixed and sc
            writes[x[r], yl, z] += 1

    bulk = nzh & ~31
    stride = blocks * warps_per_block * pairs_per_warp
    for warp in range(blocks * warps_per_block):
        for g in range(warp * pairs_per_warp, n_pairs, stride):
            end = min(g + pairs_per_warp, n_pairs)
            for q in range(g, end):
                for lane in range(32):
                    for z in range(lane, bulk, 32):
                        draw(q, z)
            if bulk < nzh:
                for lane in range(32):
                    if g + lane < end:
                        for z in range(bulk, nzh):
                            draw(g + lane, z)
    return counter, negated, selfc, writes


@pytest.mark.parametrize("shape,y_off,ny_loc,blocks", [
    ((16, 16, 16), 0, 16, None), ((8, 12, 10), 0, 12, None),
    ((7, 5, 9), 0, 5, None),
    ((4, 8, 64), 0, 8, None),      # nzh = 33: one bulk chunk and a tail
    ((6, 40, 62), 0, 40, 1),       # nzh = 32: bulk only; warps stride
    ((16, 64, 32), 16, 16, None),  # a shard
    ((8, 16, 15), 12, 4, 1),       # a shard, odd nz
])
def test_k1_walk_draws_every_mode_at_its_counter(shape, y_off, ny_loc, blocks):
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    counter, negated, selfc, writes = _k1_walk(shape, y_off, ny_loc, blocks)
    xs = np.arange(nx)[:, None, None]
    ys = np.arange(y_off, y_off + ny_loc)[None, :, None]
    zs = np.arange(nzh)[None, None, :]
    own = (xs * ny + ys) * nzh + zs
    single = (xs == 0) | (2 * xs == nx)
    np.testing.assert_array_equal(writes, np.where(single, 2, 1) + 0 * own)
    px, py, moved, self_conj = (
        t.numpy() for t in sampler.plane_partner(
            torch.arange(nx)[:, None],
            torch.arange(y_off, y_off + ny_loc)[None, :], nx, ny))
    want_counter = own.copy()
    want_neg = np.zeros_like(negated)
    want_self = np.zeros_like(selfc)
    for p in grid.self_conjugate_kz_planes(nz):
        want_counter[..., p] = np.where(moved, (px * ny + py) * nzh + p,
                                        own[..., p])
        want_neg[..., p] = moved
        want_self[..., p] = self_conj
    np.testing.assert_array_equal(counter, want_counter)
    np.testing.assert_array_equal(negated, want_neg)
    np.testing.assert_array_equal(selfc, want_self)


# ---- the fused K1, plain ----------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES + [(32, 32, 32)])
@pytest.mark.parametrize("smoothing", [0.0, 3.0])
def test_fused_k1_plain_is_the_raw_draws_symmetrized(shape, smoothing):
    table = _table(shape)
    re, im = sampler.seeded_modes_plain(6, table, shape, SPACING, smoothing)
    re, im = transform.symmetrize_with_shape_reim(re, im, shape[2])
    got = sampler.seeded_spectrum_plain(6, table, shape, SPACING, smoothing)
    assert torch.equal(got[0], re) and torch.equal(got[1], im)
    # and the CPU path of K1 is that function
    k1 = sampler.sample_modes(6, table, shape, SPACING, smoothing)
    assert torch.equal(k1[0], re) and torch.equal(k1[1], im)


@pytest.mark.parametrize("shape,ranks", [((16, 16, 16), 2), ((16, 16, 15), 4),
                                         ((8, 12, 10), 3), ((7, 4, 9), 4)])
def test_fused_k1_plain_shards_are_whole_grid_rows(shape, ranks):
    table = _table(shape)
    whole = sampler.seeded_spectrum_plain(9, table, shape, SPACING, 2.0)
    ny_loc = shape[1] // ranks
    for r in range(ranks):
        rows = slice(r * ny_loc, (r + 1) * ny_loc)
        got = sampler.sample_shard(9, table, shape, SPACING, 2.0, r * ny_loc,
                                   ny_loc)
        assert torch.equal(got[0], whole[0][:, rows])
        assert torch.equal(got[1], whole[1][:, rows])


# ---- K5's walk -------------------------------------------------------------------

def _k5_mirror(seed, table, shape, smoothing, edges):
    """A host mirror of csrc/sample_power_bins.cu's sums for one seed: each
    thread's x-row pair and ky row walked along kz with the bin carried from
    the row's start, interior runs flushed when the bin changes (weight 2,
    the pair's two rows summed), the plane modes at weight 1 with K1's fixed
    values; the per-mode float32 values from the plain pieces, every sum in
    float64 in the kernel's order within a row."""
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    nbins = len(edges) - 1
    c = sampler._constants(table, shape, SPACING)
    _, _, amp = sampler._mode_amplitude(table, c, shape, 0, nx, smoothing,
                                        always_filter=False)
    b1, b2 = modestream.mode_bits(modestream.mode_key(seed), shape)
    u1, _ = sampler._uniforms(b1, b2)
    vol = float(sampler._volume32(shape, SPACING))
    pv = (amp * amp * (-2.0 * torch.log(u1)) * vol).numpy()
    re, im = (t.numpy() for t in sampler.seeded_spectrum_plain(
        seed, table, shape, SPACING, smoothing))
    pplane = (re * re + im * im) * np.float32(vol)
    km = grid.kmag(shape, SPACING).numpy()
    bound = np.append(np.asarray(edges, np.float32), np.float32(np.inf))
    acc = np.zeros((3, nbins))

    def add(cnt, n, p, k):
        if 1 <= cnt <= nbins:
            acc[:, cnt - 1] += (n, p, k)

    interior_end = nzh - 1 if nz % 2 == 0 else nzh
    for xp in range(nx // 2 + 1):
        rows = sorted({xp, (nx - xp) % nx})
        mult = len(rows)
        for y in range(ny):
            cnt = 0

            def advance(k, cnt):
                while bound[cnt] < k:
                    cnt += 1
                return cnt

            def plane(z, cnt):
                cnt = advance(km[xp, y, z], cnt)
                if km[xp, y, z] > 0:
                    add(cnt, mult, sum(float(pplane[x, y, z]) for x in rows),
                        mult * float(km[xp, y, z]))
                return cnt

            cnt = plane(0, cnt)
            cur, run_n, run_p, run_k = cnt, 0, 0.0, 0.0
            for z in range(1, interior_end):
                cnt = advance(km[xp, y, z], cnt)
                if cnt != cur:
                    if run_n:
                        add(cur, 2 * mult * run_n, 2 * run_p,
                            2 * mult * run_k)
                    cur, run_n, run_p, run_k = cnt, 0, 0.0, 0.0
                for x in rows:
                    run_p += float(pv[x, y, z])
                run_n += 1
                run_k += float(km[xp, y, z])
            if run_n:
                add(cur, 2 * mult * run_n, 2 * run_p, 2 * mult * run_k)
            if nz % 2 == 0:
                plane(nzh - 1, cnt)
    return acc


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("smoothing", [0.0, 4.0])
def test_k5_walk_sums_are_the_fused_plain_sums(shape, smoothing):
    table = _table(shape)
    edges, _ = stats.bin_setup(shape, SPACING, NBINS)
    want = sampler.seeded_power_bins_plain(3, table, shape, SPACING,
                                           smoothing, edges).numpy()
    got = _k5_mirror(3, table, shape, smoothing, edges)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1:], want[1:], rtol=MIRROR_RTOL)


def test_k5_walk_carries_the_bin_past_edges_on_shells():
    # edges placed on float32 |k| of lattice shells, not log-uniform, and
    # modes above the last edge: the carried bin must still be the edge
    # search's
    shape = (16, 16, 16)
    km = np.unique(grid.kmag(shape, SPACING).numpy())
    edges = np.concatenate([[km[1] * 0.999], km[[3, 8, 20, 60]]])
    edges = edges.astype(np.float32).astype(np.float64)
    table = _table(shape)
    want = sampler.seeded_power_bins_plain(2, table, shape, SPACING, 0.0,
                                           edges).numpy()
    got = _k5_mirror(2, table, shape, 0.0, edges)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1:], want[1:], rtol=MIRROR_RTOL)
    assert want[0].sum() < 16 * 16 * 16 - 1


# ---- the fused K5, plain, and the batch -----------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("smoothing", [0.0, 4.0])
def test_fused_k5_plain_is_k1_spectrum_binned(shape, smoothing):
    table = _table(shape)
    edges, _ = stats.bin_setup(shape, SPACING, NBINS)
    acc = sampler.sample_power_bins(5, table, shape, SPACING, smoothing,
                                    edges).numpy()
    re, im = sampler.sample_modes(5, table, shape, SPACING, smoothing)
    k, p, n = stats.spectrum_power((re, im), shape, SPACING, NBINS)
    np.testing.assert_array_equal(acc[0], n)
    live = n > 0
    np.testing.assert_allclose(acc[1][live] / n[live], p[live], rtol=SUM_RTOL)
    np.testing.assert_allclose(acc[2][live] / n[live], k[live], rtol=SUM_RTOL)
    assert n.sum() == shape[0] * shape[1] * shape[2] - 1


@pytest.mark.parametrize("shape", [(16, 16, 15), (8, 12, 10)])
@pytest.mark.parametrize("smoothing", [0.0, 4.0])
def test_sample_power_batch_rows_are_single_calls(shape, smoothing):
    g = rft.Generator(*shape, grid_spacing=SPACING, device="cpu",
                      sampler="pallas")
    seeds = [4, 11, 4]
    k, p, n = g.sample_power_batch(seeds, smoothing, nbins=NBINS)
    assert p.shape == (3, NBINS)
    for row, seed in zip(p, seeds):
        k1, p1, n1 = g.sample_power(seed, smoothing, nbins=NBINS)
        np.testing.assert_array_equal(row, p1)
        np.testing.assert_array_equal(k, k1)
        np.testing.assert_array_equal(n, n1)
    # one device block: the plan (edges, k vectors) is made once per nbins
    assert list(g._bin_plans) == [NBINS]
    assert not np.array_equal(p[0], p[1]) and np.array_equal(p[0], p[2])
    plan = g._bin_plans[NBINS]
    block = sampler.sample_power_bins_batch(seeds, g.state.table, g.shape,
                                            SPACING, smoothing, plan)
    assert tuple(block.shape) == (3, 3, NBINS) and block.dtype == torch.float64


def test_sample_power_batch_moves_one_block_to_the_host(monkeypatch):
    g = rft.Generator(8, 12, 10, grid_spacing=SPACING, device="cpu",
                      sampler="pallas")
    moved = []
    to_host = torch.Tensor.cpu

    def counting(t, *args, **kwargs):
        moved.append(tuple(t.shape))
        return to_host(t, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    g.sample_power_batch(range(5), nbins=NBINS)
    assert moved == [(5, 3, NBINS)]
