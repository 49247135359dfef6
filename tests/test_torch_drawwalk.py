"""The walks of the fused K2 (K2F/K7) and of K10 on the CPU.

K2F and K7 (``csrc/draw_scale.cu``) walk x-row pairs: a thread draws the
rows gx and (-gx) mod nx of one ky row, one amplitude for both, each row at
its own chunk key, a warp's 32 lanes on 32 consecutive kz, the kz past the
last multiple of 32 one lane per row pair; a plane mode that is not
canonical hashes the other row's counters.  K10 (``csrc/sample_fftx.cu``)
draws the elements x = t + k nx/E of a line into the registers of thread t
and runs the register-radix passes on them.  Held here:

* a host mirror of K2F's schedule (which lane of which warp draws which
  mode, at which chunk key and counter, negated or not, at which row's
  amplitude): every mode of the block written exactly once, at the
  canonical counter of its own or its partner's mode, on grids whose row
  pairs straddle chunks, with ragged kz, x blocks and K7's ky shards;
* the mirror's replay of those draws equal to ``draw_scale_plain`` bit for
  bit in its three modes (spectrum, unit normals, bits);
* the launcher's choice of 32- or 64-bit counters;
* ``genfft.sample_fftx_emulated`` (K10's data flow on the core's passes)
  against ``sample_fftx_plain`` within K10's bar of 5e-6 of the largest
  output, at every line length the kernel takes.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import randomfield_tpu_torch as rft  # noqa: E402
from randomfield_tpu_torch.ops import fft, genfft, grid, sample  # noqa: E402
from randomfield_tpu_torch.ops import sampler, threefry, transform  # noqa: E402

SPACING = 8.0
SEED = 5
# csrc/draw_scale.cu: warps a block, row pairs a warp
WARPS, PAIRS = 8, 32
# K10 vs its plain version: chip_smoke.py's BARS["K10"]
K10_BAR = 5e-6

# (shape, (x_off, nx_loc, y_off, ny_loc) or None for the whole grid, blocks
# or None for the launcher's count)
WALKS = [
    ((16, 16, 16), None, None),
    ((48, 6, 66), None, None),          # cx = 3: pairs straddle chunks;
                                        # nzh = 34: a 32-kz bulk and a tail
    ((64, 4, 62), None, None),          # nzh = 32: bulk only
    ((7, 5, 9), None, None),            # odd nx and ny; nzh = 5: tail only
    ((20, 6, 130), None, 1),            # cx = 2; warps stride over groups
    ((64, 32, 64), (8, 24, 5, 13), None),  # an x and y block
    ((32, 16, 30), (0, 32, 4, 4), None),   # K7: one ky shard of four
    ((12, 10, 10), (0, 12, 5, 5), None),   # K7: the second of two shards
]


def _table(shape):
    return sampler.make_sigma_table(rft.load_default_power(), shape, SPACING)


def _partner(i, n):
    return 0 if i == 0 else n - i


def counter_is_wide(shape):
    """The launcher's rule (``draw_scale.cu:launch_mode``): 64-bit
    counters unless every counter of a chunk, 2 cx nzh ny of them with the
    im draws, fits 32 bits."""
    nx, ny, nz = shape
    cx = nx // sample.canonical_chunks(nx)
    return 2 * cx * (nz // 2 + 1) * ny > 2**32


def _k2f_walk(shape, block=None, blocks=None, mode="spectrum"):
    """A host mirror of csrc/draw_scale.cu's walk over the (nx_loc, ny_loc,
    nzh) block: for every mode, the chunk whose key hashes it, the re draw's
    counter in that chunk (the im draw's is cx nzh ny further), whether its
    im is negated and whether it is self-conjugate (on a plane; the unit and
    bits modes fix no plane), the x row whose |k|^2 its amplitude was
    computed at, and how often it is stored.  (The kernel compiles the
    plane selections only into the draws of the 32 kz that hold a plane;
    elsewhere they select nothing, here as there.)"""
    nx, ny, nz = shape
    x_off, nx_loc, y_off, ny_loc = block or (0, nx, 0, ny)
    nzh = nz // 2 + 1
    top = nzh - 1 if nz % 2 == 0 else 0
    cx = nx // sample.canonical_chunks(nx)
    mask = 2**64 - 1 if counter_is_wide(shape) else 2**32 - 1
    n_pairs = (nx // 2 + 1) * ny_loc
    if blocks is None:
        groups = -(-n_pairs // PAIRS)
        blocks = min(-(-groups // WARPS), 65535)
    out = {k: np.full((nx_loc, ny_loc, nzh), -1, np.int64)
           for k in ("chunk", "counter", "amp_x")}
    out.update({k: np.zeros((nx_loc, ny_loc, nzh), bool)
                for k in ("negated", "selfc")})
    out["writes"] = np.zeros((nx_loc, ny_loc, nzh), np.int64)

    def row_pair(q):
        gx, yl = divmod(q, ny_loc)
        y = yl + y_off
        x = (gx, _partner(gx, nx))
        py = _partner(y, ny)
        ci = [xr // cx for xr in x]
        base = [(x[r] - ci[r] * cx) * nzh * ny + y for r in range(2)]
        nc = [x[r] > x[1 - r] or (x[r] == x[1 - r] and y > py)
              for r in range(2)]
        sc = [x[r] == x[1 - r] and y == py for r in range(2)]
        live = [x_off <= xr < x_off + nx_loc for xr in x]
        live[1] = live[1] and x[1] != x[0]
        return gx, yl, x, ci, base, py - y, nc, sc, live

    def draw(pair, zs):
        gx, yl, x, ci, base, to_py, nc, sc, live = pair
        fixed = ((zs == 0) | (zs == top)) & (mode == "spectrum")
        for r in range(2):
            if not live[r]:
                continue
            partner = fixed & nc[r]
            idx = (np.where(partner, base[1 - r] + to_py, base[r])
                   + zs * ny) & mask
            at = (x[r] - x_off, yl, zs)
            out["chunk"][at] = np.where(partner, ci[1 - r], ci[r])
            out["counter"][at] = idx
            out["negated"][at] = partner
            out["selfc"][at] = fixed & sc[r]
            out["amp_x"][at] = gx
            out["writes"][at] += 1

    bulk = nzh & ~31
    stride = blocks * WARPS * PAIRS
    for warp in range(blocks * WARPS):
        for g in range(warp * PAIRS, n_pairs, stride):
            end = min(g + PAIRS, n_pairs)
            for q in range(g, end):
                # lane l draws kz = l, l + 32, ... below bulk
                draw(row_pair(q), np.arange(bulk))
            if bulk < nzh:
                for lane in range(32):
                    if g + lane < end:
                        draw(row_pair(g + lane), np.arange(bulk, nzh))
    return out


def _replay(walk, shape, block, smoothing, mode):
    """The mirror's draws evaluated with the plain pieces: the bits at the
    recorded keys and counters, JAX's normals of them, the recorded plane
    fix, and the plain amplitude at the recorded x row."""
    nx, ny, nz = shape
    x_off, nx_loc, y_off, ny_loc = block or (0, nx, 0, ny)
    key = threefry.key_from_seed(SEED)
    chunks = sample.canonical_chunks(nx)
    c_stride = nx // chunks * (nz // 2 + 1) * ny
    chunk = torch.from_numpy(walk["chunk"])
    counter = torch.from_numpy(walk["counter"])
    bre = torch.zeros_like(counter)
    bim = torch.zeros_like(counter)
    for i in range(chunks):
        here = chunk == i
        k = threefry.fold_in(key, i)
        bre[here] = threefry.bits_at(k, counter[here])
        bim[here] = threefry.bits_at(k, counter[here] + c_stride)
    if mode == "bits":
        return torch.stack([bre, bim])
    re = threefry._normal_from_bits(bre)
    im = threefry._normal_from_bits(bim)
    if mode == "unit":
        return torch.stack([re, im])
    negated = torch.from_numpy(walk["negated"])
    selfc = torch.from_numpy(walk["selfc"])
    im = torch.where(negated, -im, im)
    re = torch.where(selfc, re * transform._SQRT2, re)
    im = torch.where(selfc, torch.zeros(()), im)
    amp = sampler.sigma_amplitude(_table(shape), shape, SPACING, smoothing,
                                  0, nx, y_off, ny_loc,
                                  float(sampler._INV_SQRT2))
    ys = torch.arange(ny_loc)[None, :, None]
    zs = torch.arange(nz // 2 + 1)[None, None, :]
    a = amp[torch.from_numpy(walk["amp_x"]), ys, zs]
    return torch.stack([re * a, im * a])


def _plain(shape, block, smoothing, mode):
    nx = shape[0]
    x_off, nx_loc, y_off, ny_loc = block or (0, nx, 0, shape[1])
    table = _table(shape)
    if mode == "bits":
        return sampler.draw_bits(SEED, table, shape, x_off, y_off, nx_loc,
                                 ny_loc)
    return sampler.draw_scale_plain(SEED, table, shape, SPACING, smoothing,
                                    x_off, y_off, nx_loc, ny_loc,
                                    unit=mode == "unit")


@pytest.mark.parametrize("shape,block,blocks", WALKS)
def test_k2f_walk_draws_every_mode_once_at_its_counter(shape, block, blocks):
    nx, ny, nz = shape
    x_off, nx_loc, y_off, ny_loc = block or (0, nx, 0, ny)
    nzh = nz // 2 + 1
    cx = nx // sample.canonical_chunks(nx)
    walk = _k2f_walk(shape, block, blocks)
    np.testing.assert_array_equal(walk["writes"], 1)

    xs = np.arange(x_off, x_off + nx_loc)[:, None, None]
    ys = np.arange(y_off, y_off + ny_loc)[None, :, None]
    zs = np.arange(nzh)[None, None, :]
    # the canonical stream's counter of (x, y, kz) in the chunk x // cx
    own = ((xs % cx) * nzh + zs) * ny + ys + 0 * xs
    want_chunk = xs // cx + 0 * own
    px, py, moved, self_conj = (
        t.numpy()[..., None] for t in sampler.plane_partner(
            torch.arange(x_off, x_off + nx_loc)[:, None],
            torch.arange(y_off, y_off + ny_loc)[None, :], nx, ny))
    want_counter, want_neg = own.copy(), np.zeros(own.shape, bool)
    want_self = np.zeros(own.shape, bool)
    for p in grid.self_conjugate_kz_planes(nz):
        plane = zs == p
        partner = moved & plane
        want_counter = np.where(partner, ((px % cx) * nzh + p) * ny + py,
                                want_counter)
        want_chunk = np.where(partner, px // cx, want_chunk)
        want_neg |= partner
        want_self |= self_conj & plane
    np.testing.assert_array_equal(walk["counter"], want_counter)
    np.testing.assert_array_equal(walk["chunk"], want_chunk)
    np.testing.assert_array_equal(walk["negated"], want_neg)
    np.testing.assert_array_equal(walk["selfc"], want_self)
    # one amplitude a pair: computed at the pair's row gx <= nx / 2
    want_amp = np.minimum(xs, (nx - xs) % nx) + 0 * own
    np.testing.assert_array_equal(walk["amp_x"], want_amp)


@pytest.mark.parametrize("shape,block,blocks", WALKS)
@pytest.mark.parametrize("mode,smoothing", [("spectrum", 0.0),
                                            ("spectrum", 8.0),
                                            ("unit", 0.0), ("bits", 0.0)])
def test_k2f_walk_replay_is_draw_scale_plain(shape, block, blocks, mode,
                                             smoothing):
    walk = _k2f_walk(shape, block, blocks, mode)
    got = _replay(walk, shape, block, smoothing, mode)
    want = _plain(shape, block, smoothing, mode)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(16, 16, 16), (12, 10, 10)])
def test_k7_walk_shards_are_the_whole_grid_walk(shape):
    nx, ny, nz = shape
    whole = _k2f_walk(shape)
    ranks = 2
    ny_loc = ny // ranks
    for r in range(ranks):
        part = _k2f_walk(shape, (0, nx, r * ny_loc, ny_loc))
        for k, v in part.items():
            np.testing.assert_array_equal(
                v, whole[k][:, r * ny_loc:(r + 1) * ny_loc], err_msg=k)


@pytest.mark.parametrize("shape,wide", [
    ((1024, 1024, 1024), False),   # 2 * 64 * 513 * 1024 = 6.7e7 counters
    ((2048, 2048, 2048), False),   # 16 chunks of 128 x rows: 5.4e8
    ((2047, 2048, 2048), True),    # 2047 = 23 * 89: one chunk of 2047 rows
    ((6, 4, 8), False),
])
def test_k2f_counter_width(shape, wide):
    assert counter_is_wide(shape) is wide
    nx, ny, nz = shape
    cx = nx // sample.canonical_chunks(nx)
    # the largest counter, an im draw's, and whether it fits 32 bits
    top = 2 * cx * (nz // 2 + 1) * ny - 1
    assert (top >= 2**32) is wide


# ---- K10 on the register-radix core -------------------------------------------

@pytest.mark.parametrize("nx", [16, 32, 64, 128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("smoothing", [0.0, 8.0])
def test_sample_fftx_emulated_matches_plain(nx, smoothing):
    ny = 3
    nz = 6 if nx < 1024 else 4
    shape = (nx, ny, nz)
    table = _table(shape)
    planes = genfft.plane_spectra(SEED, table, shape, SPACING, smoothing)
    b1, b2 = genfft.genfft_bits(genfft.genfft_key(SEED), shape)
    got = genfft.sample_fftx_emulated(b1, b2, *planes, table, shape, SPACING,
                                      smoothing)
    want = genfft.sample_fftx_plain(b1, b2, *planes, table, shape, SPACING,
                                    smoothing)
    scale = max(float(w.abs().max()) for w in want)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    assert err <= K10_BAR * scale
    # a thread's registers hold x = t + k T: every element once
    e = fft.radix_plan(nx)[0]
    t = nx // e
    xs = (np.arange(t)[:, None] + t * np.arange(e)[None, :]).ravel()
    np.testing.assert_array_equal(np.sort(xs), np.arange(nx))


@pytest.mark.parametrize("kz_off,nkz", [(0, 2), (2, 3)])
def test_sample_fftx_emulated_on_a_kz_block(kz_off, nkz):
    shape = (64, 4, 8)
    table = _table(shape)
    planes = genfft.plane_spectra(SEED, table, shape, SPACING, 4.0)
    b1, b2 = genfft.genfft_bits(genfft.genfft_key(SEED), shape, kz_off, nkz)
    got = genfft.sample_fftx_emulated(b1, b2, *planes, table, shape, SPACING,
                                      4.0, kz_off)
    want = genfft.sample_fftx_plain(b1, b2, *planes, table, shape, SPACING,
                                    4.0, kz_off)
    assert tuple(got[0].shape) == (nkz * shape[1], shape[0])
    scale = max(float(w.abs().max()) for w in want)
    assert max(float((g - w).abs().max())
               for g, w in zip(got, want)) <= K10_BAR * scale
    assert math.isfinite(scale) and scale > 0
