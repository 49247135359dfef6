"""KX's walk (csrc/extrema.cu), replayed in Python and held to the plain
versions.

A block of the kernel owns a (y, z) tile of its mode
(``extrema.WALK_TILES``) and walks a run of ``extrema.run_length`` x
planes with a halo plane at each end.  A step brings one halo plane into a
ring of raw planes (stage s % STAGES, the next plane in flight), the
threads that loaded its cells convert them into one of two slots (s & 1),
and every thread reduces its slice (``extrema.WALK_SLICES``: a few rows of
two adjacent z) from the slot: the 3-wide z maxima of each of its halo
rows from the 4 z its columns span, then 3-row y maxima.  A window of
three reduced planes gives the 27-cube maximum of plane s - 1's voxels.

The replay repeats that walk in numpy: the tiles, the runs and their
remainders, the halo planes' indices through the kernel's ``wrap``, each
cell's thread and load, the ring's stages and slots (every read finds the
plane it expects; the void mode's rv > 0 flags one byte after their
cell), the threads' slices and live voxels.  It is held to numpy's roll
(every halo index), to the plain versions (the peaks of ``cube_max``,
``peak_counts_plain``'s counts and mask, ``void_candidates_plain``'s set)
on fields with plateaus and a NaN, and it tests every voxel exactly once.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

from randomfield_tpu_torch.ops import extrema  # noqa: E402

# csrc/extrema.cu: kStages, kThreads, kCols
STAGES, THREADS, COLS = 2, 256, 2
SIGMA0 = 0.7
EDGES = np.linspace(-2.0, 4.0, 9)
BAND = (0.5, None)
# axes of 1 and 2 cells, ny and nz below the tiles, several x runs with a
# remainder, nx = 64 + 1 and 2 * 64 + 3 (runs of 64 and of the plan)
SHAPES = [(2, 2, 2), (1, 8, 40), (17, 9, 33), (40, 16, 70), (65, 5, 9),
          (131, 3, 7), (20, 7, 11)]


def wrap(i, n, tile):
    """csrc/extrema.cu ``wrap``: i mod n for i in [-1, n + tile], C's
    truncating remainder when n <= tile, else two selects."""
    if n <= tile:
        i = int(math.fmod(i, n))
        return i + n if i < 0 else i
    return i + n if i < 0 else i - n if i >= n else i


def _slices(mode):
    """Each thread's first halo row and z of its slice, and its rows: a
    warp a group of rows, a thread 2 adjacent z."""
    rows = extrema.WALK_SLICES[mode][0]
    tid = np.arange(THREADS)
    return tid // 32 * rows, tid % 32 * COLS, rows


def _gather(slot, ty, tz, rows):
    """(threads, rows + 2, 4): each thread's halo rows over the 4 z its
    columns span, as its two 2-wide shared loads a row read them."""
    r = ty[:, None, None] + np.arange(rows + 2)[None, :, None]
    c = tz[:, None, None] + np.arange(4)[None, None, :]
    return slot[r, c]


def walk(shape, mode, rx, raws, convert, reduce_step):
    """Replays every block of ``mode`` in the kernel's order.  ``raws``:
    the kernel's input fields; ``convert(*raw cells)`` -> the slot's plane;
    ``reduce_step(block, s, slot)`` reduces a step.  Returns the cells
    loaded from device memory."""
    nx, ny, nz = shape
    ty_, tz_ = extrema.WALK_TILES[mode]
    hy, hz = ty_ + 2, tz_ + 2
    plane = hy * hz
    loads = -(-plane // THREADS)
    e = np.arange(plane)
    # each cell's thread and load: thread e % THREADS, load e // THREADS,
    # every load below kLoads and every cell once
    assert (e // THREADS < loads).all() and np.unique(e).size == plane
    loaded = 0
    for bz in range(-(-nx // rx)):
        for by in range(-(-ny // ty_)):
            for bx in range(-(-nz // tz_)):
                x0, y0, z0 = bz * rx, by * ty_, bx * tz_
                steps = min(rx, nx - x0) + 2
                gy = np.array([wrap(y0 - 1 + h, ny, ty_) for h in range(hy)])
                gz = np.array([wrap(z0 - 1 + h, nz, tz_) for h in range(hz)])
                # numpy's roll: the halo is the tile's cells and one
                # beyond each side, modulo the axis
                np.testing.assert_array_equal(gy, np.arange(y0 - 1, y0 + hy - 1) % ny)
                np.testing.assert_array_equal(gz, np.arange(z0 - 1, z0 + hz - 1) % nz)
                ring = [None] * STAGES

                def fetch(s):
                    if s < steps:
                        gx = wrap(x0 - 1 + s, nx, 1)
                        assert gx == (x0 - 1 + s) % nx
                        ring[s % STAGES] = (s, [f[gx][np.ix_(gy, gz)]
                                                for f in raws])

                for s in range(STAGES - 1):
                    fetch(s)
                block = dict(x0=x0, y0=y0, z0=z0, state={})
                for s in range(steps):
                    fetch(s + STAGES - 1)
                    held, cells = ring[s % STAGES]
                    assert held == s  # the stage holds this step's plane
                    loaded += plane
                    reduce_step(block, s, convert(*cells))
    return loaded


def _held(got, want):
    # the same set of voxels (booleans) or values
    np.testing.assert_array_equal(got, want)


def peak_replay(delta, sign, rx):
    """(peak mask, tested count) of the kernel's peak walk: u = delta /
    (sign sigma0) in float32, the non-strict 27-cube test."""
    shape = delta.shape
    ty, tz, rows = _slices("peaks")
    sigma = np.float32(-SIGMA0 if sign < 0 else SIGMA0)
    peak = np.zeros(shape, bool)
    seen = np.zeros(shape, np.int64)
    slots = [None, None]

    def convert(d):
        return d / sigma

    def reduce_step(block, s, u):
        slots[s & 1] = (s, u)
        held, slot = slots[s & 1]
        assert held == s
        v = _gather(slot, ty, tz, rows)
        mid = np.maximum(v[..., 1], v[..., 2])
        zmax = np.stack([np.maximum(v[..., 0], mid),
                         np.maximum(mid, v[..., 3])], -1)
        m_new = np.maximum(np.maximum(zmax[:, :-2], zmax[:, 1:-1]),
                           zmax[:, 2:])
        u_new = v[:, 1:rows + 1, 1:3]
        st = block["state"]
        if s >= 2:
            top = np.maximum(np.maximum(st["m_prev"], st["m_cur"]), m_new)
            hit = st["u_cur"] >= top
            _mark(block, s, ty, tz, rows, shape, hit, peak, seen)
        if s >= 1:
            st["m_prev"] = st["m_cur"]
        st["m_cur"], st["u_cur"] = m_new, u_new

    loaded = walk(shape, "peaks", rx, (delta,), convert, reduce_step)
    return peak, seen, loaded


def _mark(block, s, ty, tz, rows, shape, hit, out, seen):
    """Records the live voxels of plane x0 + s - 2 each thread tested, and
    the hits among them."""
    nx, ny, nz = shape
    y = block["y0"] + ty[:, None, None] + np.arange(rows)[None, :, None]
    z = block["z0"] + tz[:, None, None] + np.arange(COLS)[None, None, :]
    y, z = np.broadcast_arrays(y, z)
    live = (y < ny) & (z < nz)
    x = block["x0"] + s - 2
    np.add.at(seen, (x, y[live], z[live]), 1)
    out[x, y[live & hit], z[live & hit]] = True


def void_replay(rv, delta, rx):
    """(candidate mask, tested count) of the kernel's void walk: the
    float64 key, the strict test against the 26 neighbours, rv > 0."""
    shape = rv.shape
    ty, tz, rows = _slices("voids")
    ty_, tz_ = extrema.WALK_TILES["voids"]
    plane = (ty_ + 2) * (tz_ + 2)
    cand = np.zeros(shape, bool)
    seen = np.zeros(shape, np.int64)
    keys = [None, None]
    # the flags of two planes, each cell's one byte after its index
    flags = np.zeros(2 * plane + 2, np.uint8)

    def convert(r, d):
        key = r.astype(np.float64) - 1e-9 * d.astype(np.float64)
        return key, (r > 0).ravel()

    def reduce_step(block, s, conv):
        key, pos = conv
        keys[s & 1] = (s, key)
        base = (s & 1) * plane
        flags[base + 1:base + plane + 1] = pos
        held, slot = keys[s & 1]
        assert held == s
        v = _gather(slot, ty, tz, rows)
        mid = np.maximum(v[..., 1], v[..., 2])
        zmax = np.stack([np.maximum(v[..., 0], mid),
                         np.maximum(mid, v[..., 3])], -1)
        zpair = np.stack([np.maximum(v[:, 1:rows + 1, 0], v[:, 1:rows + 1, 2]),
                          np.maximum(v[:, 1:rows + 1, 1], v[:, 1:rows + 1, 3])],
                         -1)
        key_new = v[:, 1:rows + 1, 1:3]
        # a thread's two centres: halo z tz + 1 and tz + 2, read as the two
        # bytes at tz + 2 (one aligned 2-byte load)
        c = (ty[:, None] + np.arange(1, rows + 1)[None, :]) * (tz_ + 2) + tz[:, None]
        assert ((base + c + 2) % 2 == 0).all()
        pos_new = np.stack([flags[base + c + 2], flags[base + c + 3]], -1) == 1
        st = block["state"]
        if s >= 2:
            full_next = np.maximum(np.maximum(zmax[:, :-2], zmax[:, 1:-1]),
                                   zmax[:, 2:])
            top = np.maximum(np.maximum(st["full_prev"], st["ring_cur"]),
                             full_next)
            hit = st["pos_cur"] & (st["key_cur"] > top)
            _mark(block, s, ty, tz, rows, shape, hit, cand, seen)
        if s >= 1:
            st["full_prev"] = np.maximum(st["ring_cur"], st["key_cur"])
        st["ring_cur"] = np.maximum(np.maximum(zmax[:, :-2], zmax[:, 2:]),
                                    zpair)
        st["key_cur"], st["pos_cur"] = key_new, pos_new

    loaded = walk(shape, "voids", rx, (rv, delta), convert, reduce_step)
    return cand, seen, loaded


def _runs(shape, mode):
    """The plan's run and runs of 64 planes (all of nx below 64)."""
    return sorted({extrema.run_length(*shape, mode), min(64, shape[0])})


def _plateaus(shape, seed, steps):
    """A field of plateaus (rounded: ties) with one NaN."""
    rng = np.random.default_rng(seed)
    d = (np.round(rng.standard_normal(shape) * steps) / steps).astype(
        np.float32)
    if d.size > 8:
        d.flat[rng.integers(d.size)] = np.nan
    return d


@pytest.mark.parametrize("shape", SHAPES)
def test_peak_walk_matches_plain(shape):
    d = _plateaus(shape, 70, 3)
    t = torch.as_tensor(d)
    for sign in (1.0, -1.0):
        u = extrema.unit_field(t, SIGMA0, sign)
        want_peak = (u == extrema.cube_max(u)).numpy()
        counts, total, mask = extrema.peak_counts_plain(t, SIGMA0, EDGES,
                                                        sign, BAND)
        for rx in _runs(shape, "peaks"):
            peak, seen, _ = peak_replay(d, sign, rx)
            assert (seen == 1).all()  # every voxel tested once
            _held(peak, want_peak)
            # the kernel's bins and mask from its peaks and its u
            u_k = d / np.float32(-SIGMA0 if sign < 0 else SIGMA0)
            e32 = EDGES.astype(np.float32)
            b = np.searchsorted(e32, u_k[peak], side="right") - 1
            got = np.bincount(b[(b >= 0) & (b < e32.size - 1)],
                              minlength=e32.size - 1)
            _held(got, counts.numpy())
            assert int(peak.sum()) == int(total)
            lo = np.float32(BAND[0])
            _held((peak & (u_k >= lo)).astype(np.uint8), mask.numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_void_walk_matches_plain(shape):
    rng = np.random.default_rng(71)
    rv = (rng.integers(0, 3, shape) * 4.0).astype(np.float32)
    if rv.size > 8:
        rv.flat[rng.integers(rv.size)] = np.nan
    d = _plateaus(shape, 72, 5)
    want = extrema.void_candidates_plain(torch.as_tensor(rv),
                                         torch.as_tensor(d))
    for rx in _runs(shape, "voids"):
        cand, seen, _ = void_replay(rv, d, rx)
        assert (seen == 1).all()  # every voxel tested once
        _held(np.flatnonzero(cand), want)


@pytest.mark.parametrize("mode", ["peaks", "voids"])
def test_read_factor_is_the_walks_loads(mode):
    for shape in ((40, 16, 70), (131, 3, 7), (96, 64, 128)):
        rx = extrema.run_length(*shape, mode)
        rv = np.ones(shape, np.float32)
        if mode == "peaks":
            loaded = peak_replay(rv, 1.0, rx)[2]
        else:
            loaded = void_replay(rv, rv, rx)[2]
        assert extrema.read_factor(shape, mode) == pytest.approx(
            loaded / rv.size, rel=1e-12)
    # at 1024^3: 64-plane runs, (32 + 2)(64 + 2) / (32 * 64) * 66 / 64
    assert extrema.read_factor((1024,) * 3) == pytest.approx(
        34 * 66 / 2048 * 66 / 64)


def test_wrap_is_the_modulo_of_its_range():
    for n in range(1, 70):
        for tile in (1, 16, 32, 64):
            for i in range(-1, n + tile + 1):
                assert wrap(i, n, tile) == i % n


def test_run_length_fills_the_card():
    for mode in ("peaks", "voids"):
        assert extrema.run_length(1024, 1024, 1024, mode) == 64
        assert extrema.run_length(5, 1024, 1024, mode) == 5
        for shape in ((128, 128, 128), (130, 20, 70), (17, 9, 33)):
            rx = extrema.run_length(*shape, mode)
            ty, tz = extrema.WALK_TILES[mode]
            blocks = -(-shape[1] // ty) * -(-shape[2] // tz) * -(-shape[0] // rx)
            assert 1 <= rx <= shape[0]
            assert rx == min(8, shape[0]) or blocks >= extrema._FILL
