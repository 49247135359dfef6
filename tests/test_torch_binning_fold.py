"""KB's geometry pass (KBG) on folded lines, replayed in Python and held to
the plain version.

csrc/bin_spectrum.cu's geometry pass walks x in [0, nx/2] and, when the
call holds every ky row, y in [0, ny/2], each line weighted by the rows it
stands for: kx^2 at x and at (nx - x) mod nx are one float32 number, and
so are ky^2 and |k_los|.  Isotropic, a line's counts are closed-form (the
first kz whose float32 k^2 reaches each threshold, binary-searched) and
only |k| is added per mode; wedges take the same k bins and each mode's mu
bin, 4 mu bins at a time.  The replay below repeats those steps in numpy
float32 and is held to :func:`binning.bin_spectrum_plain`: counts exactly,
|k| sums within 1e-12 (float64 additions in another order).  Each mode's
|k| is the plain version's (:func:`binning.mode_terms`): torch's CPU sqrt
is not always the correctly rounded one that numpy and the card's sqrtf
give.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(2)

from randomfield_tpu_torch.ops import binning, grid  # noqa: E402
from randomfield_tpu_torch.validate import stats  # noqa: E402

SPACING = 8.0
SUM_RTOL = 1e-12
F32 = np.float32


def fold_lines(nx, ny, ny_loc, y_off):
    """(x, y, multiplicity) of the folded lines, in the kernel's row order."""
    fold_y = ny_loc == ny
    ys = range(ny // 2 + 1) if fold_y else range(y_off, y_off + ny_loc)
    for x in range(nx // 2 + 1):
        mx = 1 if x == 0 or 2 * x == nx else 2
        for y in ys:
            my = 1 if not fold_y or y == 0 or 2 * y == ny else 2
            yield x, y, mx * my


def geo_line(kvals, kxy2, kz, km, thr, nbins, nz, m, cnt, ksum, nmu=None,
             los_axis=2):
    """The kernel's line: segments between the binary-searched starts, one
    k bin each.  Isotropic, a segment's count is closed-form and its |k|
    sum the lanes' (lane l on the segment's kz l, l + 32, ...) after the
    butterfly; wedges take each mode's mu bin in groups of 4, a count and a
    |k| sum a lane and bin.  Added times ``m`` into ``cnt`` and ``ksum``;
    ``km`` the line's |k|."""
    nzh = kz.size
    k2 = kxy2 + kz * kz  # float32: (kx^2 + ky^2) + kz^2
    assert k2.dtype == F32 and np.all(np.diff(k2) >= 0)
    z_nyq = nzh - 1 if nz % 2 == 0 else -1
    w = np.full(nzh, 2)
    w[0] = 1
    if z_nyq > 0:
        w[z_nyq] = 1

    def count_below(v):
        return int(np.searchsorted(thr[:nbins + 1], v, side="right"))

    def butterfly(lanes):
        off = 16
        while off:
            lanes = [lanes[i] + lanes[i ^ off] for i in range(32)]
            off //= 2
        return lanes[0]

    b_lo = count_below(k2[0])
    nseg = count_below(k2[-1]) - b_lo + 1
    starts = [0]
    for j in range(1, nseg):
        tb = thr[b_lo + j - 1]
        lo, hi = 1, nzh - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if k2[mid] >= tb:
                hi = mid
            else:
                lo = mid + 1
        starts.append(lo)
    starts.append(nzh)
    seen = 0
    for j in range(nseg):
        zs, ze = starts[j], starts[j + 1]
        b = b_lo - 1 + j
        # the closed form's premise: every mode of the segment has its count
        assert all(count_below(k2[z]) == b_lo + j for z in range(zs, ze))
        seen += ze - zs
        if not (0 <= b < nbins and zs < ze):
            continue
        if not nmu:
            seg = km[zs:ze].astype(np.float64)
            c = 2.0 * (ze - zs)
            s = 2.0 * butterfly([seg[lane::32].sum() for lane in range(32)])
            if zs == 0:
                c, s = c - 1.0, s - float(km[0])
            if zs <= z_nyq < ze:
                c, s = c - 1.0, s - float(km[z_nyq])
            cnt[b] += m * c
            ksum[b] += m * s
            continue
        bx, by = kvals
        for g in range(0, nmu, 4):
            lane_cnt = np.zeros((32, 4), np.int64)
            lane_ks = np.zeros((32, 4))
            for z in range(zs, ze):
                klos = (bx, by, kz[z])[los_axis]
                mu = F32(np.abs(klos) / km[z])
                u = min(max(int(F32(mu * F32(nmu))), 0), nmu - 1) - g
                if 0 <= u < 4:
                    lane = (z - zs) % 32
                    lane_cnt[lane, u] += w[z]
                    lane_ks[lane, u] += float(F32(w[z]) * km[z])
            for i in range(4):
                if lane_cnt[:, i].any():
                    key = b * nmu + g + i
                    cnt[key] += m * int(lane_cnt[:, i].sum())
                    ksum[key] += m * butterfly(list(lane_ks[:, i]))
    assert seen == nzh


def folded_geometry(shape, spacing, edges, y_off=0, ny_loc=None, nmu=None,
                    los_axis=2):
    """float64 (2, nb): the folded geometry pass's counts and |k| sums."""
    nx, ny, nz = shape
    ny_loc = ny - y_off if ny_loc is None else ny_loc
    nbins = len(edges) - 1
    kvec = binning.axis_tables(shape, spacing, "cpu")[0].numpy()
    kx, ky, kz = kvec[:nx], kvec[nx:nx + ny], kvec[nx + ny:]
    thr = binning.edge_thresholds(edges)
    lattice = torch.ones((nx, ny_loc, nz // 2 + 1))
    km = binning.mode_terms("grid", [lattice], shape, spacing, edges, 0, nx,
                            y_off)[0].numpy()
    nb = nbins * (nmu or 1)
    cnt, ksum = np.zeros(nb), np.zeros(nb)
    for x, y, m in fold_lines(nx, ny, ny_loc, y_off):
        kxy2 = F32(kx[x] * kx[x]) + F32(ky[y] * ky[y])
        geo_line((kx[x], ky[y]), kxy2, kz, km[x, y - y_off], thr, nbins, nz,
                 m, cnt, ksum, nmu, los_axis)
    return np.stack([cnt, ksum])


def plain_geometry(shape, spacing, edges, y_off=0, ny_loc=None, nmu=None,
                   los_axis=2):
    nx, ny, nz = shape
    ny_loc = ny - y_off if ny_loc is None else ny_loc
    lattice = torch.ones((nx, ny_loc, nz // 2 + 1))
    out = binning.bin_spectrum_plain("grid", [lattice], shape, spacing,
                                     edges, y_off=y_off, nmu=nmu,
                                     los_axis=los_axis)
    return out[0, (0, 2), :-1].numpy()


@pytest.mark.parametrize("shape,spacing", [
    ((1024, 1024, 1024), 2.0), ((16, 12, 10), SPACING), ((12, 16, 15), SPACING),
    ((15, 7, 30), SPACING), ((9, 10, 130), 4.0)])
def test_folded_rows_carry_one_k_squared(shape, spacing):
    """kx^2 at x and (nx - x) mod nx (and ky^2 likewise) are bitwise equal,
    in grid.kvectors and in the tables the kernel reads."""
    for axis, k in zip(range(2), grid.kvectors(shape, spacing)):
        n = shape[axis]
        k2 = (k * k).numpy()
        partner = (-np.arange(n)) % n
        assert np.array_equal(k2.view(np.int32), k2[partner].view(np.int32))
        np.testing.assert_array_equal(k.numpy(), -k.numpy()[partner]
                                      * np.where(np.arange(n) * 2 == n, -1, 1))
    kvec = binning.axis_tables(shape, spacing, "cpu")[0].numpy()
    nx, ny = shape[:2]
    for k, n in ((kvec[:nx], nx), (kvec[nx:nx + ny], ny)):
        partner = (-np.arange(n)) % n
        k2 = k * k
        assert np.array_equal(k2.view(np.int32), k2[partner].view(np.int32))


FOLDS = [
    # even and odd nz, nx != ny, odd nx and ny
    ((16, 12, 10), {}, 8),
    ((12, 16, 15), {}, 8),
    ((15, 7, 30), {}, 6),
    # many thresholds on a line: rounds of 31 segments
    ((8, 8, 128), {}, 100),
    # a slab shard: x folded, y not
    ((16, 12, 20), dict(y_off=3, ny_loc=6), 8),
    ((10, 16, 33), dict(y_off=8, ny_loc=8), 7),
    # 4 wedges on each line-of-sight axis, whole and on a shard
    ((16, 12, 10), dict(nmu=4, los_axis=0), 8),
    ((12, 16, 15), dict(nmu=4, los_axis=1), 8),
    ((15, 7, 30), dict(nmu=4, los_axis=2), 6),
    ((16, 12, 20), dict(nmu=4, los_axis=1, y_off=2, ny_loc=5), 8),
    # more wedges than a group of 4
    ((16, 12, 10), dict(nmu=6, los_axis=2), 8),
]


@pytest.mark.parametrize("shape,kw,nbins", FOLDS)
def test_folded_geometry_matches_plain(shape, kw, nbins):
    edges, _ = stats.bin_setup(shape, SPACING, nbins)
    got = folded_geometry(shape, SPACING, edges, **kw)
    want = plain_geometry(shape, SPACING, edges, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=SUM_RTOL,
                               atol=SUM_RTOL * np.abs(want[1]).max())


@pytest.mark.parametrize("kw", [{}, dict(nmu=4, los_axis=2),
                                dict(y_off=4, ny_loc=4)])
def test_folded_geometry_with_an_edge_on_a_mode(kw):
    """An edge at a mode's float32 |k| exactly: the mode falls below it
    (the edge search on the left), in the replay as in the plain version."""
    shape = (16, 12, 10)
    edges, _ = stats.bin_setup(shape, SPACING, 8)
    km = np.sqrt(grid.ksq(shape, SPACING).numpy()).ravel()
    inside = km[(km > edges[2]) & (km < edges[4])]
    edges[3] = float(inside[inside.size // 2])
    thr = binning.edge_thresholds(edges)
    assert np.sqrt(thr[3]) > F32(edges[3]) >= np.sqrt(
        np.nextafter(thr[3], F32(0)))
    got = folded_geometry(shape, SPACING, edges, **kw)
    want = plain_geometry(shape, SPACING, edges, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=SUM_RTOL,
                               atol=SUM_RTOL * np.abs(want[1]).max())
