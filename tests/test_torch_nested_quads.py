"""KN's quad walk (csrc/sample_modes.cu, ``nested_modes_kernel``) replayed
in Python: its index walk, its plane selection, its folded hash and its
sincos.

A thread draws the quad of rows (x, y), (-x, y), (x, -y), (-x, -y) of one
|kx|, |ky| (x in [0, nx/2], y in [0, ny/2]); the (quad, kz) pairs in
quad-major order are cut into equal runs of a multiple of 32, one a warp of
a persistent grid, lane l on the run's elements l, l + 32, ...  A row that
repeats an earlier one of its quad is not stored.  On a kz = 0 or Nyquist
plane row r's partner is row 3 - r: a non-canonical mode takes its
partner's draw with im negated, a self-conjugate one re sqrt(2), im 0.  The
hash's first add and rotation are folded per row and launch; the angle's
sin and cos come from a quadrant reduction for [0, 2 pi] alone.  On a
slab mesh's shard of ky rows the quads are a local row and its partner
row (``shard_quads``).  Each is held here to what the plain nested stream
(ops/sample.py) computes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(2)

from randomfield_tpu_torch.ops import sample, threefry  # noqa: E402

F32 = np.float32
MASK = 0xFFFFFFFF


def quads(nx, ny):
    """The quad index q -> its four rows (x, y) in the kernel's order."""
    nyq = ny // 2 + 1
    for q in range((nx // 2 + 1) * nyq):
        x, y = divmod(q, nyq)
        px, py = (-x) % nx, (-y) % ny
        yield q, [(x, y), (px, y), (x, py), (px, py)]


def live_rows(rows):
    """Bit r: row r is stored (it repeats no earlier row of its quad)."""
    (x, y), (px, _), _, (_, py) = rows
    return [True, px != x, py != y, px != x and py != y]


def walk(nx, ny, nz, blocks, warps_a_block=8):
    """The (quad, kz) each lane of each warp of ``blocks`` draws, as
    walk_quads steps through them, with the launcher's run length."""
    nzh = nz // 2 + 1
    n_quads = (nx // 2 + 1) * (ny // 2 + 1)
    total = n_quads * nzh
    lanes = 32 * warps_a_block * blocks
    per_warp = -(-total // lanes) * 32
    for warp in range(warps_a_block * blocks):
        begin = warp * per_warp
        if begin >= total:
            continue
        end = min(begin + per_warp, total)
        for lane in range(32):
            e = begin + lane
            q, z = divmod(e, nzh)
            while e < end:
                yield q, z
                e += 32
                z += 32
                while z >= nzh:
                    z -= nzh
                    q += 1


@pytest.mark.parametrize("shape", [(16, 16, 16), (32, 16, 30), (15, 9, 14),
                                   (8, 6, 62), (4, 4, 2)])
@pytest.mark.parametrize("blocks", [1, 3, 1056])
def test_quad_walk_writes_every_mode_once(shape, blocks):
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    rows_of = dict(quads(nx, ny))
    writes = np.zeros((nx, ny, nzh), np.int64)
    for q, z in walk(nx, ny, nz, blocks):
        rows = rows_of[q]
        for (x, y), live in zip(rows, live_rows(rows)):
            if live:
                writes[x, y, z] += 1
    assert np.all(writes == 1)


def plane_fix(re, im, nx, ny, planes):
    """The quad's plane selection on the raw draws of every row's own code:
    a non-canonical mode takes (re, -im) of row 3 - r, a self-conjugate
    mode re sqrt(2), im 0."""
    out_re, out_im = re.clone(), im.clone()
    sqrt2 = float(F32(np.sqrt(2.0)))
    for _, rows in quads(nx, ny):
        for r, (x, y) in enumerate(rows):
            px, py = rows[3 - r]
            for p in planes:
                if x > px or (x == px and y > py):
                    out_re[x, y, p] = re[px, py, p]
                    out_im[x, y, p] = -im[px, py, p]
                elif (x, y) == (px, py):
                    out_re[x, y, p] = re[x, y, p] * sqrt2
                    out_im[x, y, p] = 0.0
    return out_re, out_im


@pytest.mark.parametrize("shape", [(16, 16, 16), (32, 16, 30), (15, 9, 14),
                                   (8, 12, 9)])
def test_quad_planes_are_the_plain_fix(shape):
    """The quad's selection applied to the raw nested draws is the plain
    stream's Hermitian draws (each non-canonical plane mode hashed at its
    partner's code) bit for bit."""
    nx, ny, nz = shape
    key = threefry.key_from_seed(11)
    re, im = sample.nested_unit_draws(key, shape)
    planes = [0] + ([nz // 2] if nz % 2 == 0 else [])
    got = plane_fix(re, im, nx, ny, planes)
    want = sample.nested_hermitian_draws(key, shape)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def shard_quads(nx, ny, y_off, ny_loc):
    """KN's shard walk (``NestedShardQuad``): quad q -> its four rows in
    the kernel's order and which of them it stores.  The quad of local row
    y holds (x, y), (-x, y), (x, -y), (-x, -y), x in [0, nx/2]; a row
    outside the shard is not stored, and where -y lies in the shard at a
    smaller y the quad stores nothing (the quad of -y stores both rows)."""
    for q in range((nx // 2 + 1) * ny_loc):
        x, yl = divmod(q, ny_loc)
        y = y_off + yl
        px, py = (-x) % nx, (-y) % ny
        here = y_off <= py < y_off + ny_loc
        rows = [(x, y), (px, y), (x, py), (px, py)]
        if here and py < y:
            yield q, rows, [False] * 4
            continue
        second = py != y and here
        yield q, rows, [True, px != x, second, px != x and second]


@pytest.mark.parametrize("shape,size", [((16, 16, 16), 2), ((16, 16, 16), 4),
                                        ((8, 12, 10), 3), ((12, 8, 9), 8),
                                        ((6, 10, 6), 5), ((16, 16, 16), 1)])
def test_shard_quads_store_every_shard_mode_once(shape, size):
    """Each mode of each shard is stored once by the shard's quads, and a
    stored plane mode's fix (row 3 - r's draw, im negated, or re sqrt(2))
    is the plain stream's Hermitian draw: the union of the shards is the
    whole-grid result."""
    nx, ny, nz = shape
    ny_loc = ny // size
    key = threefry.key_from_seed(5)
    re, im = sample.nested_unit_draws(key, shape)
    want = sample.nested_hermitian_draws(key, shape)
    planes = [0] + ([nz // 2] if nz % 2 == 0 else [])
    sqrt2 = float(F32(np.sqrt(2.0)))
    for r in range(size):
        y_off = r * ny_loc
        writes = np.zeros((nx, ny_loc), np.int64)
        for _, rows, live in shard_quads(nx, ny, y_off, ny_loc):
            for i, ((x, y), stored) in enumerate(zip(rows, live)):
                if not stored:
                    continue
                assert y_off <= y < y_off + ny_loc
                writes[x, y - y_off] += 1
                px, py = rows[3 - i]
                for p in planes:
                    if x > px or (x == px and y > py):
                        got = (re[px, py, p], -im[px, py, p])
                    elif (x, y) == (px, py):
                        got = (re[x, y, p] * sqrt2, 0.0)
                    else:
                        got = (re[x, y, p], im[x, y, p])
                    assert float(got[0]) == float(want[0][x, y, p])
                    assert float(got[1]) == float(want[1][x, y, p])
        assert np.all(writes == 1)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry_w0(key, a, rk):
    """threefry.cuh:threefry2x32_w0: the hash of (x, 0) from a = x + k0 +
    k1 and rk = rotl(k1, 13)."""
    k0, k1 = key
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    x0, x1 = a, rk ^ a
    for r in (15, 26, 6):
        x0 = (x0 + x1) & MASK
        x1 = _rotl(x1, r) ^ x0
    ks = (k0, k1, k2)
    x0 = (x0 + k1) & MASK
    x1 = (x1 + k2 + 1) & MASK
    for i in range(1, 5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, (0xDEADBEEF, 0xFFFFFFFF)])
def test_folded_hash_is_threefry(seed):
    key = threefry.as_key(seed)
    codes = sample.lattice_codes((16, 12, 10)).flatten()
    rng = np.random.default_rng(3)
    codes = torch.cat([codes, torch.as_tensor(
        rng.integers(0, 2**32, 500, dtype=np.int64))])
    k0, k1 = key
    a = (codes + k0 + k1) & MASK
    got = threefry_w0(key, a, _rotl(k1, 13))
    want = sample.nested_bits(key, codes)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _fma(a, b, c):
    """float32 fma: the exact product (float64 holds it) plus c, rounded."""
    return (a.astype(np.float64) * b + c).astype(F32)


def _hex(text):
    return F32(float.fromhex(text))


def sincos_turn(theta):
    """sample_modes.cu:sincos_turn in float32, the same constants."""
    magic = F32(12582912.0)
    t = _fma(theta, _hex("0x1.45f306p-1"), magic)
    q = t.view(np.int32)
    j = (t - magic).astype(F32)
    r = _fma(-j, _hex("0x1.921fb6p+0"), theta)
    r = _fma(-j, _hex("-0x1.777a5cp-25"), r)
    r = _fma(-j, _hex("-0x1p-49"), r)
    r2 = (r * r).astype(F32)
    ps = _fma(np.full_like(r, _hex("-0x1.9943f2p-13")), r2,
              _hex("0x1.11073cp-7"))
    ps = _fma(ps, r2, _hex("-0x1.555546p-3"))
    ps = (ps * r2).astype(F32)
    sn = _fma(ps, r, r)
    pc = _fma(np.full_like(r, _hex("0x1.99eb9cp-16")), r2,
              _hex("-0x1.6c0c34p-10"))
    pc = _fma(pc, r2, _hex("0x1.55554ap-5"))
    pc = _fma(pc, r2, F32(-0.5))
    cs = _fma(pc, r2, F32(1.0))
    swap = (q & 1) == 1
    s = np.where(swap, cs, sn).view(np.int32) ^ ((q & 2) << 30)
    c = np.where(swap, sn, cs).view(np.int32) ^ (((q + 1) & 2) << 30)
    return s.view(F32), c.view(F32)


def test_sincos_turn_on_every_angle():
    """On every angle 2 pi u of a 24-bit uniform with the half-ulp offset
    (the nested stream's theta): within 1.5 ulp of the true sin and cos,
    at most 1 ulp from the correctly rounded float32 values."""
    worst, off = 0.0, 0
    for lo in range(0, 1 << 24, 1 << 22):
        b = np.arange(lo, lo + (1 << 22), dtype=np.int64)
        u = (b.astype(F32) * F32(2.0 ** -24) + F32(2.0 ** -25)).astype(F32)
        theta = (F32(2.0 * np.pi) * u).astype(F32)
        s, c = sincos_turn(theta)
        for got, fn in ((s, np.sin), (c, np.cos)):
            true = fn(theta.astype(np.float64))
            ulp = np.spacing(np.abs(true).astype(F32)).astype(np.float64)
            worst = max(worst, float(np.max(np.abs(got - true) / ulp)))
            rounded = true.astype(F32).view(np.int32).astype(np.int64)
            off = max(off, int(np.max(np.abs(
                got.view(np.int32).astype(np.int64) - rounded))))
    assert worst <= 1.5 and off <= 1
