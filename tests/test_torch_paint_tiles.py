"""KP's tile plan and the port's own data.

(a) ops/paint.py:tile_plan_plain, the plain replay of csrc/paint.cu's
    passes (anchors and tiles, counts, starts, the index, each tile's
    shared sums, the shell scratch and the owner-side gather), bit-equal to
    deposit_plain for NGP, CIC and TSC on partial edge tiles, wrap-around,
    particles on faces, at L and at -a/2, negative weights, lattice and
    random order, all particles in one cell, axes shorter than the window,
    one particle and none; with the kernel's tiles (16) and small ones (4),
    so a grid holds many tiles;
(b) through it, the painted contrast against the JAX package's paint
    within the 1e-5 of tests/test_torch_zeldovich.py (its float32 scatter
    against the port's int64 sums);
(c) the default power table read from the port's own copy, equal to the
    JAX package's, and no module of the port (nor chip_smoke.py) naming a
    path under the JAX package.
"""

import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

from randomfield_tpu.models import zeldovich as jz  # noqa: E402
from randomfield_tpu_torch.ops import paint as kp  # noqa: E402
from randomfield_tpu_torch.ops import power as tpower  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
SPACING = 4.0
# window weights rounded to 2^-s units once, against float32 atomics
PAINT = 1e-5

CASES = ["edges", "wrap", "faces", "negative", "lattice", "random",
         "one_cell", "short_axes", "one", "empty"]


def _case(name):
    """(float32 (3, n) positions, grid shape, weights) of one case."""
    rng = np.random.default_rng(len(name))
    shape = {"edges": (17, 33, 5), "wrap": (20, 16, 12),
             "short_axes": (1, 2, 3)}.get(name, (16, 16, 16))
    box = np.asarray(shape, np.float32)[:, None] * SPACING
    n = int(np.prod(shape))
    w = 1.0
    if name in ("edges", "negative", "short_axes"):
        pos = rng.uniform(0.0, 1.0, (3, n)) * box
        w = rng.uniform(-1.0 if name == "negative" else 0.0, 2.0, n)
    elif name == "wrap":  # half the particles outside [0, L)
        pos = rng.uniform(-0.5, 1.5, (3, n)) * box
    elif name == "faces":  # on cell faces, at L and at -a/2
        pos = rng.integers(-4, 2 * shape[0] + 4, (3, 4 * n)) * (SPACING / 2)
        pos[:, :3] = box[:, :1]
        pos[:, 3:6] = -SPACING / 2
    elif name in ("lattice", "random"):
        psi = rng.normal(0.0, 1.5 * SPACING, (3,) + shape).astype(np.float32)
        pos = np.asarray(jz.zeldovich_positions(psi, SPACING)).reshape(3, -1)
        if name == "random":
            pos = pos[:, rng.permutation(n)]
    elif name == "one_cell":
        pos = np.full((3, 500), 3.3 * SPACING)
    elif name == "one":
        pos = np.array([[0.2], [15.9], [5.0]]) * SPACING
    else:  # "empty"
        pos = np.zeros((3, 0))
    if not np.isscalar(w):
        w = torch.as_tensor(w.astype(np.float32))
    return torch.as_tensor(pos.astype(np.float32)), shape, w


@pytest.mark.parametrize("tile", [kp.TILE, 4])
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("case", CASES)
def test_tile_plan_equals_deposit_plain(case, order, tile):
    pos, shape, w = _case(case)
    shift = SPACING / 2 if CASES.index(case) % 2 else 0.0
    s = kp.fixed_point_exponent(kp.total_abs_weight(pos, w))
    want = kp.deposit_plain(pos, shape, SPACING, w, order, shift, s)
    plan = kp.tile_plan_plain(pos, shape, SPACING, w, order, shift, s, tile)
    assert torch.equal(plan.grid, want)
    assert plan.total == int(want.sum()) == int(plan.local.sum())
    # the index groups the particles by tile, each tile's from its start
    tiles = int(np.prod(kp.tile_grid(shape, tile)))
    assert plan.counts.shape == (tiles,) and int(plan.counts.sum()) == \
        pos.shape[1]
    assert torch.equal(plan.starts, torch.cumsum(plan.counts, 0)
                       - plan.counts)
    assert torch.equal(plan.tiles[plan.index], torch.repeat_interleave(
        torch.arange(tiles), plan.counts))
    side = tile + order - 1
    assert plan.local.shape == (tiles, side, side, side)
    assert plan.shell.shape == (tiles, kp.shell_slots(shape, order, tile))


@pytest.mark.parametrize("window", ["ngp", "cic", "tsc"])
@pytest.mark.parametrize("interlaced", [False, True])
def test_tile_plan_paints_as_jax(window, interlaced):
    pos, shape, _ = _case("lattice")
    faces, _, _ = _case("faces")
    flat = torch.cat([pos, faces], 1)
    w = torch.as_tensor(np.random.default_rng(7).uniform(
        0.0, 2.0, flat.shape[1]).astype(np.float32))
    order = kp.ORDERS[window]
    s = kp.fixed_point_exponent(kp.total_abs_weight(flat, w))
    shift = SPACING / 2 if interlaced else 0.0
    plan = kp.tile_plan_plain(flat, shape, SPACING, w, order, shift, s)
    got, mean = kp.contrast_plain(plan.grid, s)
    jpos = flat.numpy() + np.float32(shift)
    want, wmean = jz.paint(jpos, shape, SPACING, w.numpy(), window)
    want = np.asarray(want, np.float64)
    rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert rel <= PAINT
    assert mean == pytest.approx(float(wmean), rel=PAINT)


def test_shell_slots_and_tiles():
    # a 16^3 tile's shell: 18^3 - 16^3 cells for TSC, 17^3 - 16^3 for CIC
    assert kp.shell_slots((1024,) * 3, 3) == 18 ** 3 - 16 ** 3 == 1736
    assert kp.shell_slots((1024,) * 3, 2) == 17 ** 3 - 16 ** 3 == 817
    assert kp.shell_slots((1024,) * 3, 1) == 0
    # a thin grid's slots follow its largest tile, not 16^3
    assert kp.shell_slots((1, 1, 100), 3) == 2 * 3 * 18 + 1 * 2 * 18 + 2
    assert kp.tile_grid((17, 33, 5)) == (2, 3, 1)
    assert kp.tile_grid((1024,) * 3) == (64, 64, 64)


def test_default_power_is_the_ports_own_copy():
    jax_table = REPO / "randomfield_tpu" / "data" / "default_power.dat"
    path = tpower._DEFAULT_POWER
    assert path.is_relative_to(REPO / "randomfield_tpu_torch")
    assert path.read_bytes() == jax_table.read_bytes()
    table = tpower.load_default_power()
    want = np.loadtxt(jax_table)
    np.testing.assert_array_equal(table.k, want[:, 0])
    np.testing.assert_array_equal(table.Pk, want[:, 1])


def _strings(tree):
    """The string constants of a module that are not docstrings, each with
    whether it is the value of a ``replaces=`` keyword (chip_smoke's
    kernel records name the TPU kernel's file:line there)."""
    docs, replaces = set(), set()
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef)) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)):
            docs.add(id(body[0].value))
        if isinstance(node, ast.keyword) and node.arg == "replaces":
            replaces.add(id(node.value))
    return [(n.value, id(n) in replaces) for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_the_port_names_no_path_under_the_jax_package():
    bad = []
    for path in sorted((REPO / "randomfield_tpu_torch").rglob("*.py")):
        for text, _ in _strings(ast.parse(path.read_text())):
            rest = text.replace("randomfield_tpu_torch", "")
            if rest == "randomfield_tpu" or "randomfield_tpu/" in rest:
                bad.append((path.name, text))
    # chip_smoke.py names the JAX package as a module it must not import,
    # and the TPU kernels it replaces; it reads nothing under it
    smoke = ast.parse((REPO / "chip_smoke.py").read_text())
    bad += [("chip_smoke.py", text) for text, replaces in _strings(smoke)
            if "randomfield_tpu/" in text and not replaces]
    assert not bad
