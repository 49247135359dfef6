"""The port's command line (``python -m randomfield_tpu_torch``) against
the JAX package's, both run in this process through ``main(argv)``.

* At 16^3 on the CPU the default render with ``--stats`` and
  ``--sample-power`` of 3 seeds print the same lines as the JAX CLI: the
  same count and text, each number within the largest of 1e-4 relative,
  one unit in its last printed place and 1e-6 absolute (the field mean is
  near zero).  The port's Threefry stream is JAX's; the lines that carry
  a wall time (``rendered in``, ``seeds in``, the JAX Generator's verbose
  ``[randomfield_tpu]`` lines) are left out.
* Every usage error of the JAX CLI exits with code 2 and the same message
  from both.
* Every other mode runs once; a 2-rank ``--mesh 1,2 --out`` run on gloo
  ranks (spawned, FileStore rendezvous) writes chunks that the JAX
  package's ``load_field_sharded`` reads back equal to the one-device
  ``--out``; without a card the default ``--device cuda`` refuses.
* One subprocess: ``python -m randomfield_tpu_torch --device cpu`` exits 0
  and imports no JAX.

JAX is imported inside the tests only, so the spawned ranks import the
port alone.
"""

import contextlib
import fcntl
import io
import os
import pathlib
import re
import subprocess
import sys
from decimal import Decimal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

from randomfield_tpu_torch import __main__ as tcli  # noqa: E402

BASE = ["--nx", "16", "--spacing", "8"]
CPU = ["--device", "cpu"]
# lines whose numbers are wall times
TIMED = re.compile(r"rendered in|seeds in [0-9.]+s|^\[randomfield_tpu\]")
NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")
REL, ABS = 1e-4, 1e-6
JOIN_TIMEOUT_S = 300.0
MESH_BAR = 1e-6  # a mesh render vs one device, as tests/test_torch_mesh.py


def _jax_main():
    from randomfield_tpu import __main__ as jcli

    return jcli.main


def _run(main, argv):
    """(exit code, stdout, stderr) of an in-process CLI run."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as exc:
            rc = exc.code
    return rc, out.getvalue(), err.getvalue()


def _last_place(token):
    """One unit in the last printed place of a number token."""
    mant, _, exp = token.lower().partition("e")
    decimals = len(mant.split(".")[1]) if "." in mant else 0
    return Decimal(10) ** (-decimals + (int(exp) if exp else 0))


def _assert_same_lines(got, want):
    got = [ln for ln in got.splitlines() if not TIMED.search(ln)]
    want = [ln for ln in want.splitlines() if not TIMED.search(ln)]
    assert len(got) == len(want), (got, want)
    assert len(want) >= 5
    for g, w in zip(got, want):
        assert ([" ".join(s.split()) for s in NUMBER.split(g)]
                == [" ".join(s.split()) for s in NUMBER.split(w)]), (g, w)
        for a, b in zip(NUMBER.findall(g), NUMBER.findall(w)):
            # in decimal: 529.9 - 529.8 is one unit, not 0.1 + 2e-14
            bar = max(Decimal(REL) * abs(Decimal(b)), _last_place(b),
                      Decimal(ABS))
            assert abs(Decimal(a) - Decimal(b)) <= bar, (g, w)


@pytest.mark.smoke
@pytest.mark.parametrize("argv", [
    ["--seed", "0", "--stats", "--nbins", "8"],
    ["--seed", "0", "1", "2", "--sample-power", "--nbins", "8"],
], ids=["render-stats", "sample-power"])
def test_cli_lines_match_jax(argv):
    rc, got, _ = _run(tcli.main, BASE + argv + CPU)
    assert rc == 0
    rc_j, want, _ = _run(_jax_main(), BASE + argv)
    assert rc_j == 0
    _assert_same_lines(got, want)


# every p.error of randomfield_tpu/__main__.py, and argparse's own
USAGE_ERRORS = [
    [],  # --spacing is required
    BASE + ["--sampler", "mersenne"],
    BASE + ["--mesh", "1,2", "--pencil", "1,1,2"],
    BASE + ["--mesh", "one,two"],
    BASE + ["--pencil", "1,2"],
    BASE + ["--fixed", "--sample-power"],
    BASE + ["--flip"],
    BASE + ["--bias", "2"],
    BASE + ["--lognormal", "--bias", "2", "--fixed"],
    *[BASE + ["--rsd", flag] for flag in (
        "--lognormal", "--fixed", "--sample-power", "--minkowski",
        "--peaks", "--xi")],
    BASE + ["--rsd", "0.5"],
    BASE + ["--minkowski"],
    BASE + ["--peaks"],
    BASE + ["--peaks", "--no-lightcone", "--sample-power"],
    BASE + ["--xi"],
    *[BASE + ["--catalog", "halos"] + flags for flags in (
        ["--lognormal"], ["--fixed"], ["--rsd", "--no-lightcone"],
        ["--sample-power"], ["--minkowski", "--no-lightcone"],
        ["--peaks", "--no-lightcone"], ["--xi", "--stats"],
        ["--mesh", "1,2"], ["--pencil", "1,1,2"])],
    BASE + ["--lognormal", "--sample-power"],
]


def _error_line(stderr):
    line = stderr.strip().splitlines()[-1]
    return line.split(": error: ", 1)[1]


@pytest.mark.parametrize("argv", USAGE_ERRORS,
                         ids=[" ".join(a[4:]) or "none" for a in USAGE_ERRORS])
def test_usage_errors_match_jax(argv):
    rc, _, err = _run(tcli.main, argv + CPU)
    rc_j, _, err_j = _run(_jax_main(), argv)
    assert rc == rc_j == 2
    assert _error_line(err) == _error_line(err_j)


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run(tcli.main, BASE + ["--quiet"])
    assert rc == 2 and out == ""
    assert "--device cpu" in _error_line(err)


@pytest.mark.parametrize("argv, expect", [
    (["--lognormal", "--bias", "1.7", "--stats", "--xi", "--out", "{tmp}"],
     ["xi =", "wrote"]),
    (["--fixed", "--flip", "--no-lightcone", "--stats"], ["P^ ="]),
    (["--rsd", "0.5", "--bias", "2", "--no-lightcone", "--stats",
      "--nbins", "5"], ["P0 =", "P4 ="]),
    (["--nx", "32", "--spacing", "4", "--smoothing", "8", "--no-lightcone",
      "--minkowski", "--peaks", "--voids", "6,9,12", "--void-threshold",
      "-0.2", "--nbins", "7"],
     ["[exp v3", "BBKS expects", "voids:"]),
    (["--catalog", "halos", "--mass-bins", "2", "--stats", "--nbins", "4",
      "--out", "{tmp}"], ["halos (expected", "(exp", "wrote"]),
    (["--catalog", "galaxies-rsd", "--mass-bins", "2", "--stats",
      "--nbins", "4"], ["galaxies (", "(exp"]),
    (["--sampler", "pallas", "--pipeline", "staged", "--stats"], ["P^ ="]),
    (["--sampler", "nested", "--stats", "--power", "bbks", "--w0", "-0.9",
      "--ok0", "0.02", "--out", "{tmp}"], ["P^ =", "wrote"]),
    (["--seed", "1", "2", "3", "--sample-power", "--nbins", "8",
      "--checkpoint", "{tmp}", "--out", "{tmp}"],
     ["<P^>", "scatter", "checkpoint:", "wrote"]),
], ids=["lognormal", "fixed", "rsd", "morphology", "halos", "galaxies",
        "pallas", "nested", "checkpoint"])
def test_other_modes_run(tmp_path, argv, expect):
    argv = [a.replace("{tmp}", str(tmp_path / "f_{seed}.npz")) for a in argv]
    rc, out, err = _run(tcli.main, BASE + argv + CPU)
    assert rc == 0, err
    for text in expect:
        assert text in out, (text, out)


# ---- the slab mesh: two gloo ranks ------------------------------------------------

MESH_ARGV = BASE + ["--seed", "4", "--quiet"] + CPU


def _rank_main(rank, size, store, out_dir):
    torch.set_num_threads(1)
    from randomfield_tpu_torch.parallel import multihost

    multihost.initialize("gloo", f"file://{store}", size, rank, "cpu")
    try:
        rc = tcli.main(MESH_ARGV + ["--mesh", f"1,{size}", "--out",
                                    os.path.join(out_dir, "chunks_{seed}")])
        if rc:
            raise RuntimeError(f"rank {rank}: exit code {rc}")
        if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
            raise RuntimeError(f"rank {rank} imported JAX")
    finally:
        multihost.shutdown()


def test_mesh_out_reads_back_in_jax(tmp_path):
    import torch.multiprocessing as mp
    from randomfield_tpu.utils import io as jio

    size = 2
    ctx = mp.spawn(_rank_main, args=(size, str(tmp_path / "store"),
                                     str(tmp_path)), nprocs=size, join=False)
    try:
        for _ in range(int(JOIN_TIMEOUT_S)):
            if ctx.join(timeout=1.0):
                break
        else:
            raise TimeoutError(f"{size} ranks did not finish")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    chunks = sorted(p.name for p in (tmp_path / "chunks_4").iterdir())
    assert chunks == ["chunk_00000000_00000000_00000000.npz",
                      "chunk_00000008_00000000_00000000.npz", "manifest.npz"]
    mesh_field, meta = jio.load_field_sharded(tmp_path / "chunks_4")

    rc, _, _ = _run(tcli.main, MESH_ARGV + ["--out",
                                            str(tmp_path / "one.npz")])
    assert rc == 0
    one, one_meta = jio.load_field(tmp_path / "one.npz")
    assert mesh_field.shape == one.shape == (16, 16, 16)
    assert np.abs(mesh_field - one).max() <= MESH_BAR * np.abs(one).max()
    assert meta["seed"] == one_meta["seed"] == 4
    assert meta["scene"] == one_meta["scene"]


def test_python_m_imports_no_jax():
    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "randomfield_tpu_torch",
         "--device", "cpu", "--nx", "16", "--spacing", "8", "--quiet",
         "--stats"], capture_output=True, text=True, env=env, cwd=repo,
        timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "P^ =" in res.stdout
    imported = {ln.rsplit("|", 1)[1].strip()
                for ln in res.stderr.splitlines()
                if ln.startswith("import time:") and ln.count("|") == 2}
    assert "randomfield_tpu_torch.__main__" in imported or \
        "randomfield_tpu_torch" in imported
    assert not {m for m in imported if m.split(".")[0] in
                ("jax", "jaxlib", "randomfield_tpu")}
