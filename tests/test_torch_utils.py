"""The port's timing and profiling helpers (randomfield_tpu_torch.utils)
on the CPU: Timer, block_and_time (no synchronize on CPU tensors) and a
torch.profiler trace whose Chrome file names an annotated region."""

import ast
import json
import pathlib
import tempfile

import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

from randomfield_tpu_torch.utils import Timer, block_and_time  # noqa: E402
from randomfield_tpu_torch.utils import profiling  # noqa: E402


def test_timer_measures_and_prints(capsys):
    with Timer("stage", verbose=True) as t:
        sum(range(1000))
    assert t.elapsed >= 0.0
    assert "[randomfield_tpu_torch] stage:" in capsys.readouterr().out
    with Timer("quiet") as t:
        pass
    assert t.elapsed >= 0.0 and capsys.readouterr().out == ""


def test_block_and_time_returns_best_and_last(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append(a))

    def fn(x, scale=1.0):
        return {"a": (x * scale, [x + 1]), "n": 3}

    best, out = block_and_time(fn, torch.ones(4), iters=3, scale=2.0)
    assert best >= 0.0
    assert torch.equal(out["a"][0], torch.full((4,), 2.0))
    assert calls == []  # CPU tensors need no wait


def test_trace_writes_annotated_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as log_dir:
        with profiling.annotate("rf_torch_annotated_region"):
            torch.fft.rfftn(torch.ones(8, 8, 8))
    assert log_dir == str(tmp_path)
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "rf_torch_annotated_region" for e in events)


def test_trace_defaults_to_the_temporary_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with profiling.trace() as log_dir:
        torch.ones(4).sum()
    assert log_dir == str(tmp_path / "randomfield_tpu_torch_trace")
    assert len(list(pathlib.Path(log_dir).glob("trace_*.json"))) == 1


def test_entry_point_modules_import_no_jax():
    """The command line, utils/ and examples/ import neither JAX nor the
    JAX package (their import statements, read from the source)."""
    pkg = pathlib.Path(__file__).resolve().parent.parent / \
        "randomfield_tpu_torch"
    files = [pkg / "__main__.py", *sorted((pkg / "utils").glob("*.py")),
             *sorted((pkg / "examples").glob("*.py"))]
    assert len(files) >= 15
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(roots) & {"jax", "jaxlib", "randomfield_tpu"}, \
                (path.name, roots)
