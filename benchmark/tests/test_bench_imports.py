"""Nothing under ``benchmark/`` imports JAX or the JAX package, and the
plain references import nothing of the program. Module names are
compared whole, by their top-level name: the program's
``openmatch_tpu_torch`` begins with the JAX package's name."""

import ast
import sys
from pathlib import Path

import pytest

from benchmark.common import FORBIDDEN_MODULES, forbidden_loaded

BENCH = Path(__file__).resolve().parents[1]
SOURCES = sorted(BENCH.rglob("*.py"))


def imported_top_levels(path: Path) -> set:
    """Top-level names of the absolute imports in ``path``; a relative
    import counts as the benchmark's own."""
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_scan_sees_every_source():
    assert len(SOURCES) > 20
    assert BENCH / "run.py" in SOURCES


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    bad = imported_top_levels(path) & set(FORBIDDEN_MODULES)
    assert not bad, f"{path} imports {sorted(bad)}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level > 1:
            raise AssertionError(f"{path} reaches out of benchmark/reference")
    assert "openmatch_tpu_torch" not in imported_top_levels(path)


def test_whole_names_are_compared(monkeypatch):
    assert imported_top_levels.__doc__
    monkeypatch.setitem(sys.modules, "openmatch_tpu_torch_like", sys)
    assert "openmatch_tpu_torch_like" not in forbidden_loaded()
    monkeypatch.setitem(sys.modules, "openmatch_tpu.config", sys)
    assert "openmatch_tpu.config" in forbidden_loaded()


def test_the_program_loads_no_jax_in_a_run(tmp_path):
    """A tiny run on the CPU through every driver leaves no JAX module
    behind (in a fresh interpreter: the test session may hold JAX)."""
    import subprocess

    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import time\n"
        "from benchmark.tests.tiny import tiny\n"
        "from benchmark.drivers import search, encode\n"
        "from benchmark.common import forbidden_loaded\n"
        "search.run(tiny('bert-base.search-batch', {}), 5, 0.3, False,"
        " time.time(), device='cpu')\n"
        "encode.run(tiny('t5-base.encode', {}), 5, 0.3, False, time.time(),"
        " device='cpu')\n"
        "assert not forbidden_loaded(), forbidden_loaded()\n"
        % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
