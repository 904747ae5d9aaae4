"""An AST scan of relbench/: what it may import, open and write."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    """Top-level names of every module ``path`` imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def _strings(path):
    return [n.value for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_nor_the_jax_package(path):
    """Top-level names compared whole: ``repro_torch`` is not ``repro``."""
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in _imports(path)
    assert not {"relbench"} & _imports(path)


@pytest.mark.parametrize("path", [p for p in SOURCES if p != Path(__file__).resolve()],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_benchmarks_folder_and_no_fixed_temp_paths(path):
    """(This file, which spells the patterns out, aside.)"""
    for s in _strings(path):
        assert "benchmarks/" not in s and not s.startswith("benchmarks"), s
        assert not s.startswith(("/tmp", "/dev/shm")), s


def test_the_scan_catches_what_it_looks_for(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy\nfrom repro.core import x\n"
                   "import repro_torch\nopen('/tmp/x', 'w')\n")
    assert _imports(bad) == {"jax", "repro", "repro_torch"}
    assert "/tmp/x" in _strings(bad)
