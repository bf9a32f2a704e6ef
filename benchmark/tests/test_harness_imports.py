"""What the benchmark may import: no JAX and neither the JAX package nor the
CPU reference library it was made from, compared by whole top-level names;
no scikit-learn, which the card's machine lacks; and the reference nothing
of the program."""

import ast
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "enstop_tpu", "enstop", "sklearn"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert _top_level_imports(path) <= {"__future__", "typing", "numpy", "torch", "reference"}


def test_the_run_refuses_a_loaded_jax(monkeypatch):
    sys.path.insert(0, str(BENCH))
    import run

    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "enstop_torch_extra", object())  # not "enstop"
    assert run.loaded_forbidden() == ["jax"]
