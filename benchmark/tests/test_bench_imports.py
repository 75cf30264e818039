"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program.  Names are compared by
their top-level part, whole: ``raytrace3_tpu_torch`` begins with
``raytrace3_tpu`` and is allowed where the program may be imported."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "raytrace3_tpu"}
PROGRAM = "raytrace3_tpu_torch"


def imported(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert PROGRAM not in names and "benchmark" not in names
    assert names <= {"__future__", "math", "torch"}


def test_the_guard_compares_whole_names():
    assert "raytrace3_tpu_torch".split(".")[0] not in FORBIDDEN
    assert imported(BENCH / "drivers" / "render.py") >= set() and SOURCES
