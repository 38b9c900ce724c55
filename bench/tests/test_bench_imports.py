"""What the benchmark imports: no ``jax``, ``jaxlib``, ``flax`` or
``repro`` anywhere under ``bench/`` (top-level names compared whole, so
``repro_torch`` is not ``repro``), and nothing of the program in the
reference."""

import ast

import pytest

from bench.cell import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


def imported(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not set(imported(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert set(imported(path)) <= {"torch", "math", "__future__"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom):
            assert node.level in (0, 1), "only the reference's own modules"
