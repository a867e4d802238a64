"""What the benchmark's files import, by their sources: nothing of JAX or
the JAX package anywhere, and nothing of the program in the reference."""

import ast

import pytest

from conftest import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "genjax_tpu"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(BENCH_DIR)) for p in SOURCES])
def test_no_module_of_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


REFERENCES = sorted((BENCH_DIR / "reference").glob("*.py"))


@pytest.mark.parametrize("path", REFERENCES, ids=[p.name for p in REFERENCES])
def test_the_reference_imports_nothing_of_the_program(path):
    tops = top_level_imports(path)
    assert "genjax_tpu_torch" not in tops and "harness" not in tops
    assert tops <= {"math", "torch"}


def test_the_names_are_compared_whole():
    assert "genjax_tpu_torch" not in FORBIDDEN and "genjax_tpu" in FORBIDDEN
