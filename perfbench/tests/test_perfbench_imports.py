"""Nothing the benchmark runs imports JAX, the JAX package or the JAX
package's benchmarks, compared by whole top-level module names (the
port's name begins with the JAX package's); and the reference imports
nothing of the program either."""

import ast
from pathlib import Path

import pytest

PERFBENCH = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in PERFBENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(PERFBENCH)) for p in SOURCES])
def test_no_jax_no_reference_package(path):
    assert not set(_tops(path)) & NEVER


@pytest.mark.parametrize("path", sorted((PERFBENCH / "reference").glob(
    "*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(_tops(path))


def test_the_check_compares_whole_names():
    # repro_torch is the program, not the JAX package
    assert "repro_torch".split(".")[0] not in NEVER
    assert "repro.models".split(".")[0] in NEVER
