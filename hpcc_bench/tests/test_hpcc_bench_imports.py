"""No file of the benchmark imports JAX or the JAX package (top-level
module names compared whole: ``repro_torch`` is not ``repro``), and the
reference imports nothing of the port."""
from __future__ import annotations

import ast

import pytest

from conftest import BENCH

FILES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    found = set(top_level_imports(path)) & {"jax", "jaxlib", "flax",
                                            "repro"}
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert set(top_level_imports(path)) <= {"__future__", "contextlib",
                                            "torch", "numpy", "math"}


def test_no_shadowing_module_names():
    """Nothing here may shadow the repository's top-level names."""
    taken = {"benchmarks", "tests", "chip_smoke", "repro", "repro_torch"}
    for path in BENCH.rglob("*.py"):
        if path.name == "__init__.py":
            pytest.fail(f"{path}: the benchmark holds no package")
        assert path.stem not in taken, path
