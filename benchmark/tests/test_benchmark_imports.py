"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program (top-level module names compared
whole: the port's name begins with the JAX package's)."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "sam_pt_tpu"}
PROGRAM = {"sam_pt_torch"}


def _imports(path: Path) -> set:
    """Top-level names of every module a file imports (relative imports
    count as the benchmark's own)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("benchmark" if node.level else node.module.split(".")[0])
    return names


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    found = _imports(path)
    assert not found & PROGRAM
    assert found <= {"__future__", "contextlib", "math", "numpy", "torch",
                     "benchmark"}


def test_names_are_compared_whole():
    # the port's name begins with the JAX package's, and is allowed
    assert not {"sam_pt_torch"} & FORBIDDEN
    assert "sam_pt_tpu" in FORBIDDEN
