"""No run loads JAX or the JAX package, and the plain reference imports
nothing of the system under test: a scan of the sources by top-level name,
compared whole (``repro_torch`` begins with ``repro``), and the run-time
check of ``sys.modules``."""

import ast
import sys
from pathlib import Path

import pytest
from conftest import tiny_cell

from portbench import harness

BASE = Path(harness.__file__).parent


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BASE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BASE)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BASE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert names <= {"__future__", "contextlib", "math", "torch", "portbench"}
    text = path.read_text()
    assert "repro_torch" not in text
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("portbench"):
            assert node.module == "portbench.reference"


def test_runtime_check_compares_whole_names(monkeypatch):
    assert harness.forbidden_modules() == []
    import repro_torch  # noqa: F401  (begins with "repro", and is no JAX package)

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]


def test_a_run_loads_no_jax():
    harness.run(tiny_cell("olmoe-1b-7b.l8.train-b4s4096"), 5, 0.2, True, "cpu")
    assert harness.forbidden_modules() == []
