"""Nothing the benchmark runs imports JAX, flax or the JAX package
``repro`` (top-level names compared whole: ``repro_torch`` is not
``repro``), and the plain reference imports nothing of the program."""
import ast
from pathlib import Path

import pytest

from gpubench import run

HERE = Path(__file__).resolve().parent
SOURCES = sorted(p for p in HERE.rglob("*.py"))


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(HERE)) for p in SOURCES])
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not _top_level_imports(path) & set(run.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "refs").glob("*.py"):
        assert _top_level_imports(path) <= {"__future__", "itertools", "math", "typing", "torch"}, path


def test_the_guard_compares_whole_top_level_names():
    assert run.forbidden_modules(["repro_torch", "repro_torch.models.moe", "reprox", "jaxtyping", "torch"]) == []
    assert run.forbidden_modules(["repro.models", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "repro"]
