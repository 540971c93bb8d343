"""The import rule, by whole top-level names: nothing under bench_port/ imports JAX or the
JAX package (tube_mpc_tpu, a different name from tube_mpc_tpu_torch), and the reference
imports nothing of the program either."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "tube_mpc_tpu"}
FILES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
            elif isinstance(arg, ast.JoinedStr) and isinstance(arg.values[0], ast.Constant):
                names.add(arg.values[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"torch", "typing", "__future__", "math"}
    text = path.read_text()
    assert "import tube_mpc_tpu_torch" not in text and "from tube_mpc_tpu_torch" not in text
