"""Nothing under perfbench/ imports JAX, the JAX package or the JAX
benchmarks, and the references import nothing of the program; top-level
module names (before the first dot) are compared whole."""
from __future__ import annotations

import ast
import pathlib

import pytest

PERFBENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
FILES = sorted(p for p in PERFBENCH.rglob("*.py")
               if "__pycache__" not in p.parts)


def top_level_imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(PERFBENCH)))
def test_no_jax_no_reference_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PERFBENCH / "reference")
                                        .glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & {"repro_torch", "perfbench"}
    assert "repro_torch" not in path.read_text().replace(
        "src/repro_torch", "")


def test_the_name_check_compares_whole_top_level_names():
    from perfbench.harness import cell
    import sys
    sys.modules.setdefault("repro_torch_probe_name", sys)
    try:
        assert "repro_torch_probe_name" not in cell.loaded_forbidden()
        sys.modules["repro.probe"] = sys
        assert "repro.probe" in cell.loaded_forbidden()
    finally:
        sys.modules.pop("repro.probe", None)
        sys.modules.pop("repro_torch_probe_name", None)
