"""What the benchmark may import: never JAX or the JAX package, and in the
reference nothing of the port either (top-level names compared whole)."""

import ast
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "polgen_rvc_tpu"}


def imported_tops(path: Path) -> set:
    return _tops(ast.parse(path.read_text()))


def _tops(tree) -> set:
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_no_jax_side_import(path):
    assert not imported_tops(path) & JAX_SIDE


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "polgen_rvc_tpu_torch" not in imported_tops(path)
    assert not imported_tops(path) & JAX_SIDE


@pytest.mark.parametrize("path", sorted((BENCH / "f0").glob("*.py")), ids=lambda p: p.name)
def test_f0_modules_reach_the_port_only_in_program_params(path):
    """The reference calls these modules: at import, and in every function
    but the two of the program's side (program_params, which makes the
    port's arguments, and program_tap, which catches what its pass hands
    its last stage), they take nothing of it."""
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in ("program_params",
                                                               "program_tap"):
            continue
        sub = ast.Module(body=[node], type_ignores=[])
        assert "polgen_rvc_tpu_torch" not in _tops(sub), (path.name, getattr(node, "name", ""))


def test_whole_names_are_compared(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "polgen_rvc_tpu_torchlike", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "polgen_rvc_tpu.pipeline", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["polgen_rvc_tpu"]
