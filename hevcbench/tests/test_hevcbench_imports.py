"""The import check: no module of hevcbench/ imports JAX or the JAX package
(top-level names compared whole), and the reference, with the reference's
side of every entry point (any reference/ directory), imports nothing of
the measured program."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "hevcasm_tpu"}
MODULES = sorted(BENCH.rglob("*.py"))


def imported_top_names(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == \
                "import_module" and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported_top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(BENCH.rglob("reference/*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert "hevcasm_tpu_torch" not in imported_top_names(path)


def test_the_check_sees_a_whole_name(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import hevcasm_tpu_torch\nfrom hevcasm_tpu.ops import x\nimport jax.numpy\n")
    assert imported_top_names(probe) == {"hevcasm_tpu_torch", "hevcasm_tpu", "jax"}
