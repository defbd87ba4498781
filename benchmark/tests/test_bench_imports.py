"""No file of the benchmark imports JAX or the JAX package, judged by
whole top-level names; the reference imports nothing of the program."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "speech_distill_tpu"}
FILES = sorted(BENCH.rglob("*.py"))


def top_names(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "speech_distill_tpu_torch" not in top_names(path)
    assert "benchmark" not in top_names(path)


def test_whole_names_are_compared():
    from benchmark.harness import core
    import sys
    sys.modules.setdefault("speech_distill_tpu_torch_probe", object())
    assert "speech_distill_tpu_torch" not in core.FORBIDDEN
    assert "speech_distill_tpu_torch_probe" not in core.forbidden_loaded()
