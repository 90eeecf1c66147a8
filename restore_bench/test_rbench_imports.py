"""Nothing under restore_bench imports JAX, Flax or the JAX package
``repro`` (top-level names compared whole: ``repro_torch`` is not
``repro``) or reads the old benchmark's folder; the reference and the
yardstick import nothing of the program."""
import ast
from pathlib import Path

import pytest

from restore_bench import harness

HERE = Path(__file__).resolve().parent
FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(HERE))
                                             for p in FILES])
def test_no_jax_and_no_old_benchmark(path):
    tops = set(_imports(path))
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops
    text = path.read_text()
    old = "bench" + "marks/"
    assert old not in text and "BENCH_" + "core" not in text


@pytest.mark.parametrize("sub", ["reference", "yardstick"])
def test_yardstick_and_reference_import_no_program(sub):
    for path in sorted((HERE / sub).glob("*.py")):
        assert "repro_torch" not in set(_imports(path)), path


def test_guard_compares_whole_names():
    names = ["repro_torch", "repro_torch.serve", "repro_torchx", "jaxtyping",
             "flaxen", "torch"]
    assert harness.forbidden_modules(names) == []
    names += ["repro.core.plan", "jax.numpy"]
    assert harness.forbidden_modules(names) == ["jax", "repro"]
