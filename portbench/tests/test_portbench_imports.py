"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port. Top-level names are compared whole,
so ``tinsel_tpu_torch`` is not ``tinsel_tpu``."""

import ast
import sys
from pathlib import Path

import pytest

from harness.cli import loaded_forbidden

HERE = Path(__file__).resolve().parent.parent
JAX = {"jax", "jaxlib", "flax", "tinsel_tpu"}


def imported(path: Path) -> set:
    """Top-level names of the absolute imports of a source file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in HERE.rglob("*.py") if "_data" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not imported(path) & JAX


@pytest.mark.parametrize("path", [p for p in SOURCES if "reference" in p.parts],
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_takes_nothing_of_the_port(path):
    assert "tinsel_tpu_torch" not in imported(path)


def test_only_port_module_imports_the_port():
    users = [p.relative_to(HERE).as_posix() for p in SOURCES
             if "tinsel_tpu_torch" in imported(p)]
    assert users == ["harness/port.py"]


def test_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tinsel_tpu_torch_x", sys)
    assert "tinsel_tpu" not in loaded_forbidden()
    monkeypatch.setitem(sys.modules, "tinsel_tpu.render", sys)
    assert loaded_forbidden() == ["tinsel_tpu"]


def test_the_reference_loads_no_port_module():
    import subprocess

    code = ("import sys; sys.path[:0] = [sys.argv[1]]; import reference.side, harness.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'tinsel_tpu_torch', 'tinsel_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code, str(HERE)], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"
