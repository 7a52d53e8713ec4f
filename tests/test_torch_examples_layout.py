"""``examples_torch/`` against ``examples/``: one directory per JAX
example engine under the same name, each with its twin's file set and
an engine.json equal to its twin's as parsed JSON; and, by an AST scan,
no module under ``examples_torch/``, ``predictionio_tpu_torch/`` or
``chip_smoke.py`` imports ``jax`` or ``predictionio_tpu`` (the package
check of ``tests/test_torch_sessionrec_serving.py``, extended to the
examples)."""

from __future__ import annotations

import ast
import json
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_EXAMPLES = REPO / "examples"
PORT_EXAMPLES = REPO / "examples_torch"
#: the JAX examples' shared data directory, not an engine
NOT_ENGINES = {"data"}


def _engines(root: Path) -> list[str]:
    return sorted(p.name for p in root.iterdir() if p.is_dir() and p.name not in NOT_ENGINES
                  and p.name != "__pycache__")


def _files(d: Path) -> set[str]:
    return {p.name for p in d.iterdir() if p.is_file() and p.suffix != ".pyc"}


def test_one_directory_per_jax_example():
    assert _engines(PORT_EXAMPLES) == _engines(JAX_EXAMPLES)
    assert len(_engines(PORT_EXAMPLES)) == 15


@pytest.mark.parametrize("name", _engines(JAX_EXAMPLES))
def test_same_files_and_variant(name):
    assert _files(PORT_EXAMPLES / name) == _files(JAX_EXAMPLES / name)
    with open(PORT_EXAMPLES / name / "engine.json") as f, \
            open(JAX_EXAMPLES / name / "engine.json") as g:
        assert json.load(f) == json.load(g)


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") in
              ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            roots.add(node.args[0].value.split(".")[0])
    return roots


def _sources() -> list[Path]:
    return sorted(list(PORT_EXAMPLES.rglob("*.py"))
                  + list((REPO / "predictionio_tpu_torch").rglob("*.py"))
                  + [REPO / "chip_smoke.py"])


def test_scan_sees_every_example_module():
    names = {p.relative_to(PORT_EXAMPLES).as_posix() for p in PORT_EXAMPLES.rglob("*.py")}
    assert {f"{n}/engine.py" for n in _engines(JAX_EXAMPLES)} <= names
    assert len([n for n in names if n.endswith("seed_events.py")]) == 12


def test_no_jax_imports():
    offenders = {str(p.relative_to(REPO)): sorted(bad) for p in _sources()
                 if (bad := _imported_roots(p) & {"jax", "jaxlib", "predictionio_tpu"})}
    assert not offenders


def test_the_scan_catches_a_jax_import(tmp_path):
    bad = tmp_path / "engine.py"
    bad.write_text("import numpy\nfrom jax import numpy as jnp\n"
                   "from predictionio_tpu.controller import Engine\n"
                   "def f():\n    import jax.numpy\n")
    assert _imported_roots(bad) >= {"jax", "predictionio_tpu"}
