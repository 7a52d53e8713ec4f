"""The port's distribution (``make-distribution-torch.sh``) on the CPU: the
tarball holds the port and no file of the JAX package; unpacked outside
the repository, its ``bin_torch/pio`` answers ``version`` and ``status``
with the JAX package and JAX unimportable in the child (a meta-path hook
in a ``-c`` wrapper that then calls the port's ``main``), and the g++
event-log library builds from the tarball's own ``native/`` into the
tarball's own ``build/native/`` (the CUDA kernel's library path lies
under its ``build/kernels/``; it is built on the card by chip_smoke.py).
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tarfile
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

#: the child's interpreter: refuses the JAX package and JAX, then runs
#: `-c CODE`, or the port's `pio` on the arguments that bin_torch/pio
#: passes (`-m predictionio_tpu_torch.cli.pio ...`), reporting where the
#: port was imported from
HOOK = textwrap.dedent("""\
    import importlib.abc
    import sys

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "predictionio_tpu"):
                raise ImportError(f"{name} is unimportable in this process")
            return None

    sys.meta_path.insert(0, Refuse())
    if sys.argv[1:2] == ["-c"]:
        exec(sys.argv[2])
        sys.exit(0)
    assert sys.argv[1:3] == ["-m", "predictionio_tpu_torch.cli.pio"], sys.argv
    import predictionio_tpu_torch
    print("port from", predictionio_tpu_torch.__file__, file=sys.stderr)
    from predictionio_tpu_torch.cli.pio import main
    sys.exit(main(sys.argv[3:]))
""")


@pytest.fixture(scope="module")
def unpacked(tmp_path_factory):
    """(the tarball's member names, the unpacked tree, a child env)."""
    base = tmp_path_factory.mktemp("dist")
    out = subprocess.run([str(REPO / "make-distribution-torch.sh"), str(base / "dist")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    tarball = Path(out.stdout.strip().splitlines()[-1])
    assert tarball.name == "predictionio_tpu_torch-0.1.0.tar.gz" and tarball.exists()
    with tarfile.open(tarball) as tar:
        names = tar.getnames()
        tar.extractall(base / "unpacked", filter="data")
    tree = base / "unpacked" / "predictionio_tpu_torch-0.1.0"
    python = base / "python"
    python.write_text(f'#!/bin/sh\nexec "{sys.executable}" -c \'{HOOK}\' "$@"\n')
    python.chmod(0o755)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PIO_", "PYTHON"))}
    env.update(PIO_PYTHON=str(python), PIO_FS_BASEDIR=str(base / "store"))
    return names, tree, env


def _run(tree: Path, env: dict, *args: str) -> subprocess.CompletedProcess:
    return subprocess.run([str(tree / "bin_torch" / "pio"), *args], cwd=tree.parent, env=env,
                          capture_output=True, text=True, timeout=180)


def test_tarball_holds_the_port_and_nothing_of_the_jax_package(unpacked):
    names, _, _ = unpacked
    top = {n.split("/")[1] for n in names if "/" in n}
    assert top == {"predictionio_tpu_torch", "bin_torch", "conf", "docs_torch",
                   "pyproject.toml", "README.md"}
    assert not [n for n in names if re.search(r"/predictionio_tpu/|/bin/|/docs/", n)]
    assert not [n for n in names if "__pycache__" in n or n.endswith(".so")]
    for pattern in ("csrc/*.cu", "native/*.cc"):
        want = {f"predictionio_tpu_torch-0.1.0/predictionio_tpu_torch/{p.relative_to(REPO / 'predictionio_tpu_torch')}"
                for p in (REPO / "predictionio_tpu_torch").glob(pattern)}
        assert want and want <= set(names), pattern
    for name in sorted(os.listdir(REPO / "bin_torch")):
        assert f"predictionio_tpu_torch-0.1.0/bin_torch/{name}" in names


def test_the_tarball_pyproject_names_the_port_alone(unpacked):
    _, tree, _ = unpacked
    text = (tree / "pyproject.toml").read_text()
    assert 'pio-torch = "predictionio_tpu_torch.cli.pio:main"' in text
    assert not re.search(r"^pio = ", text, re.M)
    assert '"jax"' not in text and '"torch"' in text
    assert 'include = ["predictionio_tpu_torch*"]' in text


@pytest.mark.parametrize("command,expect", [
    (("version",), r"^0\.1\.0$"),
    (("status",), r"Your system is all ready to go\."),
])
def test_unpacked_pio_runs_without_the_jax_package(unpacked, command, expect):
    _, tree, env = unpacked
    out = _run(tree, env, *command)
    assert out.returncode == 0, out.stdout + out.stderr
    assert re.search(expect, out.stdout, re.M), out.stdout
    assert f"port from {tree}/predictionio_tpu_torch/__init__.py" in out.stderr


def _python(tree: Path, env: dict, code: str) -> subprocess.CompletedProcess:
    """``code`` under the hook, with the unpacked tree on the path."""
    return subprocess.run([env["PIO_PYTHON"], "-c", code], cwd=tree.parent,
                          env=dict(env, PYTHONPATH=str(tree)),
                          capture_output=True, text=True, timeout=180)


@pytest.mark.parametrize("module", ["predictionio_tpu", "predictionio_tpu.cli.pio", "jax"])
def test_the_hook_refuses_the_jax_package(unpacked, module):
    _, tree, env = unpacked
    out = _python(tree, env, f"import {module}")
    assert out.returncode != 0
    assert f"{module.split('.')[0]} is unimportable in this process" in out.stderr


def test_native_library_builds_into_the_unpacked_tree(unpacked):
    _, tree, env = unpacked
    out = _python(tree, env, textwrap.dedent("""\
        from predictionio_tpu_torch import native
        from predictionio_tpu_torch.ops import _build
        assert native.load_eventlog() is not None, "the event-log library did not build"
        print(native.library_path("eventlog"))
        print(_build.library_path("flash_attention"))
    """))
    assert out.returncode == 0, out.stdout + out.stderr
    built, kernel = (Path(line) for line in out.stdout.strip().splitlines()[-2:])
    assert built.parent == tree / "build" / "native" and built.exists()
    # where the CUDA kernel builds at first use on the card: the tree's own
    assert kernel.parent == tree / "build" / "kernels"


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(REPO).as_posix() for d in ("bin_torch", "docs_torch")
     for p in (REPO / d).iterdir()] + ["make-distribution-torch.sh"]))
def test_launch_files_name_nothing_of_the_jax_package(path):
    text = (REPO / path).read_text()
    assert not re.search(r"predictionio_tpu(?!_torch)", text), path
    assert not re.search(r"\bimport jax\b|\bjax\.", text), path
