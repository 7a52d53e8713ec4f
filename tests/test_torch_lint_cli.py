"""The port's ``pio lint`` command line against the JAX package's, each in
its own process on the same fixture paths: exit codes, text, JSON and
SARIF reports, the rule listing, baselines, ``--changed`` inside and
outside a git work tree, and a ``pio lint`` process that loads no torch.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.lint

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "analysis_fixtures"
MODULES = {"jax": "predictionio_tpu.cli.pio", "port": "predictionio_tpu_torch.cli.pio"}


def _env(tmp_path: Path, pythonpath: Path = REPO) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(pythonpath), JAX_PLATFORMS="cpu",
               PIO_LINT_CACHE_DIR=str(tmp_path / "lint-cache"))
    return env


def _pio(side: str, *argv: str, tmp_path: Path, cwd: Path = REPO,
         pythonpath: Path = REPO, extra_env: dict | None = None):
    env = _env(tmp_path, pythonpath)
    env.update(extra_env or {})
    return subprocess.run([sys.executable, "-m", MODULES[side], "lint", *argv], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=120)


def _both(*argv: str, tmp_path: Path, **kw):
    return {side: _pio(side, *argv, tmp_path=tmp_path, **kw) for side in MODULES}


def _fixture(*names: str) -> list[str]:
    return [str(FIXTURES / n) for n in names]


#: (argv, expected exit code) — a clean run, runs with findings, and bad
#: invocations
EXIT_CASES = [
    (_fixture("dtype_good.py"), 0),
    (_fixture("host_sync_good.py", "locks_good.py", "race_xmod_good"), 0),
    (_fixture("io_good.py"), 1),
    (_fixture("io_bad.py"), 1),
    (_fixture("host_sync_bad.py", "race_xmod_bad", "lockorder_bad.py"), 1),
    (_fixture("io_bad.py") + ["--rule", "untimed-blocking-io"], 1),
    (_fixture("jit_recompile_bad.py") + ["--no-project"], 0),
    (_fixture("io_bad.py") + ["--rule", "no-such-rule"], 2),
    (_fixture("no_such_file.py"), 2),
]


@pytest.mark.parametrize("argv,code", EXIT_CASES,
                         ids=[f"case{i}" for i in range(len(EXIT_CASES))])
def test_exit_code_and_text_equal_jax(argv, code, tmp_path):
    runs = _both(*argv, "--no-cache", tmp_path=tmp_path)
    assert runs["port"].returncode == runs["jax"].returncode == code, (
        runs["port"].stderr, runs["jax"].stderr)
    assert runs["port"].stdout == runs["jax"].stdout
    assert runs["port"].stderr == runs["jax"].stderr
    if code == 0:
        assert runs["port"].stdout.strip() == "clean: no findings"


def test_unknown_rule_message(tmp_path):
    p = _pio("port", *_fixture("io_bad.py"), "--rule", "no-such-rule", "--no-cache",
             tmp_path=tmp_path)
    assert p.returncode == 2 and p.stdout == ""
    assert p.stderr.startswith("[ERROR] unknown/disabled rule(s): ['no-such-rule']")


@pytest.mark.parametrize("names", [("io_bad.py",), ("locks_bad.py", "race_bad.py"),
                                   ("jit_bad.py", "callguard_bad.py", "resilience_bad.py")])
def test_json_findings_equal_jax(names, tmp_path):
    runs = _both(*_fixture(*names), "--format", "json", "--no-cache", tmp_path=tmp_path)
    docs = {side: json.loads(p.stdout) for side, p in runs.items()}
    assert runs["port"].returncode == runs["jax"].returncode == 1
    assert docs["port"]["findings"] == docs["jax"]["findings"]
    assert docs["port"]["findings"]
    jstats, pstats = docs["jax"]["stats"], docs["port"]["stats"]
    for key in ("files", "cache_hits", "cache_misses", "module_rules", "project_rules",
                "changed_scope"):
        assert pstats[key] == jstats[key], key


def test_sarif_equal_but_the_tool_uri(tmp_path):
    runs = _both(*_fixture("io_bad.py", "host_sync_bad.py", "locks_bad.py"),
                 "--format", "sarif", "--no-cache", tmp_path=tmp_path)
    jdoc, pdoc = (json.loads(runs[side].stdout) for side in ("jax", "port"))
    jdriver, pdriver = jdoc["runs"][0]["tool"]["driver"], pdoc["runs"][0]["tool"]["driver"]
    assert pdriver["name"] == jdriver["name"] == "pio-lint"
    assert "predictionio_tpu_torch" in pdriver.pop("informationUri")
    jdriver.pop("informationUri")
    assert pdoc == jdoc
    assert pdoc["version"] == "2.1.0" and pdoc["runs"][0]["results"]


def test_list_rules_ids_equal_jax(tmp_path):
    runs = _both("--list-rules", tmp_path=tmp_path)
    ids = {side: [line.split()[0] for line in p.stdout.splitlines()]
           for side, p in runs.items()}
    assert runs["port"].returncode == runs["jax"].returncode == 0
    assert ids["port"] == ids["jax"] and len(ids["port"]) == 9
    # the listed scope is the policy's, which equals JAX's rule for rule
    scopes = {side: [line.rsplit("[", 1)[1] for line in p.stdout.splitlines()]
              for side, p in runs.items()}
    assert scopes["port"] == scopes["jax"]


def test_baseline_round_trip(tmp_path):
    paths = _fixture("io_bad.py", "locks_bad.py")
    out = {}
    for side in MODULES:
        baseline = tmp_path / f"{side}-baseline.json"
        wrote = _pio(side, *paths, "--no-cache", "--write-baseline", str(baseline),
                     tmp_path=tmp_path)
        again = _pio(side, *paths, "--no-cache", "--baseline", str(baseline),
                     tmp_path=tmp_path)
        more = _pio(side, *paths, *_fixture("dtype_bad.py"), "--no-cache", "--format", "json",
                    "--baseline", str(baseline), tmp_path=tmp_path)
        out[side] = (wrote.returncode, wrote.stderr.replace(str(baseline), "BASELINE"),
                     json.loads(baseline.read_text()),
                     again.returncode, again.stdout, again.stderr,
                     more.returncode, [f["path"] for f in json.loads(more.stdout)["findings"]])
    assert out["port"] == out["jax"]
    wrote_rc, wrote_err, doc, rc, stdout, stderr, more_rc, more_paths = out["port"]
    assert wrote_rc == 0 and wrote_err.startswith(f"[INFO] wrote {len(doc['findings'])} ")
    assert rc == 0 and stdout.strip() == "clean: no findings"
    assert "baseline suppressed" in stderr
    assert more_rc == 1 and set(more_paths) == {"dtype_bad.py"}


def test_bad_baseline_exits_2(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 99, "findings": []}))
    runs = _both(*_fixture("io_bad.py"), "--no-cache", "--baseline", str(bad),
                 tmp_path=tmp_path)
    assert runs["port"].returncode == runs["jax"].returncode == 2
    assert runs["port"].stderr == runs["jax"].stderr


@pytest.fixture(scope="module")
def copied_tree(tmp_path_factory):
    """Both packages copied into a fresh directory, so ``--changed`` can
    run inside a git work tree of its own and outside any."""
    root = tmp_path_factory.mktemp("lint-changed")
    tree = root / "tree"
    for name in ("predictionio_tpu", "predictionio_tpu_torch"):
        shutil.copytree(REPO / name, tree / name,
                        ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    return root, tree


PLANTED = "import urllib.request\n\n\ndef fetch(u):\n    return urllib.request.urlopen(u)\n"


def test_changed_outside_git_exits_2(copied_tree, tmp_path):
    root, tree = copied_tree
    runs = _both("--changed", "--no-cache", tmp_path=tmp_path, cwd=tree, pythonpath=tree,
                 extra_env={"GIT_CEILING_DIRECTORIES": str(root)})
    assert runs["port"].returncode == runs["jax"].returncode == 2
    assert runs["port"].stderr == runs["jax"].stderr
    assert "not inside a git work tree" in runs["port"].stderr


def test_changed_inside_git_reports_only_changed_files(copied_tree, tmp_path):
    root, tree = copied_tree
    work = root / "work"
    if not work.exists():
        shutil.copytree(tree, work)
    git = ["git", "-c", "user.email=lint@example.invalid", "-c", "user.name=lint"]
    env = {**os.environ, "GIT_CEILING_DIRECTORIES": str(root)}
    for cmd in (["init", "-q"], ["add", "-A"], ["commit", "-q", "-m", "base"]):
        subprocess.run([*git, *cmd], cwd=work, env=env, check=True, capture_output=True,
                       timeout=60)
    for name in ("predictionio_tpu", "predictionio_tpu_torch"):
        (work / name / "api" / "planted_fetch.py").write_text(PLANTED)
    runs = _both("--changed", "--no-cache", "--format", "json", tmp_path=tmp_path, cwd=work,
                 pythonpath=work, extra_env={"GIT_CEILING_DIRECTORIES": str(root)})
    docs = {side: json.loads(p.stdout) for side, p in runs.items()}
    assert runs["port"].returncode == runs["jax"].returncode == 1
    assert docs["port"]["findings"] == docs["jax"]["findings"]
    assert {f["path"] for f in docs["port"]["findings"]} == {"api/planted_fetch.py"}
    assert {f["rule"] for f in docs["port"]["findings"]} == {"untimed-blocking-io"}
    assert docs["port"]["stats"]["changed_scope"] == ["api/planted_fetch.py"]
    # the whole tree was still analysed
    assert docs["port"]["stats"]["files"] > 100


LINT_PROCESS = """
import json, sys
from predictionio_tpu_torch.cli.pio import main
rc = main(sys.argv[1:])
mods = sorted({n.split(".")[0] for n in sys.modules} & {"torch", "jax", "predictionio_tpu"})
print(json.dumps({"rc": rc, "modules": mods}))
"""


def test_port_process_lints_its_tree_clean_and_loads_no_torch(tmp_path):
    env = _env(tmp_path)
    p = subprocess.run([sys.executable, "-c", LINT_PROCESS, "lint", "--format", "json"],
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=180)
    *report, last = p.stdout.strip().splitlines()
    tail = json.loads(last)
    assert tail == {"rc": 0, "modules": []}, p.stderr
    doc = json.loads("\n".join(report))
    assert doc["findings"] == []
    assert doc["stats"]["files"] > 100
    assert set(doc["stats"]["project_rules"]) == {"shared-state-race", "lock-order",
                                                  "jit-recompile-risk"}
    # the default run used the cache under PIO_LINT_CACHE_DIR
    assert doc["stats"]["cache_misses"] == doc["stats"]["files"]
    assert list((tmp_path / "lint-cache").glob("*.json"))


def test_port_cli_module_lints_clean(tmp_path):
    """``python -m predictionio_tpu_torch.cli.pio lint`` as a user runs it."""
    p = subprocess.run([sys.executable, "-m", MODULES["port"], "lint", "--no-cache"],
                       cwd=tmp_path, env=_env(tmp_path), capture_output=True, text=True,
                       timeout=180)
    assert p.returncode == 0, p.stdout + p.stderr
    assert p.stdout.strip() == "clean: no findings"
