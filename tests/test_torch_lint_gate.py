"""Tier-1 gate: the port's `pio lint` passes CLEAN over the port's own
tree (``predictionio_tpu_torch/``), under the nine rules and the repo
policy of the JAX package's gate (``tests/test_lint_gate.py``).

A finding here is either a new violation (fix it) or a deliberate
exception (suppress it at the site WITH a justification:
``# pio: lint-ignore[rule-id]: why``). The JAX gate's wall-clock bound
on the warm cached run is not copied: the cache's counts and findings
are checked instead.
"""

from __future__ import annotations

import os

import pytest

import predictionio_tpu_torch
from predictionio_tpu_torch.analysis import (
    all_rules,
    default_config,
    format_findings,
    lint_package_report,
)
from predictionio_tpu_torch.analysis.cache import (
    LintCache,
    default_cache_path,
    rules_fingerprint,
)
from predictionio_tpu_torch.analysis.config import path_matches

pytestmark = pytest.mark.lint

EXPECTED_RULES = {
    "resilience-bypass",
    "jit-purity",
    "host-sync-in-hot-path",
    "dtype-discipline",
    "untimed-blocking-io",
    "lock-discipline",
    # whole-program (project) passes
    "shared-state-race",
    "lock-order",
    "jit-recompile-risk",
}

PROJECT_RULES = {"shared-state-race", "lock-order", "jit-recompile-risk"}

PKG = os.path.dirname(os.path.abspath(predictionio_tpu_torch.__file__))


@pytest.fixture(scope="module")
def report():
    return lint_package_report()


def test_rule_suite_is_complete():
    """All nine invariant families registered AND enabled in the policy."""
    assert set(all_rules()) == EXPECTED_RULES
    assert set(default_config().enabled_rules()) == EXPECTED_RULES


def test_package_lints_clean(report):
    """All rules over all of predictionio_tpu_torch/: zero findings. A
    failure message IS the lint report."""
    findings, _ = report
    assert not findings, "\n" + format_findings(findings)


def test_clean_verdict_comes_from_a_full_run(report):
    """The whole-program passes ran and the run saw the whole tree: a gate
    that skipped them, or linted a stub, would be vacuously green."""
    _, stats = report
    assert set(stats.project_rules) == PROJECT_RULES
    assert set(stats.module_rules) == EXPECTED_RULES - PROJECT_RULES
    assert stats.files > 100
    # the default package is the port's, every module of it
    assert stats.files == len(_relpaths())


def _relpaths() -> list[str]:
    return [
        os.path.relpath(os.path.join(dirpath, f), PKG).replace(os.sep, "/")
        for dirpath, _, files in os.walk(PKG)
        if "__pycache__" not in dirpath
        for f in files
        if f.endswith(".py")
    ]


@pytest.mark.parametrize("rule_id", sorted(EXPECTED_RULES))
def test_every_rule_actually_runs_on_the_package(rule_id):
    """Each configured path prefix of each rule matches a real file of
    the port: no rule scopes itself out of existence."""
    relpaths = _relpaths()
    prefixes = default_config().rule_paths(all_rules()[rule_id])
    for prefix in prefixes:
        assert any(path_matches(rp, (prefix,)) for rp in relpaths), (
            f"{rule_id}: configured path {prefix!r} matches no file of the port")


def test_recompile_scope_keeps_the_factory_backed_entry():
    """The policy keeps the JAX package's factory-backed entry and width
    menus; the port's ops/topk.py has the two snappers."""
    opts = default_config().rules["jit-recompile-risk"].options
    assert opts.get("extra_entries", {}).get("recommend_topk_sharded") == ["k"]
    assert set(opts.get("snap_calls", ())) >= {"serving_k", "serving_batch"}
    from predictionio_tpu_torch.ops import topk

    assert callable(topk.serving_k) and callable(topk.serving_batch)


def test_cache_cold_all_misses_warm_all_hits(tmp_path):
    """A cold cached run misses every file, a warm one hits every file,
    and both give the same findings as an uncached run."""
    fingerprint = rules_fingerprint(default_config())
    path = str(tmp_path / "lint-cache.json")
    cold_findings, cold = lint_package_report(cache=LintCache(path, fingerprint))
    assert cold.cache_misses == cold.files and cold.cache_hits == 0
    warm_findings, warm = lint_package_report(cache=LintCache(path, fingerprint))
    assert warm.cache_hits == warm.files and warm.cache_misses == 0
    assert warm.files == cold.files > 100
    assert warm_findings == cold_findings == []
    assert set(warm.project_rules) == PROJECT_RULES


def test_cache_invalidates_one_edited_file(tmp_path):
    """Editing one module invalidates its entry alone; another rule set
    gives another fingerprint."""
    src = tmp_path / "pkg"
    src.mkdir()
    for name in ("a.py", "b.py"):
        (src / name).write_text("X = 1\n")
    fingerprint = rules_fingerprint(default_config())
    path = str(tmp_path / "cache.json")
    from predictionio_tpu_torch.analysis import lint_paths_report

    lint_paths_report([str(src)], cache=LintCache(path, fingerprint))
    (src / "b.py").write_text("import urllib.request\nY = 2\n")
    _, stats = lint_paths_report([str(src)], cache=LintCache(path, fingerprint))
    assert (stats.cache_hits, stats.cache_misses) == (1, 1)
    assert rules_fingerprint(default_config(), ["lock-order"]) != fingerprint


def test_default_cache_path_honours_the_env(monkeypatch, tmp_path):
    monkeypatch.setenv("PIO_LINT_CACHE_DIR", str(tmp_path))
    got = default_cache_path(PKG)
    assert os.path.dirname(got) == str(tmp_path) and got.endswith(".json")
