"""The port's ``pio lint`` rules (``predictionio_tpu_torch/analysis/``)
held against the JAX package's on the CPU.

- Every entry of ``tests/analysis_fixtures/`` under every rule, with each
  option set the JAX rule tests use: both packages give the same
  ``(rule_id, path, line, col)`` set and the same messages, apart from
  the one device sentence that the port's ``dtype-discipline`` says of
  the card instead of a TPU.
- The JAX tests' suppression and framework cases
  (``tests/test_analysis_rules.py``, ``TestSuppressionMachinery`` and
  ``TestFrameworkSurface``), run through both packages.
- The torch twins in ``tests/analysis_fixtures_torch/`` give the
  findings of their JAX twins.
- The repo policy equals the JAX package's, rule for rule and path for
  path, with the resilience layer named as the port's.
"""

from __future__ import annotations

import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

import predictionio_tpu.analysis as jax_analysis
import predictionio_tpu.analysis.config as jax_config
import predictionio_tpu.analysis.core as jax_core
import predictionio_tpu_torch.analysis as port_analysis
import predictionio_tpu_torch.analysis.config as port_config
import predictionio_tpu_torch.analysis.core as port_core

pytestmark = pytest.mark.lint

REPO = Path(__file__).resolve().parent.parent
FIXTURES = os.path.join(os.path.dirname(__file__), "analysis_fixtures")
TORCH_FIXTURES = os.path.join(os.path.dirname(__file__), "analysis_fixtures_torch")


def _pkg(analysis, config, core) -> types.SimpleNamespace:
    return types.SimpleNamespace(
        lint_paths=analysis.lint_paths, LintConfig=config.LintConfig, RuleConfig=config.RuleConfig,
        default_config=config.default_config, all_rules=analysis.all_rules,
        parse_suppressions=core.parse_suppressions, BAD_SUPPRESSION=core.BAD_SUPPRESSION)


PACKAGES = {
    "jax": _pkg(jax_analysis, jax_config, jax_core),
    "port": _pkg(port_analysis, port_config, port_core),
}

RULE_IDS = sorted(jax_analysis.all_rules())

#: the JAX rule tests' option sets (tests/test_analysis_rules.py), with
#: ``require_import`` spelled out: the two packages' defaults name their
#: own resilience layer, and the fixtures import the JAX package's
JAX_RESILIENCE = "predictionio_tpu.utils.resilience"
RULE_OPTIONS = {
    "resilience-bypass": {
        "none": {},
        "guards": {
            "guarded_sites": {"resilience_bad.py": ["_raw_request"],
                              "resilience_good.py": ["_raw_request"]},
            "resilient_only": {"resilience_bad.py": ["_raw_request"],
                               "resilience_good.py": ["_raw_request"]},
            "require_import": JAX_RESILIENCE,
        },
        "callguard": {
            "guarded_sites": {"callguard_bad.py": ["_open_socket"]},
            "call_guard": {"callguard_bad.py": {"_open_socket": ["Conn.__init__"]}},
            "no_import_ok": ["callguard_bad.py"],
        },
        "stale": {"guarded_sites": {"io_good.py": ["NoSuchFn._gone"]},
                  "require_import": JAX_RESILIENCE},
    },
    "untimed-blocking-io": {
        "none": {},
        "sleep": {"banned_sleep_paths": [""]},
        "sleep-elsewhere": {"banned_sleep_paths": ["somewhere-else/"]},
    },
    "jit-recompile-risk": {
        "none": {},
        "menus": {"snap_calls": ["snap_width"],
                  "extra_entries": {"sharded_lookup": ["k"]}},
    },
}

ENTRIES = sorted(e for e in os.listdir(FIXTURES)
                 if e != "__pycache__" and e != "__init__.py")

CASES = [(entry, rule_id, opts_name)
         for entry in ENTRIES
         for rule_id in RULE_IDS
         for opts_name in RULE_OPTIONS.get(rule_id, {"none": {}})]


def _message(rule_id: str, message: str) -> str:
    """The message as both packages must spell it: the port's
    dtype-discipline states its device fact of the card, after the dash."""
    if rule_id == "dtype-discipline":
        return message.split(" — ")[0]
    return message


def _run(pkg, rule_id: str, path: str, options: dict, root: str = FIXTURES):
    config = pkg.LintConfig(rules={rule_id: pkg.RuleConfig(paths=("",), options=options)})
    return pkg.lint_paths([path], config=config, rel_root=root, rule_ids=[rule_id])


def _keyed(findings):
    return sorted((f.rule_id, f.path, f.line, f.col, _message(f.rule_id, f.message))
                  for f in findings)


@pytest.mark.parametrize("entry,rule_id,opts_name", CASES)
def test_fixture_findings_equal_jax(entry, rule_id, opts_name):
    options = RULE_OPTIONS.get(rule_id, {"none": {}})[opts_name]
    path = os.path.join(FIXTURES, entry)
    want = _run(PACKAGES["jax"], rule_id, path, options)
    got = _run(PACKAGES["port"], rule_id, path, options)
    assert _keyed(got) == _keyed(want)


def test_fixture_cases_find_something():
    """The parity cases are not vacuous: every rule fires on some fixture
    in both packages, and the bad fixtures give findings."""
    fired = {name: set() for name in PACKAGES}
    for name, pkg in PACKAGES.items():
        for entry, rule_id, opts_name in CASES:
            options = RULE_OPTIONS.get(rule_id, {"none": {}})[opts_name]
            if _run(pkg, rule_id, os.path.join(FIXTURES, entry), options):
                fired[name].add(rule_id)
    assert fired["port"] == fired["jax"] == set(RULE_IDS)


def test_dtype_message_speaks_of_the_card():
    (jax_f, *_), (port_f, *_) = (
        _run(PACKAGES[name], "dtype-discipline", os.path.join(FIXTURES, "dtype_bad.py"), {})
        for name in ("jax", "port"))
    assert "TPU" in jax_f.message
    assert "TPU" not in port_f.message and "the card" in port_f.message


def test_default_require_import_is_the_ports_layer():
    """Without an explicit ``require_import`` the port asks for its own
    resilience layer, which the JAX fixture does not import."""
    opts = dict(RULE_OPTIONS["resilience-bypass"]["guards"])
    del opts["require_import"]
    path = os.path.join(FIXTURES, "resilience_good.py")
    assert _run(PACKAGES["jax"], "resilience-bypass", path, opts) == []
    (finding,) = _run(PACKAGES["port"], "resilience-bypass", path, opts)
    assert finding.message == ("module does not import the resilience layer "
                               "(predictionio_tpu_torch.utils.resilience)")


# ---------------------------------------------------------------------------
# the repo policy
# ---------------------------------------------------------------------------


def _policy(config) -> dict:
    return {rid: (rc.enabled, rc.paths, rc.options) for rid, rc in config.rules.items()}


def test_default_policy_equals_jax_but_the_layer_name():
    want = _policy(jax_config.default_config())
    got = _policy(port_config.default_config())
    assert set(got) == set(want) == set(RULE_IDS)
    want_res = want["resilience-bypass"][2]
    got_res = got["resilience-bypass"][2]
    assert want_res["require_import"] == JAX_RESILIENCE
    assert got_res["require_import"] == "predictionio_tpu_torch.utils.resilience"
    assert {**got_res, "require_import": JAX_RESILIENCE} == want_res
    for rid in RULE_IDS:
        if rid != "resilience-bypass":
            assert got[rid] == want[rid], rid
    assert port_config.default_config().exclude == jax_config.default_config().exclude
    assert port_config.COMPUTE_PATHS == jax_config.COMPUTE_PATHS
    assert port_config.HOT_PATHS == jax_config.HOT_PATHS


@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_rule_surface_equals_jax(rule_id):
    """Same ids, registration order, kind (module or project pass) and
    built-in scope."""
    jax_rule = jax_analysis.all_rules()[rule_id]
    port_rule = port_analysis.all_rules()[rule_id]
    assert list(port_analysis.all_rules()) == list(jax_analysis.all_rules())
    assert port_rule.default_paths == jax_rule.default_paths
    assert (isinstance(port_rule, port_core.ProjectRule)
            == isinstance(jax_rule, jax_core.ProjectRule))


def test_policy_over_the_fixture_tree_equals_jax():
    """The whole fixture tree under each package's unscoped policy: every
    rule, the project passes over one shared model."""
    want = jax_analysis.lint_paths([FIXTURES], config=jax_config.default_config().unscoped(),
                                   rel_root=FIXTURES)
    got = port_analysis.lint_paths([FIXTURES], config=port_config.default_config().unscoped(),
                                   rel_root=FIXTURES)
    assert want and _keyed(got) == _keyed(want)


# ---------------------------------------------------------------------------
# torch twins
# ---------------------------------------------------------------------------

TWINS = [("host-sync-in-hot-path", "host_sync_bad.py"),
         ("host-sync-in-hot-path", "host_sync_good.py"),
         ("dtype-discipline", "dtype_bad.py"),
         ("dtype-discipline", "dtype_good.py")]


@pytest.mark.parametrize("rule_id,name", TWINS)
def test_torch_twin_gives_the_jax_twins_findings(rule_id, name):
    want = _run(PACKAGES["jax"], rule_id, os.path.join(FIXTURES, name), {})
    on_jax_source = _run(PACKAGES["port"], rule_id, os.path.join(FIXTURES, name), {})
    got = _run(PACKAGES["port"], rule_id, os.path.join(TORCH_FIXTURES, name), {},
               root=TORCH_FIXTURES)
    lines = lambda fs: sorted((f.rule_id, f.path, f.line) for f in fs)  # noqa: E731
    assert lines(got) == lines(on_jax_source) == lines(want)
    if name.endswith("_bad.py"):
        assert got


def test_torch_host_sync_twin_names_each_sync():
    findings = _run(PACKAGES["port"], "host-sync-in-hot-path",
                    os.path.join(TORCH_FIXTURES, "host_sync_bad.py"), {}, root=TORCH_FIXTURES)
    messages = "\n".join(f.message for f in findings)
    assert ".item()" in messages
    assert "float(torch.max(scores))" in messages
    assert "np.asarray(torch.sort(scores).values)" in messages
    assert "torch.cuda.synchronize() on the serving path" in messages
    assert "float(torch.sum(scores[:10]))" in messages
    assert len(findings) == 5


def test_jax_rules_do_not_see_the_torch_twins():
    """Why the port's host-sync rule learns the torch vocabulary: the JAX
    rule finds only the method-call sync in the torch twin."""
    findings = _run(PACKAGES["jax"], "host-sync-in-hot-path",
                    os.path.join(TORCH_FIXTURES, "host_sync_bad.py"), {}, root=TORCH_FIXTURES)
    assert [f.line for f in findings] == [11]


# ---------------------------------------------------------------------------
# the JAX tests' suppression machinery and framework surface, both packages
# ---------------------------------------------------------------------------


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _run_pkg(pkg, rule_id, filename, options=None):
    return _run(pkg, rule_id, os.path.join(FIXTURES, filename), options or {})


class TestSuppressionMachinery:
    def test_missing_justification_is_reported_and_not_honored(self, pkg):
        findings = _run_pkg(pkg, "dtype-discipline", "suppress_bad.py")
        rules_hit = {f.rule_id for f in findings}
        assert pkg.BAD_SUPPRESSION in rules_hit
        assert "dtype-discipline" in rules_hit

    def test_unknown_rule_id_is_reported(self, pkg):
        findings = _run_pkg(pkg, "dtype-discipline", "suppress_bad.py")
        assert any("unknown rule 'definitely-not-a-rule'" in f.message for f in findings)

    def test_parse_trailing_and_own_line(self, pkg):
        src = (
            "x = 1  # pio: lint-ignore[jit-purity]: trailing, justified\n"
            "# pio: lint-ignore[dtype-discipline]: own line, justified\n"
            "y = 2\n"
        )
        sups = pkg.parse_suppressions(src)
        assert len(sups) == 2
        trailing, own = sups
        assert trailing.line == 1 and not trailing.own_line
        assert own.line == 2 and own.own_line
        assert own.justification == "own line, justified"

    def test_string_literals_do_not_count(self, pkg):
        src = 's = "# pio: lint-ignore[jit-purity]: inside a string"\n'
        assert pkg.parse_suppressions(src) == ()

    def test_multi_rule_suppression(self, pkg):
        src = "z = 3  # pio: lint-ignore[jit-purity, dtype-discipline]: both\n"
        (sup,) = pkg.parse_suppressions(src)
        assert sup.rule_ids == ("jit-purity", "dtype-discipline")

    def test_parsed_suppressions_equal_jax(self):
        src = (REPO / "tests" / "analysis_fixtures" / "suppress_bad.py").read_text()
        src += ("\nq = 1  # pio: lint-ignore[jit-purity, dtype-discipline]: both\n"
                "# pio: lint-ignore[lock-order]:\n"
                "r = 2\n")
        as_tuple = lambda s: (s.rule_ids, s.line, s.justification, s.own_line)  # noqa: E731
        assert ([as_tuple(s) for s in port_core.parse_suppressions(src)]
                == [as_tuple(s) for s in jax_core.parse_suppressions(src)])

    def test_own_line_suppression_covers_multiline_statement(self, pkg, tmp_path):
        f = tmp_path / "multiline.py"
        f.write_text(
            "import numpy as np\n"
            "# pio: lint-ignore[dtype-discipline]: justified oracle\n"
            "x = np.zeros(\n"
            "    (3,), dtype=np.float64)\n"
        )
        config = pkg.LintConfig(rules={"dtype-discipline": pkg.RuleConfig(paths=("",))})
        assert pkg.lint_paths([str(f)], config=config, rule_ids=["dtype-discipline"]) == []

    def test_trailing_suppression_at_statement_head_covers_continuation(self, pkg, tmp_path):
        f = tmp_path / "head.py"
        f.write_text(
            "import numpy as np\n"
            "x = np.zeros(  # pio: lint-ignore[dtype-discipline]: oracle\n"
            "    (3,), dtype=np.float64)\n"
        )
        config = pkg.LintConfig(rules={"dtype-discipline": pkg.RuleConfig(paths=("",))})
        assert pkg.lint_paths([str(f)], config=config, rule_ids=["dtype-discipline"]) == []

    def test_own_line_suppression_does_not_waive_a_whole_block(self, pkg, tmp_path):
        f = tmp_path / "block.py"
        f.write_text(
            "import numpy as np\n"
            "# pio: lint-ignore[dtype-discipline]: header only\n"
            "def build():\n"
            "    return np.zeros(4, dtype=np.float64)\n"
        )
        config = pkg.LintConfig(rules={"dtype-discipline": pkg.RuleConfig(paths=("",))})
        findings = pkg.lint_paths([str(f)], config=config, rule_ids=["dtype-discipline"])
        assert len(findings) == 1 and findings[0].line == 4


class TestFrameworkSurface:
    def test_rule_registry_is_complete(self, pkg):
        assert set(pkg.all_rules()) >= {
            "resilience-bypass", "jit-purity", "host-sync-in-hot-path",
            "dtype-discipline", "untimed-blocking-io", "lock-discipline",
        }

    def test_unknown_rule_id_raises(self, pkg):
        with pytest.raises(KeyError):
            pkg.lint_paths([os.path.join(FIXTURES, "io_good.py")], rule_ids=["no-such-rule"])

    def test_nonexistent_path_raises(self, pkg):
        with pytest.raises(FileNotFoundError):
            pkg.lint_paths([os.path.join(FIXTURES, "no_such_file.py")])

    def test_overlapping_paths_do_not_double_report(self, pkg, tmp_path):
        sub = tmp_path / "sub"
        sub.mkdir()
        bad = sub / "bad.py"
        bad.write_text("import urllib.request\n"
                       "urllib.request.urlopen('u')\n")
        config = pkg.LintConfig(rules={"untimed-blocking-io": pkg.RuleConfig(paths=("",))})
        findings = pkg.lint_paths([str(tmp_path), str(sub), str(bad)], config=config,
                                  rule_ids=["untimed-blocking-io"])
        assert len(findings) == 1

    def test_unscoped_config_drops_module_keyed_policy(self, pkg, tmp_path):
        f = tmp_path / "postgres.py"
        f.write_text("X = 1\n")
        assert pkg.lint_paths([str(f)], config=pkg.default_config().unscoped()) == []

    def test_findings_carry_file_line_and_rule(self, pkg):
        findings = _run_pkg(pkg, "untimed-blocking-io", "io_bad.py")
        f = findings[0]
        assert f.path == "io_bad.py" and f.line > 0
        assert f.format().startswith("io_bad.py:")
        assert "[untimed-blocking-io]" in f.format()

    def test_parse_error_is_a_finding(self, pkg, tmp_path):
        f = tmp_path / "broken.py"
        f.write_text("def oops(:\n")
        (finding,) = pkg.lint_paths([str(f)])
        assert finding.rule_id == "parse-error" and finding.line == 1


def test_formats_equal_jax():
    """The text and JSON reports of the same findings are the same text;
    SARIF differs only in the tool's information URI."""
    import json

    from predictionio_tpu.analysis.runner import format_findings as jax_format
    from predictionio_tpu_torch.analysis.runner import format_findings as port_format

    paths = [os.path.join(FIXTURES, n) for n in ("io_bad.py", "host_sync_bad.py",
                                                 "locks_bad.py")]
    want = jax_analysis.lint_paths(paths, config=jax_config.default_config().unscoped(),
                                   rel_root=FIXTURES)
    got = port_analysis.lint_paths(paths, config=port_config.default_config().unscoped(),
                                   rel_root=FIXTURES)
    assert want
    assert port_format(got) == jax_format(want)
    assert port_format(got, "json") == jax_format(want, "json")
    jdoc, pdoc = json.loads(jax_format(want, "sarif")), json.loads(port_format(got, "sarif"))
    jdriver, pdriver = jdoc["runs"][0]["tool"]["driver"], pdoc["runs"][0]["tool"]["driver"]
    assert pdriver.pop("informationUri") != jdriver.pop("informationUri")
    assert pdoc == jdoc
    assert port_format([]) == jax_format([]) == "clean: no findings"


def test_analysis_imports_no_jax_torch_or_reference_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import predictionio_tpu_torch.analysis as a\n"
        "for m in pkgutil.walk_packages(a.__path__, a.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'torch', 'predictionio_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=60)
    assert p.returncode == 0, p.stdout + p.stderr
