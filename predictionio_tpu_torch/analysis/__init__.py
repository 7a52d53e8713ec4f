"""`pio lint` — AST-based invariant checking for the serving and compute
paths (a copy of the JAX package's ``analysis/__init__.py``).

The reference PredictionIO leaned on JVM typing and Spark's execution
model to keep framework invariants honest; this Python/PyTorch port
has neither, so the invariants are machine-checked here instead:

- every remote network call routes through the resilience layer
  (``resilience-bypass``)
- jit-compiled functions are pure (``jit-purity``)
- no host-device sync on the request-serving hot path
  (``host-sync-in-hot-path``)
- compute modules stay f32/bf16 (``dtype-discipline``)
- every blocking socket/HTTP call in the serving plane carries a
  timeout (``untimed-blocking-io``)
- state shared with worker threads is lock-protected or documented
  atomic (``lock-discipline`` per file; ``shared-state-race`` across
  modules via the whole-program ProjectModel)
- no two code paths take the same pair of locks in opposite orders
  (``lock-order``, global lock-ordering graph with cycle detection)
- jit entry call sites keep their static/padded-width contracts so the
  ``pio_jit_recompiles`` runtime sentinel stays silent
  (``jit-recompile-risk``)

Public surface: :func:`lint_paths` runs the registered rules over a file
tree and returns :class:`Finding`s (:func:`lint_paths_report` adds a
:class:`LintStats` run report, and project-phase rules see one shared
:class:`ProjectModel`); the ``pio lint`` CLI subcommand and the tier-1
gate (``tests/test_torch_lint_gate.py``) are thin callers. See
docs/static-analysis.md for the rule catalog, the whole-program model,
and suppression syntax
(``# pio: lint-ignore[rule-id]: justification``).
"""

from __future__ import annotations

from predictionio_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    ProjectRule,
    Rule,
    all_rules,
    get_rule,
    register_rule,
)
from predictionio_tpu_torch.analysis.config import LintConfig, default_config
from predictionio_tpu_torch.analysis.runner import (
    LintStats,
    format_findings,
    lint_package,
    lint_package_report,
    lint_paths,
    lint_paths_report,
)
from predictionio_tpu_torch.analysis.project import ProjectModel

# importing the rules package registers the built-in rule suite
import predictionio_tpu_torch.analysis.rules  # noqa: E402,F401  (registration side effect)

__all__ = [
    "Finding",
    "LintConfig",
    "LintStats",
    "ModuleInfo",
    "ProjectModel",
    "ProjectRule",
    "Rule",
    "all_rules",
    "default_config",
    "format_findings",
    "get_rule",
    "lint_package",
    "lint_package_report",
    "lint_paths",
    "lint_paths_report",
    "register_rule",
]
