"""jit-recompile-risk: static counterpart to the ``pio_jit_recompiles``
runtime sentinel (obs/compile.py)
(a copy of the JAX package's ``analysis/rules/jit_recompile.py``).

The ProjectModel registers every ``@jax.jit`` / ``pjit`` /
``instrumented_jit`` entry point with its static-argument menu
(``static_argnames``/``static_argnums``). At each *resolved* call site
this rule flags:

- a static argument fed a provably per-call-varying Python scalar —
  ``len(...)``, ``.shape[...]``, arithmetic over non-constants,
  ``int()`` of a non-constant — every distinct value compiles a fresh
  program. Values snapped through a width-menu helper (options
  ``snap_calls``, default ``serving_k``/``serving_batch`` — the
  ``ops/topk.BATCH_WIDTHS`` discipline), literals, and UPPERCASE
  constants are accepted; a bare name we cannot trace is NOT flagged
  (documented give-up: better silent than noisy).
- a traced argument built inline from a list/generator comprehension
  via ``asarray``/``array``/``stack`` — its shape varies with the
  comprehension length, recompiling per batch size; pad through the
  width menus instead.

Some jit programs hide behind a cached FACTORY instead of a decorator —
``ops/topk._sharded_topk_fn`` builds its shard_map program keyed on
``(mesh, k, shard_rows)``, so every distinct ``k`` reaching the plain
wrapper ``recommend_topk_sharded`` mints a compile exactly like a
static arg would, invisibly to the decorator scan. The
``extra_entries`` option (function name → list of jit-static parameter
names) extends the same call-site classification over those wrappers.
"""

from __future__ import annotations

import ast
from typing import Any

from predictionio_tpu_torch.analysis.core import Finding, ProjectRule, Rule, register_rule
from predictionio_tpu_torch.analysis.project import FunctionUnit, ProjectModel

_DEFAULT_SNAP_CALLS = ("serving_k", "serving_batch")
_ARRAY_CTORS = ("asarray", "array", "stack")

_OK, _RISKY, _UNKNOWN = "ok", "risky", "unknown"


@register_rule
class JitRecompileRiskRule(ProjectRule):
    rule_id = "jit-recompile-risk"
    description = (
        "per-call-varying static args / shape-varying inline arrays at "
        "jit entry call sites (recompile on every distinct value)"
    )
    default_paths = ("",)

    def check_project(self, project: ProjectModel,
                      options: dict[str, Any]) -> list[Finding]:
        snaps = tuple(options.get("snap_calls", _DEFAULT_SNAP_CALLS))
        findings: list[Finding] = []
        for site in project.jit_call_sites:
            entry = project.jit_entries[site.entry]
            unit = project.functions[site.func]
            bound = self._bind(entry.params, site.node)
            for param, arg in bound:
                if param in entry.static_params:
                    verdict = self._classify(project, unit, arg, snaps, 0)
                    if verdict == _RISKY:
                        findings.append(Finding(
                            self.rule_id, site.module, arg.lineno,
                            f"static parameter '{param}' of jit entry "
                            f"{entry.name}() ({entry.module}) receives a "
                            "per-call-varying value — every distinct value "
                            "compiles a fresh program; snap it to a width "
                            "menu (e.g. ops/topk serving_k/serving_batch) "
                            "or hoist it to a constant",
                            arg.col_offset))
                elif self._shape_varying(arg):
                    findings.append(Finding(
                        self.rule_id, site.module, arg.lineno,
                        f"traced argument of jit entry {entry.name}() "
                        f"({entry.module}) is built inline from a "
                        "comprehension — its shape varies per call, "
                        "recompiling per batch size; pad to a width menu "
                        "(ops/topk BATCH_WIDTHS discipline) first",
                        arg.col_offset))
        extra = {str(name): tuple(statics) for name, statics in
                 (options.get("extra_entries") or {}).items()}
        if extra:
            findings.extend(self._check_extra_entries(project, extra, snaps))
        return findings

    def _check_extra_entries(self, project: ProjectModel,
                             extra: dict[str, tuple[str, ...]],
                             snaps: tuple[str, ...]) -> list[Finding]:
        """Call-site classification for factory-backed jit wrappers
        (module docstring): the wrapper is a plain function, so its
        call edges are in ``unit.calls`` rather than
        ``jit_call_sites``; the configured params compile-key the
        cached program exactly like static args."""
        findings: list[Finding] = []
        for unit in project.functions.values():
            for edge in unit.calls:
                if not isinstance(edge.node, ast.Call):
                    continue                # property-read edge
                if edge.callee in project.jit_entries:
                    continue                # already covered above
                target = project.functions.get(edge.callee)
                if target is None or target.name not in extra:
                    continue
                statics = extra[target.name]
                params = tuple(a.arg for a in
                               (list(target.node.args.posonlyargs)
                                + list(target.node.args.args)))
                for param, arg in self._bind(params, edge.node):
                    if param not in statics:
                        continue
                    if self._classify(project, unit, arg, snaps,
                                      0) == _RISKY:
                        findings.append(Finding(
                            self.rule_id, unit.module, arg.lineno,
                            f"compile-keyed parameter '{param}' of "
                            f"{target.name}() ({target.module}) receives "
                            "a per-call-varying value — the cached jit "
                            "factory behind it compiles a fresh program "
                            "per distinct value; snap it to a width menu "
                            "(e.g. ops/topk serving_k/serving_batch) or "
                            "hoist it to a constant",
                            arg.col_offset))
        return findings

    @staticmethod
    def _bind(params: tuple[str, ...],
              call: ast.Call) -> list[tuple[str, ast.expr]]:
        bound: list[tuple[str, ast.expr]] = []
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                break
            if i < len(params):
                bound.append((params[i], arg))
        for kw in call.keywords:
            if kw.arg is not None:
                bound.append((kw.arg, kw.value))
        return bound

    def _classify(self, project: ProjectModel, unit: FunctionUnit,
                  expr: ast.expr, snaps: tuple[str, ...],
                  depth: int) -> str:
        if depth > 4:
            return _UNKNOWN
        if isinstance(expr, ast.Constant):
            return _OK
        if isinstance(expr, ast.Name):
            if expr.id.isupper():
                return _OK
            if expr.id in project.module_constants.get(unit.mkey, set()):
                return _OK
            src = unit.assigns.get(expr.id)
            if src is not None:
                return self._classify(project, unit, src, snaps, depth + 1)
            return _UNKNOWN
        if isinstance(expr, ast.Attribute):
            if expr.attr.isupper():
                return _OK                      # module.CONSTANT
            if "shape" in (Rule.dotted_name(expr) or "").split("."):
                # a static arg equal to f(input.shape) adds no variation
                # beyond the shape-driven recompiles the array causes anyway
                return _OK
            return _UNKNOWN
        if isinstance(expr, ast.Subscript):
            base = Rule.dotted_name(expr.value) or ""
            if base.endswith("shape") or "shape" in base.split("."):
                return _OK                      # x.shape[0]: see above
            if isinstance(expr.value, ast.Name) and expr.value.id.isupper():
                return _OK                      # WIDTHS[i] menu pick
            return _UNKNOWN
        if isinstance(expr, ast.Call):
            last = (Rule.dotted_name(expr.func) or "").split(".")[-1]
            if self._is_snap(project, unit, expr, last, snaps):
                return _OK
            if last == "len":
                return _RISKY
            if last in ("int", "float", "round"):
                inner = expr.args[0] if expr.args else None
                if inner is None:
                    return _UNKNOWN
                v = self._classify(project, unit, inner, snaps, depth + 1)
                return _OK if v == _OK else v
            if last in ("min", "max"):
                verdicts = [self._classify(project, unit, a, snaps, depth + 1)
                            for a in expr.args]
                if _RISKY in verdicts:
                    return _RISKY
                return _OK if verdicts and all(v == _OK for v in verdicts) \
                    else _UNKNOWN
            return _UNKNOWN                     # might be another snapper
        if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add) \
                and isinstance(expr.right, ast.BinOp) \
                and isinstance(expr.right.op, ast.Mod):
            # the pad-to-multiple idiom ``x + (-x) % m`` — a width menu
            # of multiples of m, not per-call drift
            return _OK
        if isinstance(expr, (ast.BinOp, ast.UnaryOp)):
            parts = ([expr.operand] if isinstance(expr, ast.UnaryOp)
                     else [expr.left, expr.right])
            verdicts = [self._classify(project, unit, p, snaps, depth + 1)
                        for p in parts]
            if all(v == _OK for v in verdicts):
                return _OK
            # arithmetic over anything non-constant drifts per call
            return _RISKY
        if isinstance(expr, ast.IfExp):
            verdicts = [self._classify(project, unit, p, snaps, depth + 1)
                        for p in (expr.body, expr.orelse)]
            if _RISKY in verdicts:
                return _RISKY
            return _OK if all(v == _OK for v in verdicts) else _UNKNOWN
        return _UNKNOWN

    @staticmethod
    def _is_snap(project: ProjectModel, unit: FunctionUnit, call: ast.Call,
                 last: str, snaps: tuple[str, ...]) -> bool:
        """A snap-helper call pins its result to a width menu. Matched
        by trailing name (leading underscores stripped, so a private
        alias like ``_serving_k`` counts) and, when the callee
        resolves, by the resolved function's own name."""
        if last in snaps or last.lstrip("_") in snaps:
            return True
        sym = project._resolve_symbol(
            unit.mkey, Rule.dotted_name(call.func) or "")
        if sym and sym[0] == "func":
            name = sym[1].split(":")[-1].split(".")[-1]
            return name in snaps or name.lstrip("_") in snaps
        return False

    @staticmethod
    def _shape_varying(expr: ast.expr) -> bool:
        if not isinstance(expr, ast.Call):
            return False
        last = (Rule.dotted_name(expr.func) or "").split(".")[-1]
        if last not in _ARRAY_CTORS or not expr.args:
            return False
        return isinstance(expr.args[0], (ast.ListComp, ast.GeneratorExp,
                                         ast.SetComp))
