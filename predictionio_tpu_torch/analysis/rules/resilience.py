"""resilience-bypass: no raw network call may bypass the resilience
layer (utils/resilience.resilient)
(a copy of the JAX package's ``analysis/rules/resilience.py``).

The generalization of a one-off AST test of the storage backends:

- raw network callables (``urlopen``/``create_connection`` by default)
  may appear ONLY inside a module's designated guarded functions;
- guarded functions may be referenced (outside their own ``def``) only
  as arguments of a ``resilient(...)`` call — no direct invocation, no
  aliasing them out;
- constructor guards: a class carrying an unguarded raw call (pgwire's
  ``PGConnection``) may be constructed only inside a named function
  that the reference check above proves is resilient()-routed;
- guard tables must not go stale: every declared guarded site and
  resilient-only function must still exist;
- every module with guarded sites must import the resilience layer.

A module in scope but absent from the guard tables gets the strictest
policy: any raw network call is a violation. New storage backends must
therefore either route through ``resilient()`` or declare their guarded
site in the lint config — exactly the review rule that test encoded by hand.
"""

from __future__ import annotations

import ast
import os
from typing import Any

from predictionio_tpu_torch.analysis.core import Finding, ModuleInfo, Rule, register_rule

DEFAULT_NET_CALLS = ("urlopen", "create_connection")


@register_rule
class ResilienceBypassRule(Rule):
    rule_id = "resilience-bypass"
    description = (
        "raw network calls must sit in guarded functions invoked only "
        "through resilient(...)"
    )
    default_paths = ("storage/",)

    def check(self, module: ModuleInfo, options: dict[str, Any]) -> list[Finding]:
        basename = os.path.basename(module.path)
        net_calls = set(options.get("net_calls", DEFAULT_NET_CALLS))
        guarded_sites: dict = options.get("guarded_sites", {})
        resilient_only: dict = options.get("resilient_only", {})
        ctor_guard: dict = options.get("ctor_guard", {})
        require_import: str = options.get(
            "require_import", "predictionio_tpu_torch.utils.resilience")
        no_import_ok = set(options.get("no_import_ok", ()))

        findings: list[Finding] = []
        allowed = set(guarded_sites.get(basename, ()))

        # 1. raw net calls only inside the guarded functions
        seen_quals: set[str] = set()
        for node, stack in self.walk_with_stack(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = self.call_name(node)
            if name not in net_calls:
                continue
            qual = ".".join(stack) or "<module>"
            seen_quals.add(qual)
            if qual not in allowed:
                findings.append(Finding(
                    self.rule_id, "", node.lineno,
                    f"raw network call {name}() in {qual} — route it "
                    f"through resilient() or declare the guarded site "
                    f"in the lint config", node.col_offset,
                ))
        # stale guard table: every declared site must still exist
        for qual in sorted(allowed - seen_quals):
            findings.append(Finding(
                self.rule_id, "", 1,
                f"stale guard: declared net-call site {qual} makes no "
                f"raw network call — update the lint config",
            ))

        # 2. guarded functions referenced only via resilient(...)
        for name in resilient_only.get(basename, ()):
            refs = [
                node for node in ast.walk(module.tree)
                if (isinstance(node, ast.Attribute) and node.attr == name)
                or (isinstance(node, ast.Name) and node.id == name)
            ]
            if not refs:
                findings.append(Finding(
                    self.rule_id, "", 1,
                    f"stale guard: resilient-only function {name} is "
                    f"never referenced — update the lint config",
                ))
                continue
            for ref in refs:
                if self._is_own_def(module, ref, name):
                    continue
                if not self._inside_resilient(module, ref):
                    findings.append(Finding(
                        self.rule_id, "", ref.lineno,
                        f"{name} referenced outside resilient(...) — "
                        f"direct calls/aliases bypass retry+breaker",
                        ref.col_offset,
                    ))

        # 3. call guards: references to a raw function allowed only from
        # inside named enclosing functions (pgwire's _open_socket may be
        # touched only by PGConnection.__init__, whose construction the
        # ctor guard below routes through the pool's resilient connect)
        call_guard: dict = options.get("call_guard", {})
        for name, allowed_quals in call_guard.get(basename, {}).items():
            allowed_set = set(allowed_quals)
            refs = [
                (node, stack)
                for node, stack in self.walk_with_stack(module.tree)
                if (isinstance(node, ast.Attribute) and node.attr == name)
                or (isinstance(node, ast.Name) and node.id == name)
            ]
            # drop the function's own def subtree (incl. recursion)
            refs = [(n, s) for n, s in refs
                    if not self._is_own_def(module, n, name)]
            if not refs:
                findings.append(Finding(
                    self.rule_id, "", 1,
                    f"stale guard: call-guarded function {name} is never "
                    f"referenced — update the lint config",
                ))
            for node, stack in refs:
                qual = ".".join(stack) or "<module>"
                if qual not in allowed_set:
                    findings.append(Finding(
                        self.rule_id, "", node.lineno,
                        f"{name} referenced from {qual} — only "
                        f"{sorted(allowed_set)} may touch it",
                        node.col_offset,
                    ))

        # 4. constructor guards
        for cls_name, fn_name in ctor_guard.get(basename, {}).items():
            spans = [
                (node.lineno, getattr(node, "end_lineno", node.lineno))
                for node in ast.walk(module.tree)
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name == fn_name
            ]
            ctors = [
                node for node in ast.walk(module.tree)
                if isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == cls_name
            ]
            if not spans:
                findings.append(Finding(
                    self.rule_id, "", 1,
                    f"stale guard: constructor-guard function {fn_name} "
                    f"not found — update the lint config",
                ))
            if not ctors:
                findings.append(Finding(
                    self.rule_id, "", 1,
                    f"stale guard: {cls_name} is never constructed — "
                    f"update the lint config",
                ))
            for node in ctors:
                if not any(lo <= node.lineno <= hi for lo, hi in spans):
                    findings.append(Finding(
                        self.rule_id, "", node.lineno,
                        f"{cls_name} constructed outside {fn_name} — "
                        f"bypasses the connect resilience",
                        node.col_offset,
                    ))

        # 5. the resilience layer must be imported where guards apply
        if (basename in guarded_sites and basename not in no_import_ok
                and require_import not in module.source):
            findings.append(Finding(
                self.rule_id, "", 1,
                f"module does not import the resilience layer "
                f"({require_import})",
            ))
        return findings

    @staticmethod
    def _is_own_def(module: ModuleInfo, ref: ast.AST, name: str) -> bool:
        """The reference IS (or sits inside) the function's own def."""
        for anc in [ref, *module.ancestors(ref)]:
            if (isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and anc.name == name):
                return True
        return False

    @staticmethod
    def _inside_resilient(module: ModuleInfo, ref: ast.AST) -> bool:
        for anc in module.ancestors(ref):
            if (isinstance(anc, ast.Call)
                    and isinstance(anc.func, ast.Name)
                    and anc.func.id == "resilient"):
                return True
        return False
