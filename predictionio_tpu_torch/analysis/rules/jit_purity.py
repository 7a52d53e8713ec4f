"""jit-purity: no side effects inside jit-compiled functions
(a copy of the JAX package's ``analysis/rules/jit_purity.py``).

``jax.jit`` traces a function ONCE per input signature; Python side
effects inside the body run at trace time, then silently never again —
a ``print`` that "works" in testing, a ``time.time()`` that freezes at
its trace-time value, a ``random.random()`` constant-folded into the
compiled graph, global/nonlocal mutation that happens once. All are
latent serving bugs, so they are banned outright in the compute
modules. (Use ``jax.debug.print`` / ``jax.debug.callback`` for traced
effects and ``jax.random`` for randomness — both are allowed.)

Detected jit entry points: ``@jax.jit`` / ``@jit`` / ``@pjit`` /
``@instrumented_jit`` (the recompile sentinel's wrapper,
obs/compile.py — it IS jax.jit plus counters, so its bodies are traced
exactly the same) decorators, ``@partial(jax.jit, ...)`` (any alias of
partial), and local functions passed by name to a ``jax.jit(fn)``
call. The whole body including nested defs is policed — everything
inside is traced.
"""

from __future__ import annotations

import ast
from typing import Any

from predictionio_tpu_torch.analysis.core import Finding, ModuleInfo, Rule, register_rule

#: bare-name calls that are always impure host I/O
FORBIDDEN_NAMES = ("print", "open", "input", "breakpoint", "exec", "eval")

#: dotted-prefix call roots that reach host state. ``random.`` is the
#: stdlib module (jax.random/np.random root at jax/np and are checked
#: separately); np.random is host randomness that constant-folds.
FORBIDDEN_PREFIXES = (
    "time.", "random.", "np.random.", "numpy.random.", "os.", "sys.",
    "logging.", "logger.", "builtins.print",
)


#: decorator/callable last-components that mean "this body is traced"
_JIT_NAMES = ("jit", "pjit", "instrumented_jit")


def _decorator_is_jit(dec: ast.expr) -> bool:
    name = Rule.dotted_name(dec)
    if name is not None:
        return name.split(".")[-1] in _JIT_NAMES
    if isinstance(dec, ast.Call):
        fn_name = Rule.dotted_name(dec.func) or ""
        if fn_name.split(".")[-1] in _JIT_NAMES:
            return True
        # partial(jax.jit, ...) under any partial alias
        if fn_name.split(".")[-1].lstrip("_") == "partial" and dec.args:
            inner = Rule.dotted_name(dec.args[0]) or ""
            return inner.split(".")[-1] in _JIT_NAMES
    return False


@register_rule
class JitPurityRule(Rule):
    rule_id = "jit-purity"
    description = "no host side effects inside jit/pjit-compiled functions"
    default_paths = ("ops/", "models/", "e2/")

    def check(self, module: ModuleInfo, options: dict[str, Any]) -> list[Finding]:
        forbidden_names = set(options.get("forbidden_names", FORBIDDEN_NAMES))
        forbidden_prefixes = tuple(
            options.get("forbidden_prefixes", FORBIDDEN_PREFIXES))

        # names wrapped functionally: fn in jax.jit(fn) / jit(fn, ...)
        wrapped_names: set[str] = set()
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            fn_name = self.dotted_name(node.func) or ""
            if fn_name.split(".")[-1] in _JIT_NAMES:
                for arg in node.args[:1]:
                    if isinstance(arg, ast.Name):
                        wrapped_names.add(arg.id)

        findings: list[Finding] = []
        seen: set[ast.AST] = set()
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            jitted = (
                any(_decorator_is_jit(d) for d in node.decorator_list)
                or node.name in wrapped_names
            )
            if not jitted or node in seen:
                continue
            # the whole subtree is traced, nested defs included
            for sub in ast.walk(node):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    seen.add(sub)
                findings.extend(self._check_stmt(node.name, sub, forbidden_names,
                                                 forbidden_prefixes))
        return findings

    def _check_stmt(
        self,
        fn_name: str,
        node: ast.AST,
        forbidden_names: set[str],
        forbidden_prefixes: tuple[str, ...],
    ) -> list[Finding]:
        where = f"inside jit-compiled {fn_name}()"
        if isinstance(node, ast.Global):
            return [Finding(self.rule_id, "", node.lineno,
                            f"global statement {where} — trace-time-only "
                            f"mutation; hoist the state out of the jit")]
        if isinstance(node, ast.Nonlocal):
            return [Finding(self.rule_id, "", node.lineno,
                            f"nonlocal statement {where} — trace-time-only "
                            f"mutation; return the value instead")]
        if not isinstance(node, ast.Call):
            return []
        dotted = self.dotted_name(node.func)
        if dotted in forbidden_names:
            return [Finding(
                self.rule_id, "", node.lineno,
                f"{dotted}() {where} — runs at trace time only; use "
                f"jax.debug.* for traced effects", node.col_offset)]
        if dotted and any(dotted.startswith(p) for p in forbidden_prefixes):
            return [Finding(
                self.rule_id, "", node.lineno,
                f"{dotted}() {where} — host state constant-folds at "
                f"trace time (use jax.random for randomness)",
                node.col_offset)]
        return []
