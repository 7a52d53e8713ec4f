"""lock-discipline: heuristic race detector for handler/worker threads
(a copy of the JAX package's ``analysis/rules/locks.py``).

The reference serialized shared state through Akka actors; here worker
threads (query batcher dispatcher, plugin sniffer drains, feedback
posts) share plain Python objects with handler threads. The rule finds
instance attributes WRITTEN from a ``threading.Thread`` target (or any
same-class method the target transitively calls via ``self.m()``) and
demands one of:

- the write sits under a ``with <...lock...>:`` block (any context
  manager whose expression mentions "lock"), AND every same-class read
  outside the thread's call tree is likewise protected; or
- the attribute is documented atomic via a suppression with
  justification (single-writer counters read for stats can say so).

Private attributes (leading underscore) written by the thread are only
flagged when some other method of the class actually reads them
unprotected; PUBLIC attributes are part of the object's API, presumed
read externally, and must be protected or documented at the write
site. This is deliberately a heuristic — it catches the shape of race
that actually bit this codebase (unsynchronized stats counters,
state flags flipped across threads), not every aliasing pattern.
"""

from __future__ import annotations

import ast
from typing import Any

from predictionio_tpu_torch.analysis.core import Finding, ModuleInfo, Rule, register_rule


def _is_thread_ctor(node: ast.Call) -> bool:
    dotted = Rule.dotted_name(node.func) or ""
    return dotted.split(".")[-1] == "Thread"


def _with_protects(module: ModuleInfo, node: ast.AST) -> bool:
    """Any ancestor `with` whose context expression mentions a lock."""
    for anc in module.ancestors(node):
        if isinstance(anc, ast.With):
            for item in anc.items:
                if "lock" in ast.unparse(item.context_expr).lower():
                    return True
    return False


@register_rule
class LockDisciplineRule(Rule):
    rule_id = "lock-discipline"
    description = (
        "attributes written from worker threads must be lock-protected "
        "at writer and readers, or documented atomic"
    )
    default_paths = ("",)

    def check(self, module: ModuleInfo, options: dict[str, Any]) -> list[Finding]:
        findings: list[Finding] = []
        for cls in ast.walk(module.tree):
            if isinstance(cls, ast.ClassDef):
                findings.extend(self._check_class(module, cls))
        return findings

    # -- per-class analysis --------------------------------------------------
    def _check_class(self, module: ModuleInfo, cls: ast.ClassDef) -> list[Finding]:
        methods = {
            n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        targets = self._thread_target_methods(cls, methods)
        if not targets:
            return []
        # expand through self.m() calls: everything the thread reaches
        reachable = set(targets)
        work = list(targets)
        while work:
            fn = methods[work.pop()]
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "self"
                        and node.func.attr in methods
                        and node.func.attr not in reachable):
                    reachable.add(node.func.attr)
                    work.append(node.func.attr)

        # attribute writes inside the thread's call tree
        writes: dict[str, list[ast.AST]] = {}
        for name in reachable:
            for node in ast.walk(methods[name]):
                attr = self._self_attr_store(node)
                if attr is not None:
                    writes.setdefault(attr, []).append(node)

        findings: list[Finding] = []
        for attr, sites in sorted(writes.items()):
            unprotected_writes = [
                n for n in sites if not _with_protects(module, n)]
            # reads of self.<attr> from methods OUTSIDE the thread tree
            outside_reads = []
            for name, fn in methods.items():
                if name in reachable:
                    continue
                for node in ast.walk(fn):
                    if (isinstance(node, ast.Attribute)
                            and isinstance(node.ctx, ast.Load)
                            and node.attr == attr
                            and isinstance(node.value, ast.Name)
                            and node.value.id == "self"):
                        outside_reads.append(node)
            shared = bool(outside_reads) or not attr.startswith("_")
            if not shared:
                continue
            for node in unprotected_writes:
                why = (f"read by {len(outside_reads)} same-class site(s)"
                       if outside_reads else "public attribute")
                findings.append(Finding(
                    self.rule_id, "", node.lineno,
                    f"{cls.name}.{attr} written from a thread target "
                    f"without holding a lock ({why}) — guard both sides "
                    f"with one lock, or suppress documenting why the "
                    f"access is atomic", getattr(node, "col_offset", 0)))
            if not unprotected_writes:
                # writer is disciplined; readers must be too
                for node in outside_reads:
                    if not _with_protects(module, node):
                        findings.append(Finding(
                            self.rule_id, "", node.lineno,
                            f"{cls.name}.{attr} is lock-protected at its "
                            f"thread-side writer but read here without "
                            f"the lock — torn/stale reads",
                            node.col_offset))
        return findings

    @staticmethod
    def _thread_target_methods(
        cls: ast.ClassDef, methods: dict[str, ast.AST],
    ) -> set[str]:
        """Methods of ``cls`` used as Thread(target=self.<m>)."""
        out: set[str] = set()
        for node in ast.walk(cls):
            if not (isinstance(node, ast.Call) and _is_thread_ctor(node)):
                continue
            for kw in node.keywords:
                if (kw.arg == "target"
                        and isinstance(kw.value, ast.Attribute)
                        and isinstance(kw.value.value, ast.Name)
                        and kw.value.value.id == "self"
                        and kw.value.attr in methods):
                    out.add(kw.value.attr)
        return out

    @staticmethod
    def _self_attr_store(node: ast.AST) -> str | None:
        """'attr' when node stores to self.attr (assign/augassign)."""
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            if (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                return t.attr
        return None
