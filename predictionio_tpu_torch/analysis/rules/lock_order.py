"""lock-order: global lock-ordering graph with cycle detection
(a copy of the JAX package's ``analysis/rules/lock_order.py``).

Built from the ProjectModel's lock inventory: every ``with <lock>:``
span contributes edges ``held -> acquired`` — both for lexically nested
acquisitions and for acquisitions reached through resolved calls (the
callee's transitive lock closure), including the caller-holds-the-lock
idiom via inherited locks. A cycle in that digraph means two code paths
can take the same pair of locks in opposite orders: a potential
deadlock between, e.g., the membership lock and a controller tick.

Also flagged: a direct self-deadlock — calling, via ``self``, a method
that re-acquires a non-reentrant lock already held at the call site
(``with self._lock: self.snapshot()`` where ``snapshot`` takes
``self._lock``).

Instance identity is the documented give-up: lock identity is
``(class, attr)``, so call edges through a non-``self`` receiver of
the holder's own class are skipped rather than fabricate a
same-instance ordering that may never occur.
"""

from __future__ import annotations

from typing import Any

from predictionio_tpu_torch.analysis.core import Finding, ProjectRule, register_rule
from predictionio_tpu_torch.analysis.project import (
    WILDCARD_LOCK,
    FunctionUnit,
    ProjectModel,
    lock_label,
)


@register_rule
class LockOrderRule(ProjectRule):
    rule_id = "lock-order"
    description = (
        "lock-ordering cycles and self-deadlocks across the global "
        "lock-acquisition graph"
    )
    default_paths = ("",)

    def check_project(self, project: ProjectModel,
                      options: dict[str, Any]) -> list[Finding]:
        findings: list[Finding] = []
        # edges[(L1, L2)] = first (module, line, detail) that creates it
        edges: dict[tuple, tuple[str, int, str]] = {}

        def add_edge(l1, l2, module, line, detail):
            if l1 == l2 or WILDCARD_LOCK in (l1, l2):
                return
            edges.setdefault((l1, l2), (module, line, detail))

        for key in sorted(project.functions):
            unit = project.functions[key]
            inherited = project.inherited_locks(key)
            for acq in unit.acquires:
                if acq.lock == WILDCARD_LOCK:
                    continue
                held = project.ancestor_locks(unit, acq.node) | inherited
                for h in held:
                    add_edge(h, acq.lock, unit.module, acq.node.lineno,
                             f"acquires {lock_label(acq.lock)} while "
                             f"holding {lock_label(h)}")
            for edge in unit.calls:
                held = project.locks_held_at(unit, edge.node)
                held = {h for h in held if h != WILDCARD_LOCK}
                if not held:
                    continue
                callee_cls = self._callee_class(edge.callee)
                if (not edge.same_instance and unit.cls is not None
                        and callee_cls == unit.cls.key):
                    # same class, possibly different instance: skip
                    # rather than fabricate a same-instance ordering
                    continue
                direct = project.direct_acquires(edge.callee)
                for lock in direct & held:
                    if edge.same_instance and not project.lock_reentrant(lock):
                        findings.append(Finding(
                            self.rule_id, unit.module, edge.node.lineno,
                            f"self-deadlock: this call re-enters "
                            f"{edge.callee.split(':')[-1]}(), which acquires "
                            f"non-reentrant {lock_label(lock)} already held "
                            "here — split out an unlocked helper or use an "
                            "RLock",
                            edge.node.col_offset))
                for lock in project.lock_closure(edge.callee):
                    add_edge_held = held - {lock}
                    for h in add_edge_held:
                        add_edge(h, lock, unit.module, edge.node.lineno,
                                 f"call into {edge.callee.split(':')[-1]}() "
                                 f"acquires {lock_label(lock)} while holding "
                                 f"{lock_label(h)}")

        findings.extend(self._cycles(edges))
        return findings

    @staticmethod
    def _callee_class(callee_key: str) -> str | None:
        mod, _, qual = callee_key.partition(":")
        cls, _, _ = qual.rpartition(".")
        return f"{mod}:{cls}" if cls else None

    def _cycles(self, edges: dict) -> list[Finding]:
        graph: dict[tuple, set] = {}
        for (a, b) in edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        findings: list[Finding] = []
        reported: set[frozenset] = set()
        for start in sorted(graph):
            cycle = self._find_cycle(graph, start)
            if not cycle:
                continue
            key = frozenset(cycle)
            if key in reported:
                continue
            reported.add(key)
            legs = []
            for i, a in enumerate(cycle):
                b = cycle[(i + 1) % len(cycle)]
                mod, line, detail = edges[(a, b)]
                legs.append(f"{detail} ({mod}:{line})")
            mod0, line0, _ = edges[(cycle[0], cycle[1 % len(cycle)])]
            findings.append(Finding(
                self.rule_id, mod0, line0,
                "potential deadlock: lock ordering cycle "
                + " -> ".join(lock_label(l) for l in cycle + [cycle[0]])
                + "; " + "; ".join(legs)
                + " — pick one global order for these locks",
            ))
        return findings

    @staticmethod
    def _find_cycle(graph: dict, start) -> list | None:
        """Shortest cycle through ``start`` (BFS back to start)."""
        frontier = [[start]]
        seen = {start}
        while frontier:
            path = frontier.pop(0)
            for nxt in sorted(graph.get(path[-1], ())):
                if nxt == start:
                    return path
                if nxt not in seen and len(path) < 6:
                    seen.add(nxt)
                    frontier.append(path + [nxt])
        return None
