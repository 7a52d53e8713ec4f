"""shared-state-race: cross-module escape analysis for unsynchronized
attribute sharing between thread contexts
(a copy of the JAX package's ``analysis/rules/shared_state_race.py``).

The per-file ``lock-discipline`` rule only sees ``Thread(target=self.m)``
inside one class; this pass walks the whole-program :class:`ProjectModel`
instead. It resolves every Thread/Timer/submit target (including bound
methods on objects defined in *other* modules and objects escaping
through ``args=``), propagates the thread context through the resolved
call graph, then checks each class attribute that is touched from both
a thread context and the main context:

- a thread-context WRITE with no lock held (and no caller-inherited
  lock) while the attribute is also accessed outside that context is a
  finding at the write;
- thread-context writes all under lock L, but some main-context access
  holds no lock in common with every write site, is a finding at the
  write too (one per attribute — the message lists the unlocked reader)
  so a single justified suppression can document a deliberate
  publication discipline (e.g. the gateway's lock-free table swap).

Pre-publication state is excluded: ``self.x = ...`` inside
``__init__``/``__post_init__`` and accesses through a local name bound
to a constructor call in the same function (the object has not escaped
yet). Wildcard (unresolvable) locks on either side conservatively
count as protection.
"""

from __future__ import annotations

from typing import Any

from predictionio_tpu_torch.analysis.core import Finding, ProjectRule, register_rule
from predictionio_tpu_torch.analysis.project import (
    READ,
    WRITE,
    WILDCARD_LOCK,
    AttrAccess,
    ProjectModel,
    lock_label,
)


def _locks_at(project: ProjectModel, acc: AttrAccess) -> frozenset:
    unit = project.functions[acc.func]
    return project.locks_held_at(unit, acc.node)


@register_rule
class SharedStateRaceRule(ProjectRule):
    rule_id = "shared-state-race"
    description = (
        "attribute written in one thread context and read in another "
        "without a common lock (whole-program escape analysis)"
    )
    default_paths = ("",)

    def check_project(self, project: ProjectModel,
                      options: dict[str, Any]) -> list[Finding]:
        findings: list[Finding] = []
        reach = project.thread_reachable()
        by_class: dict[str, list[AttrAccess]] = {}
        for unit in project.functions.values():
            for acc in unit.accesses:
                if not acc.fresh:
                    by_class.setdefault(acc.cls_key, []).append(acc)

        for cls_key in sorted(by_class):
            per_attr: dict[str, list[AttrAccess]] = {}
            for acc in by_class[cls_key]:
                per_attr.setdefault(acc.attr, []).append(acc)
            for attr in sorted(per_attr):
                f = self._check_attr(project, reach, cls_key, attr,
                                     per_attr[attr])
                if f is not None:
                    findings.append(f)
        return findings

    def _check_attr(self, project: ProjectModel, reach, cls_key: str,
                    attr: str, accesses: list[AttrAccess]) -> Finding | None:
        thread_acc = [a for a in accesses if a.func in reach]
        main_acc = [a for a in accesses if a.func not in reach]
        twrites = sorted((a for a in thread_acc if a.kind == WRITE),
                         key=lambda a: (a.module, a.line))
        if not twrites or not main_acc:
            return None
        # program order inside the spawning function happens-before the
        # thread starts: a main-context access earlier in the very
        # function that performs EVERY spawn reaching these writes is
        # pre-publication setup, not a race
        spawns = {id(reach[w.func]): reach[w.func] for w in twrites}
        main_acc = [
            m for m in main_acc
            if not all(s.func == m.func and m.line < s.line
                       for s in spawns.values())
        ]
        if not main_acc:
            return None
        cls_name = cls_key.split(":")[-1]
        lock_sets = {id(a): _locks_at(project, a) for a in twrites + main_acc}

        def provenance(acc: AttrAccess) -> str:
            spawn = reach[acc.func]
            return f"{spawn.kind} spawned at {spawn.module}:{spawn.line}"

        # case 1: an unlocked thread-context write
        for w in twrites:
            if not lock_sets[id(w)]:
                other = min(main_acc, key=lambda a: (a.module, a.line))
                return Finding(
                    self.rule_id, w.module, w.line,
                    f"{cls_name}.{attr} is written here on a thread "
                    f"context ({provenance(w)}) with no lock held, but "
                    f"is also {'written' if other.kind == WRITE else 'read'}"
                    f" from the main context at {other.module}:{other.line}"
                    " — take a common lock on both sides or document the"
                    " publication discipline with a suppression",
                    w.col)
        # wildcard anywhere on the write side -> assume protected
        if any(WILDCARD_LOCK in lock_sets[id(w)] for w in twrites):
            return None
        # case 2: locked writes, but a main-context access shares no
        # lock with some write site
        for m in sorted(main_acc, key=lambda a: (a.module, a.line)):
            held = lock_sets[id(m)]
            if WILDCARD_LOCK in held:
                continue
            for w in twrites:
                if held & lock_sets[id(w)]:
                    continue
                locks = ", ".join(sorted(lock_label(l) for l in lock_sets[id(w)]))
                return Finding(
                    self.rule_id, w.module, w.line,
                    f"{cls_name}.{attr} is written here under {locks} on a "
                    f"thread context ({provenance(w)}), but "
                    f"{m.module}:{m.line} accesses it from the main context"
                    " without that lock — lock the reader or document the"
                    " lock-free publication discipline with a suppression",
                    w.col)
        return None
