"""untimed-blocking-io: every socket/HTTP call in the serving plane
carries a timeout
(a copy of the JAX package's ``analysis/rules/blocking_io.py``).

A handler thread blocked on an un-timed ``urlopen`` (the fire-and-
forget feedback POST, an undeploy probe, a webhook fan-out) holds its
socket — and under ThreadingHTTPServer, a thread — for as long as the
peer cares to stall. The resilience layer bounds retries, but only a
socket-level timeout bounds a single attempt. Default policed calls:
``urlopen`` and ``socket.create_connection``; config may extend (e.g.
``requests``-style ``get``/``post`` if that dependency ever lands).

The timeout may be any expression (config field, constant, deadline
remainder) — it just has to be PASSED. ``timeout=None`` is flagged:
that is the spelled-out version of the bug.

The ``banned_sleep_paths`` option extends the rule to supervision
loops: within the listed paths a bare ``time.sleep`` is a
finding — waits there must ride the injectable
``utils.resilience.Clock`` (``clock.sleep``) or an ``Event.wait``
timeout, or the supervisor/controller backoff and drain schedules
cannot be driven deterministically under ``ManualClock`` and their
child-process ``wait()``/``poll()`` loops become untestable wall-time
spins.
"""

from __future__ import annotations

import ast
from typing import Any

from predictionio_tpu_torch.analysis.core import Finding, ModuleInfo, Rule, register_rule

#: policed call -> 0-based POSITIONAL index of its timeout parameter:
#: urlopen(url, data=None, timeout=...), create_connection(addr, timeout)
DEFAULT_POLICED_CALLS = {"urlopen": 2, "create_connection": 1}


@register_rule
class UntimedBlockingIORule(Rule):
    rule_id = "untimed-blocking-io"
    description = "blocking network calls in the serving plane must set a timeout"
    default_paths = ("api/",)

    def check(self, module: ModuleInfo, options: dict[str, Any]) -> list[Finding]:
        policed = dict(options.get("policed_calls", DEFAULT_POLICED_CALLS))
        # per-call path scoping: a generic method name ("request") may
        # be policed only where it means the fleet transport's exchange
        # — an unrelated wrapper with the same name elsewhere (the ES
        # client's resilient request(), which binds its timeout
        # internally) must not produce findings
        call_paths: dict[str, list[str]] = options.get("call_paths", {})
        from predictionio_tpu_torch.analysis.config import path_matches

        # bare time.sleep ban (module docstring): applies when the
        # module falls under banned_sleep_paths; `from time import
        # sleep` aliases are tracked so renaming cannot dodge the rule
        banned_sleep = tuple(options.get("banned_sleep_paths", ()))
        sleep_banned_here = bool(banned_sleep) and (
            not module.relpath
            or path_matches(module.relpath, banned_sleep))
        sleep_aliases: set[str] = set()
        if sleep_banned_here:
            for node in ast.walk(module.tree):
                if isinstance(node, ast.ImportFrom) \
                        and node.module == "time":
                    for alias in node.names:
                        if alias.name == "sleep":
                            sleep_aliases.add(alias.asname or "sleep")

        findings: list[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            if sleep_banned_here and self._is_bare_sleep(node,
                                                         sleep_aliases):
                findings.append(Finding(
                    self.rule_id, "", node.lineno,
                    "bare time.sleep in a supervision path — waits "
                    "here must use the injectable Clock "
                    "(clock.sleep) or Event.wait so backoff/drain "
                    "schedules stay deterministic under ManualClock",
                    node.col_offset))
                continue
            name = self.call_name(node)
            if name not in policed:
                continue
            scoped = call_paths.get(name)
            if scoped is not None and module.relpath \
                    and not path_matches(module.relpath, tuple(scoped)):
                continue
            timeout = next(
                (kw.value for kw in node.keywords if kw.arg == "timeout"),
                None)
            if timeout is None and len(node.args) > policed[name]:
                timeout = node.args[policed[name]]
            if timeout is None:
                findings.append(Finding(
                    self.rule_id, "", node.lineno,
                    f"{name}() without a timeout — a stalled peer parks "
                    f"this thread forever; pass timeout=<bounded>",
                    node.col_offset))
            elif isinstance(timeout, ast.Constant) and timeout.value is None:
                findings.append(Finding(
                    self.rule_id, "", node.lineno,
                    f"{name}(timeout=None) — explicitly unbounded; pass "
                    f"a finite timeout", node.col_offset))
        return findings

    def _is_bare_sleep(self, node: ast.Call,
                       sleep_aliases: set[str]) -> bool:
        if self.dotted_name(node.func) == "time.sleep":
            return True
        return (isinstance(node.func, ast.Name)
                and node.func.id in sleep_aliases)
