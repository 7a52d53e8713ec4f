"""Framework primitives: findings, rules, registry, suppressions
(a copy of the JAX package's ``analysis/core.py``).

A rule is a class with a stable ``rule_id``, registered via
:func:`register_rule`; the runner hands each rule a parsed
:class:`ModuleInfo` plus that rule's configuration and collects
:class:`Finding`s. Inline suppressions follow the syntax

    # pio: lint-ignore[rule-id]: justification text

either trailing the offending line or on a comment line directly above
it. The justification is REQUIRED — a bare ``lint-ignore`` is itself
reported (rule id ``bad-suppression``), as is one naming a rule that
does not exist. This keeps every waived invariant carrying its reason
in the diff, the way the reference's reviewers carried them in their
heads.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from typing import Any, Callable, Iterable, Iterator

#: framework pseudo-rule for malformed/unknown suppression comments —
#: not in the registry (it cannot be suppressed or disabled)
BAD_SUPPRESSION = "bad-suppression"

_SUPPRESS_RE = re.compile(
    r"#\s*pio:\s*lint-ignore\[(?P<rules>[a-z0-9_,\s-]+)\]"
    r"(?::\s*(?P<why>\S.*))?"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation, pinned to file:line."""

    rule_id: str
    path: str          #: path as given to the runner (repo-relative in CI)
    line: int          #: 1-based
    message: str
    col: int = 0

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule_id}] {self.message}"


@dataclasses.dataclass(frozen=True)
class Suppression:
    """A parsed ``lint-ignore`` comment."""

    rule_ids: tuple[str, ...]
    line: int            #: line the comment sits on
    justification: str   #: empty string when missing (=> bad-suppression)
    own_line: bool       #: comment-only line (suppresses the next code line)


class ModuleInfo:
    """A parsed source file handed to every applicable rule."""

    def __init__(self, path: str, source: str, tree: ast.Module,
                 relpath: str = ""):
        self.path = path
        self.source = source
        self.tree = tree
        #: package-relative path (forward slashes) when linted from a
        #: tree root; "" for ad-hoc single files. Rules with per-call
        #: path scoping (untimed-blocking-io's call_paths) match on it.
        self.relpath = relpath
        self.lines = source.splitlines()
        self._suppressions: tuple[Suppression, ...] | None = None
        self._parents: dict[ast.AST, ast.AST] | None = None
        self._stmt_ends: dict[int, int] | None = None

    @property
    def suppressions(self) -> tuple["Suppression", ...]:
        """Parsed lint-ignore comments, tokenized lazily: a warm cached
        run only pays the tokenize cost for modules that actually have
        project-pass findings to filter."""
        if self._suppressions is None:
            self._suppressions = parse_suppressions(self.source)
        return self._suppressions

    @property
    def parents(self) -> dict[ast.AST, ast.AST]:
        """child AST node -> parent, built lazily once per module."""
        if self._parents is None:
            self._parents = {
                child: parent
                for parent in ast.walk(self.tree)
                for child in ast.iter_child_nodes(parent)
            }
        return self._parents

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = node
        while cur in self.parents:
            cur = self.parents[cur]
            yield cur

    def _stmt_end(self, start: int) -> int:
        """Last physical line a suppression anchored at ``start`` covers.

        For a simple statement that is its full span — findings anchor
        to continuation lines (a ``dtype=`` keyword on line 2 of a
        call) and the waiver must reach them. For a COMPOUND statement
        (def/class/if/for/with/try) only the header is covered, up to
        the first body statement: one comment above a function must
        never silently waive every current and future violation inside
        its 100-line body."""
        if self._stmt_ends is None:
            self._stmt_ends = {}
            for node in ast.walk(self.tree):
                if not isinstance(node, ast.stmt):
                    continue
                body = getattr(node, "body", None)
                if isinstance(body, list) and body and isinstance(body[0], ast.stmt):
                    end = max(node.lineno, body[0].lineno - 1)
                else:
                    end = getattr(node, "end_lineno", node.lineno)
                self._stmt_ends[node.lineno] = max(
                    self._stmt_ends.get(node.lineno, 0), end)
        return self._stmt_ends.get(start, start)

    def suppressed_lines(self, rule_id: str) -> set[int]:
        """Code lines waived for ``rule_id`` (with a justification).

        A trailing suppression covers its own line — and, when that
        line STARTS a statement, the statement's continuation lines
        too (same span rule as own-line comments, so suppressing at
        the statement head always works)."""
        lines: set[int] = set()
        for sup in self.suppressions:
            if rule_id not in sup.rule_ids or not sup.justification:
                continue
            lines.add(sup.line)
            start = (_next_code_line(self.lines, sup.line)
                     if sup.own_line else sup.line)
            if start > 0:
                lines.update(range(start, self._stmt_end(start) + 1))
        return lines


def parse_suppressions(source: str) -> tuple[Suppression, ...]:
    """Tokenize-based scan so strings containing the magic text don't
    count — only real comments do."""
    found: list[Suppression] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return ()
    code_lines = {
        t.start[0]
        for t in tokens
        if t.type not in (
            tokenize.COMMENT, tokenize.NL, tokenize.NEWLINE,
            tokenize.INDENT, tokenize.DEDENT, tokenize.ENCODING,
            tokenize.ENDMARKER,
        )
    }
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        rule_ids = tuple(
            r.strip() for r in m.group("rules").split(",") if r.strip()
        )
        found.append(Suppression(
            rule_ids=rule_ids,
            line=tok.start[0],
            justification=(m.group("why") or "").strip(),
            own_line=tok.start[0] not in code_lines,
        ))
    return tuple(found)


def _next_code_line(lines: list[str], after: int) -> int:
    """First non-blank, non-comment line after ``after`` (1-based)."""
    for i in range(after, len(lines)):
        text = lines[i].strip()
        if text and not text.startswith("#"):
            return i + 1
    return -1


def suppression_findings(module: ModuleInfo, path: str) -> list[Finding]:
    """Framework-level findings: lint-ignore comments that are missing
    their justification or name an unknown rule."""
    findings: list[Finding] = []
    for sup in module.suppressions:
        if not sup.justification:
            findings.append(Finding(
                BAD_SUPPRESSION, path, sup.line,
                "lint-ignore requires a justification: "
                "`# pio: lint-ignore[rule]: why this is safe`",
            ))
        for rid in sup.rule_ids:
            if rid not in _REGISTRY:
                findings.append(Finding(
                    BAD_SUPPRESSION, path, sup.line,
                    f"lint-ignore names unknown rule {rid!r} "
                    f"(known: {', '.join(sorted(_REGISTRY))})",
                ))
    return findings


class Rule:
    """Base class for a lint rule.

    Subclasses set ``rule_id``/``description``/``default_paths`` and
    implement :meth:`check`. ``default_paths`` are package-relative
    prefixes ('' means the whole tree) that scope where the rule runs;
    per-run config may override them (see config.LintConfig).
    """

    rule_id: str = ""
    description: str = ""
    #: package-relative path prefixes this rule applies to by default
    default_paths: tuple[str, ...] = ("",)

    def check(self, module: ModuleInfo, options: dict[str, Any]) -> list[Finding]:
        raise NotImplementedError

    # -- shared AST helpers (used by several rules) --------------------------

    @staticmethod
    def call_name(node: ast.Call) -> str | None:
        """Trailing name of the called object: ``urlopen`` for both
        ``urlopen(...)`` and ``urllib.request.urlopen(...)``."""
        if isinstance(node.func, ast.Attribute):
            return node.func.attr
        if isinstance(node.func, ast.Name):
            return node.func.id
        return None

    @staticmethod
    def dotted_name(node: ast.AST) -> str | None:
        """``a.b.c`` for nested Attribute/Name chains, else None."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
            return ".".join(reversed(parts))
        return None

    @staticmethod
    def walk_with_stack(
        tree: ast.AST,
    ) -> Iterator[tuple[ast.AST, tuple[str, ...]]]:
        """Yield (node, enclosing def/class qualname stack) pairs."""

        def visit(node: ast.AST, stack: tuple[str, ...]):
            yield node, stack
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                stack = stack + (node.name,)
            for child in ast.iter_child_nodes(node):
                yield from visit(child, stack)

        yield from visit(tree, ())


class ProjectRule(Rule):
    """A rule with a whole-program pass.

    The runner builds one :class:`analysis.project.ProjectModel` from
    every parsed module in the run and hands it to
    :meth:`check_project` AFTER the per-module phase. Findings must
    carry the package-relative ``path`` of the module they anchor to —
    the runner applies that module's suppressions and the rule's path
    scope to them exactly as it does for per-module findings.

    ``check`` defaults to no per-module findings so a ProjectRule can
    be purely global; hybrids may implement both.
    """

    def check(self, module: ModuleInfo, options: dict[str, Any]) -> list[Finding]:
        return []

    def check_project(self, project: "Any",
                      options: dict[str, Any]) -> list[Finding]:
        raise NotImplementedError


_REGISTRY: dict[str, Rule] = {}


def register_rule(cls: type[Rule]) -> type[Rule]:
    """Class decorator adding an instance to the global registry."""
    if not cls.rule_id:
        raise ValueError(f"{cls.__name__} has no rule_id")
    if cls.rule_id == BAD_SUPPRESSION:
        raise ValueError(f"rule id {BAD_SUPPRESSION!r} is reserved")
    if cls.rule_id in _REGISTRY:
        raise ValueError(f"duplicate rule id {cls.rule_id!r}")
    _REGISTRY[cls.rule_id] = cls()
    return cls


def all_rules() -> dict[str, Rule]:
    return dict(_REGISTRY)


def get_rule(rule_id: str) -> Rule:
    return _REGISTRY[rule_id]
