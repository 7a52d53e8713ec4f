"""Run the registered rules over a file tree and collect findings
(a copy of the JAX package's ``analysis/runner.py``).

The runner owns everything rule-independent: file discovery, parsing,
per-file result caching, path scoping, suppression filtering, the
two-phase schedule (per-module rules, then project rules over one
shared :class:`ProjectModel`), and report formatting. Rules see one
:class:`ModuleInfo` — or the whole ProjectModel — and never touch the
filesystem.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import time
from typing import Iterable

from predictionio_tpu_torch.analysis.cache import LintCache
from predictionio_tpu_torch.analysis.config import LintConfig, default_config, path_matches
from predictionio_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    ProjectRule,
    suppression_findings,
)


def _iter_py_files(path: str) -> Iterable[str]:
    if not os.path.exists(path):
        # a typo'd CI hook must fail loudly, not lint zero files "clean"
        raise FileNotFoundError(f"lint path does not exist: {path}")
    if os.path.isfile(path):
        yield path
        return
    for dirpath, dirnames, filenames in os.walk(path):
        dirnames.sort()
        for fname in sorted(filenames):
            if fname.endswith(".py"):
                yield os.path.join(dirpath, fname)


@dataclasses.dataclass
class LintStats:
    """Machine-readable run report (`--format json` carries it)."""

    files: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    parse_s: float = 0.0
    module_rules_s: float = 0.0
    project_rules_s: float = 0.0
    total_s: float = 0.0
    #: project-phase rules that actually ran
    project_rules: list[str] = dataclasses.field(default_factory=list)
    module_rules: list[str] = dataclasses.field(default_factory=list)
    changed_scope: list[str] | None = None

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for k in ("parse_s", "module_rules_s", "project_rules_s", "total_s"):
            d[k] = round(d[k], 4)
        return d


def lint_paths(
    paths: Iterable[str],
    config: LintConfig | None = None,
    rel_root: str | None = None,
    rule_ids: Iterable[str] | None = None,
    cache: LintCache | None = None,
    project: bool = True,
    changed: set[str] | None = None,
) -> list[Finding]:
    """Lint ``paths`` (files or trees), scoping rules by path relative
    to ``rel_root`` (default: each argument itself). ``rule_ids``
    restricts the run to a subset of enabled rules; ``changed``
    restricts *reported* findings to those package-relative paths (the
    whole tree is still parsed so project passes see every module)."""
    findings, _ = lint_paths_report(
        paths, config=config, rel_root=rel_root, rule_ids=rule_ids,
        cache=cache, project=project, changed=changed)
    return findings


def lint_paths_report(
    paths: Iterable[str],
    config: LintConfig | None = None,
    rel_root: str | None = None,
    rule_ids: Iterable[str] | None = None,
    cache: LintCache | None = None,
    project: bool = True,
    changed: set[str] | None = None,
) -> tuple[list[Finding], LintStats]:
    """:func:`lint_paths` plus a :class:`LintStats` run report."""
    t_start = time.monotonic()
    config = config or default_config()
    rules = config.enabled_rules()
    if rule_ids is not None:
        wanted = set(rule_ids)
        unknown = wanted - set(rules)
        if unknown:
            raise KeyError(f"unknown/disabled rule(s): {sorted(unknown)}")
        rules = {rid: r for rid, r in rules.items() if rid in wanted}
    module_rules = {rid: r for rid, r in rules.items()
                    if not isinstance(r, ProjectRule)}
    project_rules = {rid: r for rid, r in rules.items()
                     if isinstance(r, ProjectRule)}

    stats = LintStats(
        module_rules=sorted(module_rules),
        project_rules=sorted(project_rules) if project else [],
        changed_scope=sorted(changed) if changed is not None else None,
    )
    findings: list[Finding] = []
    modules: dict[str, ModuleInfo] = {}
    seen_files: set[str] = set()
    for top in paths:
        base = rel_root or (top if os.path.isdir(top) else os.path.dirname(top))
        for fpath in _iter_py_files(top):
            real = os.path.realpath(fpath)
            if real in seen_files:
                continue  # overlapping path args must not double-report
            seen_files.add(real)
            relpath = os.path.relpath(fpath, base).replace(os.sep, "/")
            if path_matches(relpath, config.exclude):
                continue
            t0 = time.monotonic()
            try:
                st = os.stat(fpath)
                with open(fpath, encoding="utf-8") as f:
                    source = f.read()
                tree = ast.parse(source, filename=fpath)
            except (SyntaxError, UnicodeDecodeError) as exc:
                findings.append(Finding(
                    "parse-error", relpath,
                    getattr(exc, "lineno", 0) or 0,
                    f"could not parse: {exc}",
                ))
                continue
            module = ModuleInfo(fpath, source, tree, relpath=relpath)
            modules[relpath] = module
            stats.files += 1
            stats.parse_s += time.monotonic() - t0

            t0 = time.monotonic()
            cached = (cache.get(relpath, st.st_mtime_ns, st.st_size)
                      if cache is not None else None)
            if cached is not None:
                findings.extend(cached)
            else:
                per_file = list(suppression_findings(module, relpath))
                for rule in module_rules.values():
                    if not path_matches(relpath, config.rule_paths(rule)):
                        continue
                    raw = rule.check(module, config.rule_options(rule))
                    waived = module.suppressed_lines(rule.rule_id)
                    per_file.extend(
                        Finding(rule.rule_id, relpath, f.line, f.message, f.col)
                        for f in raw
                        if f.line not in waived
                    )
                if cache is not None:
                    cache.put(relpath, st.st_mtime_ns, st.st_size, per_file)
                findings.extend(per_file)
            stats.module_rules_s += time.monotonic() - t0
    if cache is not None:
        stats.cache_hits, stats.cache_misses = cache.hits, cache.misses
        cache.save()

    if project and project_rules and modules:
        from predictionio_tpu_torch.analysis.project import ProjectModel

        t0 = time.monotonic()
        model = ProjectModel(modules)
        for rule in project_rules.values():
            raw = rule.check_project(model, config.rule_options(rule))
            for f in raw:
                if not path_matches(f.path, config.rule_paths(rule)):
                    continue
                mod = modules.get(f.path)
                if mod is not None and f.line in mod.suppressed_lines(rule.rule_id):
                    continue
                findings.append(Finding(rule.rule_id, f.path, f.line,
                                        f.message, f.col))
        stats.project_rules_s += time.monotonic() - t0

    if changed is not None:
        findings = [f for f in findings if f.path in changed]
    findings.sort(key=lambda f: (f.path, f.line, f.rule_id))
    stats.total_s = time.monotonic() - t_start
    return findings, stats


def lint_package(
    package_dir: str | None = None,
    config: LintConfig | None = None,
    rule_ids: Iterable[str] | None = None,
    cache: LintCache | None = None,
    project: bool = True,
    changed: set[str] | None = None,
) -> list[Finding]:
    """Lint the installed ``predictionio_tpu_torch`` package with the repo
    policy — what `pio lint` and the tier-1 gate run."""
    findings, _ = lint_package_report(
        package_dir, config=config, rule_ids=rule_ids, cache=cache,
        project=project, changed=changed)
    return findings


def lint_package_report(
    package_dir: str | None = None,
    config: LintConfig | None = None,
    rule_ids: Iterable[str] | None = None,
    cache: LintCache | None = None,
    project: bool = True,
    changed: set[str] | None = None,
) -> tuple[list[Finding], LintStats]:
    if package_dir is None:
        import predictionio_tpu_torch

        package_dir = os.path.dirname(predictionio_tpu_torch.__file__)
    return lint_paths_report(
        [package_dir], config=config, rel_root=package_dir,
        rule_ids=rule_ids, cache=cache, project=project, changed=changed)


def format_findings(findings: list[Finding], fmt: str = "text",
                    stats: LintStats | None = None) -> str:
    if fmt == "json":
        items = [
            {
                "rule": f.rule_id,
                "path": f.path,
                "line": f.line,
                "col": f.col,
                "message": f.message,
            }
            for f in findings
        ]
        if stats is None:
            return json.dumps(items, indent=2)
        return json.dumps({"findings": items, "stats": stats.as_dict()},
                          indent=2)
    if fmt == "sarif":
        from predictionio_tpu_torch.analysis.core import all_rules
        from predictionio_tpu_torch.analysis.report import to_sarif

        descriptions = {rid: r.description for rid, r in all_rules().items()}
        return to_sarif(findings, descriptions)
    out = [f.format() for f in findings]
    n = len(findings)
    out.append(f"{n} finding{'s' if n != 1 else ''}" if n else "clean: no findings")
    return "\n".join(out)
