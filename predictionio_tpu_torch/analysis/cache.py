"""Per-file lint result cache
(a copy of the JAX package's ``analysis/cache.py``).

Entries are keyed by (relpath) and validated against (mtime, size) plus
a run-wide *rules fingerprint* covering the effective rule config AND
the analysis package's own sources — editing a rule invalidates
everything, editing one module invalidates one entry. Only per-module
findings are cached (the project pass is whole-program by definition
and always re-runs), so a warm run pays parse + fact extraction but
skips every per-module rule walk and the suppression tokenize.

The cache is best-effort: unreadable/corrupt files and write failures
degrade to a cold run, never to an error.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Any

from predictionio_tpu_torch.analysis.core import Finding

_VERSION = 1


def default_cache_path(root: str) -> str:
    """~/.cache/pio-lint/<hash-of-root>.json (overridable via
    $PIO_LINT_CACHE_DIR)."""
    base = os.environ.get("PIO_LINT_CACHE_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "pio-lint")
    digest = hashlib.sha256(os.path.abspath(root).encode()).hexdigest()[:12]
    return os.path.join(base, f"{digest}.json")


def rules_fingerprint(config: Any, rule_ids: Any = None) -> str:
    """Hash of the effective rule policy + the analysis package source
    state (any rule/framework edit must invalidate the cache)."""
    h = hashlib.sha256()
    h.update(repr(sorted(
        (rid, rc.enabled, rc.paths, sorted(map(repr, rc.options.items())))
        for rid, rc in config.rules.items())).encode())
    h.update(repr(tuple(config.exclude)).encode())
    h.update(repr(sorted(rule_ids) if rule_ids is not None else None).encode())
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    for dirpath, dirnames, filenames in os.walk(pkg_dir):
        dirnames.sort()
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            fpath = os.path.join(dirpath, fname)
            try:
                st = os.stat(fpath)
            except OSError:
                continue
            rel = os.path.relpath(fpath, pkg_dir)
            h.update(f"{rel}:{st.st_mtime_ns}:{st.st_size};".encode())
    return h.hexdigest()


class LintCache:
    """Load-mutate-save wrapper around one cache file."""

    def __init__(self, path: str, fingerprint: str):
        self.path = path
        self.fingerprint = fingerprint
        self.hits = 0
        self.misses = 0
        self._files: dict[str, dict] = {}
        self._dirty = False
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path, encoding="utf-8") as f:
                doc = json.load(f)
            if (doc.get("version") == _VERSION
                    and doc.get("fingerprint") == self.fingerprint):
                self._files = doc.get("files", {})
        except (OSError, ValueError):
            pass

    def get(self, relpath: str, mtime_ns: int,
            size: int) -> list[Finding] | None:
        entry = self._files.get(relpath)
        if (entry is None or entry.get("mtime_ns") != mtime_ns
                or entry.get("size") != size):
            self.misses += 1
            return None
        self.hits += 1
        return [
            Finding(d["rule"], d["path"], d["line"], d["message"],
                    d.get("col", 0))
            for d in entry.get("findings", ())
        ]

    def put(self, relpath: str, mtime_ns: int, size: int,
            findings: list[Finding]) -> None:
        self._files[relpath] = {
            "mtime_ns": mtime_ns,
            "size": size,
            "findings": [
                {"rule": f.rule_id, "path": f.path, "line": f.line,
                 "col": f.col, "message": f.message}
                for f in findings
            ],
        }
        self._dirty = True

    def save(self) -> None:
        if not self._dirty:
            return
        doc = {"version": _VERSION, "fingerprint": self.fingerprint,
               "files": self._files}
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            fd, tmp = tempfile.mkstemp(
                dir=os.path.dirname(self.path) or ".", suffix=".tmp")
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(doc, f)
            os.replace(tmp, self.path)
        except OSError:
            pass
