"""CI-facing output formats: SARIF 2.1.0 and finding baselines
(a copy of the JAX package's ``analysis/report.py``).

A baseline is a JSON snapshot of accepted legacy findings; a run with
``--baseline`` reports (and fails on) only findings NOT in it, so a
stricter rule can land before the tree is fully clean. Fingerprints
are (rule, path, message) — line numbers shift with unrelated edits
and deliberately do not participate.
"""

from __future__ import annotations

import json
from typing import Iterable

from predictionio_tpu_torch.analysis.core import Finding

BASELINE_VERSION = 1


def to_sarif(findings: list[Finding], rule_descriptions: dict[str, str],
             tool_version: str = "0") -> str:
    rules_seen = sorted({f.rule_id for f in findings})
    return json.dumps({
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "pio-lint",
                "version": tool_version,
                "informationUri":
                    "https://example.invalid/predictionio_tpu_torch/docs/static-analysis.md",
                "rules": [
                    {"id": rid,
                     "shortDescription": {
                         "text": rule_descriptions.get(rid, rid)}}
                    for rid in rules_seen
                ],
            }},
            "results": [
                {
                    "ruleId": f.rule_id,
                    "level": "error",
                    "message": {"text": f.message},
                    "locations": [{
                        "physicalLocation": {
                            "artifactLocation": {"uri": f.path},
                            "region": {
                                "startLine": max(f.line, 1),
                                "startColumn": f.col + 1,
                            },
                        },
                    }],
                }
                for f in findings
            ],
        }],
    }, indent=2)


def _fingerprint(f: Finding) -> tuple[str, str, str]:
    return (f.rule_id, f.path, f.message)


def write_baseline(path: str, findings: Iterable[Finding]) -> int:
    items = [
        {"rule": f.rule_id, "path": f.path, "line": f.line,
         "message": f.message}
        for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule_id))
    ]
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": BASELINE_VERSION, "findings": items}, fh,
                  indent=2)
        fh.write("\n")
    return len(items)


def load_baseline(path: str) -> set[tuple[str, str, str]]:
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"unsupported baseline version {doc.get('version')!r} in {path}")
    return {
        (d["rule"], d["path"], d["message"])
        for d in doc.get("findings", ())
    }


def apply_baseline(
    findings: list[Finding], accepted: set[tuple[str, str, str]],
) -> tuple[list[Finding], int]:
    """(new findings, count suppressed by the baseline)."""
    fresh = [f for f in findings if _fingerprint(f) not in accepted]
    return fresh, len(findings) - len(fresh)
