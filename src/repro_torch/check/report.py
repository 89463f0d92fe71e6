"""Findings and the two output renderers (text, JSON), as in
``repro/check/report.py``.

A ``Finding`` is one rule violation at one source location.  Rule ids are
stable API: CI artifacts, suppression comments and the golden fixture
tests all key on them, so renaming one is a breaking change.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"


def render_text(findings: List[Finding]) -> str:
    """One ``path:line:col: RULE message`` row per finding + a summary."""
    rows = [f"{f.location()}: {f.rule} {f.message}" for f in findings]
    n = len(findings)
    rows.append(f"{n} finding{'s' if n != 1 else ''}")
    return "\n".join(rows)


def render_json(findings: List[Finding],
                rule_index: Dict[str, str]) -> str:
    """Machine-readable report: the findings plus the registered-rule
    index (id -> one-line title), so a consumer can tell "rule absent"
    from "rule clean"."""
    payload = {
        "version": 1,
        "rules": dict(sorted(rule_index.items())),
        "count": len(findings),
        "findings": [dataclasses.asdict(f) for f in findings],
    }
    return json.dumps(payload, indent=1, sort_keys=False)
