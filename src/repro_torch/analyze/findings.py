"""Finding schema shared by every port lint checker (port of
``repro.analyze.findings``).

A checker reports a flat list of ``Finding`` records — (path, line, rule,
severity, message) — and nothing else: no fix mode, no mutable state, no
wall-clock.  ``sort_findings`` imposes the one canonical order (path, line,
rule, message), so two runs over the same tree emit byte-identical reports
and CI can diff the output.
"""
from __future__ import annotations

from typing import Iterable, NamedTuple

SEVERITIES = ("error", "warning")


class Finding(NamedTuple):
    path: str       # repo-relative posix path ("src/repro_torch/core/cdn.py")
    line: int       # 1-based; 0 when the finding has no source anchor
    rule: str       # "SL001" ... "SL103"
    severity: str   # "error" | "warning"
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.severity}: " \
               f"{self.message}"


def sort_findings(findings: Iterable[Finding]) -> list[Finding]:
    """The canonical deterministic order: path, then line, rule, message."""
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule, f.message))


def render_report(findings: Iterable[Finding]) -> str:
    return "\n".join(f.render() for f in sort_findings(findings))
