"""The port's lint driver: rule registry and one entry point over both
levels (port of ``repro.analyze.runner``).

``run_checkers(root, ...)`` runs the requested rules, applies the
allowlist, and returns a ``LintReport`` that the CLI, ``chip_smoke.py``
and the tests all consume.  Source rules (SL0xx) never import the checked
code; run rules (SL1xx) build it, import it and run it — the
``repro_torch`` that is imported, whose ``csrc`` SL101 builds when the
root is this repository.
"""
from __future__ import annotations

import pathlib
from typing import Iterable, NamedTuple

from repro_torch.analyze.allowlist import (AllowEntry, apply_allowlist,
                                           load_allowlist)
from repro_torch.analyze.ast_checks import AST_RULES, run_ast_checks
from repro_torch.analyze.findings import Finding, sort_findings

ALL_RULES = ("SL001", "SL002", "SL003", "SL004", "SL101", "SL102", "SL103")

RULE_TITLES = {
    "SL001": "host sync inside a round",
    "SL002": "f32 accumulation",
    "SL003": "bare shape assert",
    "SL004": "raw exp/log in kernels",
    "SL101": "resource budget",
    "SL102": "repeat-call leak",
    "SL103": "process-group consistency",
}

DEFAULT_ALLOWLIST = pathlib.Path(__file__).resolve().parent \
    / "allowlist.toml"


class LintReport(NamedTuple):
    findings: list        # unallowlisted, canonically sorted
    suppressed: list      # findings an allowlist entry vetted
    unused_allows: list   # AllowEntry rows that matched nothing (stale)

    @property
    def ok(self) -> bool:
        return not self.findings


def split_rules(rules: Iterable[str]):
    """(ast_rules, trace_rules) — unknown ids raise."""
    ast_r, trace_r = [], []
    for r in rules:
        if r in AST_RULES:
            ast_r.append(r)
        elif r.startswith("SL1") and r in ALL_RULES:
            trace_r.append(r)
        else:
            raise ValueError(f"unknown rule {r!r}; choose from {ALL_RULES}")
    return ast_r, trace_r


def run_checkers(root: str | pathlib.Path,
                 rules: Iterable[str] | None = None,
                 allowlist: str | pathlib.Path | None = DEFAULT_ALLOWLIST,
                 ) -> LintReport:
    root = pathlib.Path(root).resolve()
    rules = list(rules) if rules is not None else list(ALL_RULES)
    ast_rules, trace_rules = split_rules(rules)

    findings: list[Finding] = []
    if ast_rules:
        findings.extend(run_ast_checks(root, ast_rules))
    if trace_rules:
        # deferred: it builds and runs the checked code, which source-only
        # runs skip
        from repro_torch.analyze.trace_checks import run_trace_checks
        findings.extend(run_trace_checks(root, trace_rules))

    entries: list[AllowEntry] = load_allowlist(allowlist)
    kept, suppressed, unused = apply_allowlist(findings, entries)
    # only count an entry stale against the rules that actually ran
    unused = [e for e in unused if e.rule in rules]
    return LintReport(findings=sort_findings(kept),
                      suppressed=sort_findings(suppressed),
                      unused_allows=unused)
