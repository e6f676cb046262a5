"""Allowlist for vetted exceptions of the port's lint (port of
``repro.analyze.allowlist``).

``allowlist.toml`` holds one ``[[allow]]`` table per vetted finding:

    [[allow]]
    rule   = "SL101"                                 # required: rule id
    path   = "src/repro_torch/csrc/shotgun_block.cu" # required: repo path
    match  = "_Z18fused_rounds_kernel"               # optional: substring
    reason = "a known spill, the register lever"     # required

Matching is line-number-free on purpose — line anchors rot with every
edit.  A finding is suppressed when an entry's rule and path match and
``match`` (when present) is a substring of the message.  Entries that
suppress nothing are reported by the CLI so dead exceptions get pruned.

Python 3.10 has no ``tomllib``, so a tiny parser for exactly this subset
(table arrays of ``key = "string"`` pairs, comments, blank lines) backs the
stdlib module when it is missing.  Anything fancier in the file is a lint
configuration error and raises.
"""
from __future__ import annotations

import pathlib
from typing import Iterable, NamedTuple

from repro_torch.analyze.findings import Finding

try:                                    # Python >= 3.11
    import tomllib as _toml
except ImportError:                     # Python 3.10
    _toml = None


class AllowEntry(NamedTuple):
    rule: str
    path: str
    reason: str
    match: str = ""

    def covers(self, f: Finding) -> bool:
        return (f.rule == self.rule and f.path == self.path
                and (not self.match or self.match in f.message))


def _parse_toml_subset(text: str) -> dict:
    """``[[allow]]`` arrays of ``key = "value"`` string pairs, nothing else."""
    out: dict = {"allow": []}
    cur: dict | None = None
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[[allow]]":
            cur = {}
            out["allow"].append(cur)
            continue
        if "=" in line and cur is not None:
            key, _, val = line.partition("=")
            key, val = key.strip(), val.strip()
            # strip a trailing comment outside the quoted value
            if val.startswith('"') and val.count('"') >= 2:
                val = val[1:val.index('"', 1)]
                cur[key] = val
                continue
        raise ValueError(f"allowlist line {ln}: cannot parse {raw!r} "
                         "(only [[allow]] tables of key = \"value\" pairs)")
    return out


def load_allowlist(path: str | pathlib.Path | None) -> list[AllowEntry]:
    if path is None:
        return []
    path = pathlib.Path(path)
    if not path.exists():
        return []
    text = path.read_text()
    if _toml is not None:
        data = _toml.loads(text)
    else:
        data = _parse_toml_subset(text)
    entries = []
    for i, raw in enumerate(data.get("allow", [])):
        missing = {"rule", "path", "reason"} - set(raw)
        if missing:
            raise ValueError(
                f"allowlist entry {i} missing required keys {sorted(missing)}")
        entries.append(AllowEntry(rule=raw["rule"], path=raw["path"],
                                  reason=raw["reason"],
                                  match=raw.get("match", "")))
    return entries


def apply_allowlist(findings: Iterable[Finding],
                    entries: list[AllowEntry]):
    """Split findings into (kept, suppressed); also returns the entries that
    matched nothing so the CLI can flag dead exceptions."""
    kept, suppressed = [], []
    used = [False] * len(entries)
    for f in findings:
        hit = False
        for i, e in enumerate(entries):
            if e.covers(f):
                used[i] = True
                hit = True
        (suppressed if hit else kept).append(f)
    unused = [e for i, e in enumerate(entries) if not used[i]]
    return kept, suppressed, unused
