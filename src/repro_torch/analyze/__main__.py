"""The port's lint CLI (port of ``tools/shotgun_lint.py``).

    python -m repro_torch.analyze --all       # every rule (needs nvcc)
    python -m repro_torch.analyze --ast       # SL001-SL004, no card
    python -m repro_torch.analyze --trace     # SL101-SL103
    python -m repro_torch.analyze --rules SL002,SL103 --root /some/tree

Exit status: 0 when every finding is on the allowlist, 1 on any finding
that is not, 2 on bad usage or when a rule needs a tool this machine lacks
(SL101: ``nvcc`` and ``cuobjdump``).  Output is deterministic —
canonically sorted findings, one per line — so CI can diff it.  There is
no --fix: findings are fixed by hand or vetted into
``src/repro_torch/analyze/allowlist.toml``.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[3]


def main(argv=None) -> int:
    from repro_torch.analyze.runner import (ALL_RULES, DEFAULT_ALLOWLIST,
                                            RULE_TITLES, run_checkers)
    from repro_torch.analyze.trace_checks import MissingTool

    ap = argparse.ArgumentParser(prog="python -m repro_torch.analyze",
                                 description=__doc__.split("\n")[0])
    level = ap.add_mutually_exclusive_group()
    level.add_argument("--all", action="store_true",
                       help="run every rule (default)")
    level.add_argument("--ast", action="store_true",
                       help="source rules only (SL001-SL004; runs nothing)")
    level.add_argument("--trace", action="store_true",
                       help="run rules only (SL101-SL103)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids (overrides the level "
                         "flags), e.g. SL002,SL103")
    ap.add_argument("--root", default=str(REPO),
                    help="tree to check (default: this repository)")
    ap.add_argument("--allowlist", default=None,
                    help="allowlist TOML (default: the package's "
                         "analyze/allowlist.toml; 'none' disables)")
    args = ap.parse_args(argv)

    root = pathlib.Path(args.root).resolve()
    if not root.exists():
        ap.error(f"--root {root} does not exist")
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    elif args.ast:
        rules = [r for r in ALL_RULES if r.startswith("SL0")]
    elif args.trace:
        rules = [r for r in ALL_RULES if r.startswith("SL1")]
    else:
        rules = list(ALL_RULES)
    allowlist = DEFAULT_ALLOWLIST if args.allowlist is None \
        else (None if args.allowlist == "none" else args.allowlist)

    try:
        report = run_checkers(root, rules=rules, allowlist=allowlist)
    except ValueError as e:
        ap.error(str(e))
    except MissingTool as e:
        print(f"python -m repro_torch.analyze: {e}", file=sys.stderr)
        return 2

    for f in report.findings:
        print(f.render())
    for e in report.unused_allows:
        print(f"note: stale allowlist entry (matched nothing): "
              f"rule={e.rule} path={e.path} match={e.match!r}")
    titles = ", ".join(f"{r} {RULE_TITLES[r]}" for r in rules)
    print(f"repro_torch lint: {len(report.findings)} finding(s), "
          f"{len(report.suppressed)} allowlisted, "
          f"{len(report.unused_allows)} stale, over [{titles}]")
    return 1 if report.findings or report.unused_allows else 0


if __name__ == "__main__":
    sys.exit(main())
