"""``python -m repro_torch.analysis.lint`` — run reprolint over files/trees.

The partner of ``repro/analysis/lint.py``, with its arguments and exit
codes: exit status 1 iff any non-allowlisted finding remains.  By
default it lints ``src/repro_torch`` and reads the repository's
``.reprolint-allow`` (the reference's format) when the working directory
holds one.

Usage::

    python -m repro_torch.analysis.lint src/repro_torch
    python -m repro_torch.analysis.lint --allowlist .reprolint-allow src/repro_torch
    python -m repro_torch.analysis.lint --list-rules
"""

from __future__ import annotations

import argparse
import pathlib

from .reprolint import RULES, iter_python_files, lint_paths, load_allowlist

DEFAULT_ALLOWLIST = ".reprolint-allow"
DEFAULT_PATHS = ("src/repro_torch",)


def main(argv=None) -> int:
    """CLI entry point: 0 when the paths lint clean, 1 otherwise."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="reprolint: repo-invariant AST lint of the port")
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help="files or directories to lint (default: "
                         f"{' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--allowlist", default=None,
                    help=f"allowlist file of glob::RULE lines "
                         f"(default: {DEFAULT_ALLOWLIST} if present)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule_id in sorted(RULES):
            print(f"{rule_id}  {RULES[rule_id]}")
        return 0

    allow_path = args.allowlist
    if allow_path is None and pathlib.Path(DEFAULT_ALLOWLIST).exists():
        allow_path = DEFAULT_ALLOWLIST
    allowlist = load_allowlist(allow_path) if allow_path else []

    findings = lint_paths(args.paths, allowlist)
    n_files = sum(1 for _ in iter_python_files(args.paths))
    for d in findings:
        print(d.format())
    print(f"reprolint: {n_files} file(s), {len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
