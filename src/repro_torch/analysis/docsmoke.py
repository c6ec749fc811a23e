"""docsmoke — execute the documentation's Python snippets.

The partner of ``repro/analysis/docsmoke.py``, standard library only,
with its extraction, skip marker, shared namespace and CLI.
Documentation that cannot run is documentation that has already
drifted.  This module extracts every fenced ```python`` block from the
markdown it is given and executes it, so a run fails the moment a
quickstart or runbook snippet stops matching the code.  By default it runs the port's own guide,
``docs/port.md``, whose snippets import ``repro_torch`` alone and run on
the CPU with ``device="cpu"``; the reference's docs (README plus
``docs/``) are ``repro.analysis.docsmoke``'s, and would load the JAX
package into this process.

Contract:

* Blocks in one file run **in order and share one namespace**, so a
  document can build state across snippets the way a reader would type
  them (imports in the first block, usage in the next).
* A block is skipped when the line *immediately above its opening
  fence* is ``<!-- docsmoke: skip -->`` — for illustrative fragments
  (shell output, pseudo-code, intentionally-failing examples).
* Only ```` ```python ```` fences run; bare ``` fences and other
  languages are prose.
* Any exception fails the run with the markdown file and the line the
  block opened on, plus the traceback — exit 1 from the CLI.

CLI::

    PYTHONPATH=src python -m repro_torch.analysis.docsmoke     # docs/port.md
    PYTHONPATH=src python -m repro_torch.analysis.docsmoke README.md docs
"""

from __future__ import annotations

import argparse
import pathlib
import re
import sys
import traceback
from dataclasses import dataclass

__all__ = ["Snippet", "extract_snippets", "run_file", "run_paths", "main"]

_FENCE_OPEN = re.compile(r"^\s*```python\s*$")
_FENCE_CLOSE = re.compile(r"^\s*```\s*$")
_SKIP_MARK = re.compile(r"<!--\s*docsmoke:\s*skip\s*-->")

#: default corpus: the port's guide
DEFAULT_PATHS = ("docs/port.md",)


@dataclass(frozen=True)
class Snippet:
    """One fenced ```python`` block: its source text, the markdown file
    it came from, and the 1-based line of its opening fence (what the
    failure report points at)."""

    path: str
    line: int
    source: str


def extract_snippets(text: str, path: str) -> list[Snippet]:
    """All runnable ```python`` blocks of one markdown document, in
    order.  A ``<!-- docsmoke: skip -->`` on the line directly above a
    fence drops that block."""
    snippets: list[Snippet] = []
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        if _FENCE_OPEN.match(lines[i]):
            skipped = i > 0 and bool(_SKIP_MARK.search(lines[i - 1]))
            start = i + 1
            j = start
            while j < len(lines) and not _FENCE_CLOSE.match(lines[j]):
                j += 1
            if not skipped:
                snippets.append(Snippet(path=path, line=i + 1,
                                        source="\n".join(lines[start:j])))
            i = j + 1
        else:
            i += 1
    return snippets


def run_file(path: pathlib.Path, verbose: bool = False) -> list[str]:
    """Execute one document's snippets in a shared namespace; returns
    failure reports (empty when the document runs clean)."""
    snippets = extract_snippets(path.read_text(), str(path))
    namespace: dict = {"__name__": f"docsmoke:{path}"}
    failures: list[str] = []
    for snip in snippets:
        if verbose:
            print(f"[docsmoke] {snip.path}:{snip.line}")
        try:
            code = compile(snip.source, f"{snip.path}:{snip.line}", "exec")
            exec(code, namespace)  # noqa: S102 — executing our own docs is the point
        except Exception:
            failures.append(f"{snip.path}:{snip.line}: snippet raised\n"
                            f"{traceback.format_exc()}")
    return failures


def run_paths(paths, verbose: bool = False) -> tuple[int, list[str]]:
    """Run every markdown file under ``paths`` (files pass through,
    directories recurse over ``*.md``); returns (snippet-bearing file
    count, failure reports)."""
    files: list[pathlib.Path] = []
    for raw in paths:
        p = pathlib.Path(raw)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.md")))
        elif p.suffix == ".md":
            files.append(p)
    failures: list[str] = []
    n = 0
    for f in files:
        if not f.exists():
            failures.append(f"{f}: no such file")
            continue
        reports = run_file(f, verbose=verbose)
        n += 1
        failures.extend(reports)
    return n, failures


def main(argv=None) -> int:
    """CLI entry point: 0 when every snippet ran, 1 otherwise."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.docsmoke",
        description="run the fenced ```python blocks in the docs")
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help="markdown files or directories "
                         f"(default: {' '.join(DEFAULT_PATHS)})")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print each snippet as it runs")
    args = ap.parse_args(argv)
    n, failures = run_paths(args.paths, verbose=args.verbose)
    for report in failures:
        print(report, file=sys.stderr)
    print(f"docsmoke: {n} file(s), {len(failures)} failure(s)")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
