"""The port's repro-lint engine: walk files, run checkers, apply
suppressions.

Stdlib-only by design (ast/tokenize/pathlib): ``python -m
repro_torch.analysis src/repro_torch`` runs on a bare interpreter with
nothing installed — ``repro_torch/__init__.py`` resolves its names on
first use, so importing ``repro_torch.analysis`` never pulls torch.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, NamedTuple, Optional, Set

from repro_torch.analysis.diagnostics import RULES, Diagnostic
from repro_torch.analysis.files import SourceFile, load_file
from repro_torch.analysis.rules import FILE_CHECKERS, PROJECT_CHECKERS
from repro_torch.analysis.suppress import apply_suppressions, scan_comments

_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", ".ruff_cache",
              "node_modules", ".hypothesis"}


def iter_python_files(paths: Iterable[str]) -> Iterator[Path]:
    """Yield .py files under the given files/dirs, sorted, skipping cache
    and VCS directories. A nonexistent path raises — a CI job pointing at
    a renamed directory must fail loudly, not lint nothing."""
    for raw in paths:
        p = Path(raw)
        if p.is_file():
            if p.suffix == ".py":
                yield p
            continue
        if not p.is_dir():
            raise FileNotFoundError(f"lint target does not exist: {raw}")
        for sub in sorted(p.rglob("*.py")):
            if not _SKIP_DIRS.intersection(sub.parts):
                yield sub


class LintResult(NamedTuple):
    files: List[SourceFile]
    diagnostics: List[Diagnostic]   # post-suppression, sorted
    suppressions: int               # total ignore-comments seen

    @property
    def rule_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for d in self.diagnostics:
            counts[d.code] = counts.get(d.code, 0) + 1
        return counts


def _finish(files: List[SourceFile], raw: List[Diagnostic],
            parse_failures: List[Diagnostic],
            select: Optional[Set[str]]) -> LintResult:
    """Suppress per-file, filter by --select, sort and dedup."""
    by_path: Dict[str, List[Diagnostic]] = {}
    for d in raw:
        by_path.setdefault(d.path, []).append(d)
    comments = {sf.path: sf.comments for sf in files}
    check_unused = select is None
    out: List[Diagnostic] = list(parse_failures)
    for path, diags in by_path.items():
        if path not in comments:
            # project checker reached a file outside the scanned set
            # (e.g. cache.py resolved from disk) — honor its suppressions
            try:
                comments[path] = scan_comments(
                    Path(path).read_text(encoding="utf-8"))
            except OSError:
                comments[path] = scan_comments("")
        out.extend(apply_suppressions(path, comments[path], diags,
                                      check_unused=check_unused))
    # files with ignore-comments but no raw findings still need hygiene
    # checks (a stale suppression in an otherwise-clean file)
    for sf in files:
        if sf.path not in by_path and sf.comments.suppressions:
            out.extend(apply_suppressions(sf.path, sf.comments, [],
                                          check_unused=check_unused))
    if select is not None:
        out = [d for d in out if d.code in select]
    suppressions = sum(len(sf.comments.suppressions) for sf in files)
    return LintResult(files, sorted(set(out)), suppressions)


def lint_paths(paths: Iterable[str],
               select: Optional[Set[str]] = None) -> LintResult:
    files: List[SourceFile] = []
    raw: List[Diagnostic] = []
    parse_failures: List[Diagnostic] = []
    for path in iter_python_files(paths):
        sf = load_file(path)
        if sf is None:
            parse_failures.append(Diagnostic(
                str(path), 1, "RL000",
                "file does not parse — fix the syntax error first"))
            continue
        files.append(sf)
        for checker in FILE_CHECKERS:
            raw.extend(checker(sf.path, sf.tree, sf.source))
    for project_checker in PROJECT_CHECKERS:
        raw.extend(project_checker(files))
    return _finish(files, raw, parse_failures, select)


def lint_source(source: str, path: str = "<memory>",
                select: Optional[Set[str]] = None) -> List[Diagnostic]:
    """Lint one in-memory module (the test-fixture entry point). Runs the
    per-file checkers AND the project checkers over the single file."""
    tree = ast.parse(source, filename=path)
    sf = SourceFile(path, source, tree, scan_comments(source))
    raw: List[Diagnostic] = []
    for checker in FILE_CHECKERS:
        raw.extend(checker(sf.path, sf.tree, sf.source))
    for project_checker in PROJECT_CHECKERS:
        raw.extend(project_checker([sf]))
    return _finish([sf], raw, [], select).diagnostics


def parse_select(spec: Optional[str]) -> Optional[Set[str]]:
    """Parse ``--select RL001,RL003`` (None → all rules)."""
    if spec is None:
        return None
    codes = {c.strip().upper() for c in spec.split(",") if c.strip()}
    unknown = codes - set(RULES)
    if unknown:
        raise ValueError(
            f"unknown rule code(s) {sorted(unknown)}; "
            f"known: {sorted(RULES)}")
    return codes
