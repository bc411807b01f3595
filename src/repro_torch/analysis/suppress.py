"""Comment-driven controls: suppressions and lock annotations.

Two comment grammars ride in source files:

  * ``# repro-lint: ignore[RL001] reason text``  — suppress the named
    rule(s) ON THAT LINE. The reason is MANDATORY: a bare ignore is itself
    reported (RL000), as is an ignore that suppressed nothing — the tree
    can carry suppressions, never unexplained or stale ones.
  * ``# guarded-by: _lock`` / ``# holds: _lock`` — RL003's declarations:
    the first, on an attribute assignment in ``__init__``, declares the
    attribute guarded by that lock; the second, on a ``def`` line (or the
    first line of its body), declares the method is only called with the
    lock already held.

The grammar is the JAX package's linter's, comment for comment, so one
annotation or suppression in the port's tree serves both linters.
Comments are extracted with `tokenize` so strings containing ``#`` can
never be misread as comments (test fixtures embed violating snippets as
string literals).
"""
from __future__ import annotations

import io
import re
import tokenize
from typing import Dict, List, NamedTuple, Set, Tuple

from repro_torch.analysis.diagnostics import RULES, Diagnostic

_IGNORE_RE = re.compile(
    r"#\s*repro-lint:\s*ignore\[([A-Z0-9,\s]+)\]\s*(.*)$")
_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][\w|]*)")
_HOLDS_RE = re.compile(r"#\s*holds:\s*([A-Za-z_][\w|]*)")


class Suppression(NamedTuple):
    line: int
    codes: Tuple[str, ...]
    reason: str


class Comments(NamedTuple):
    """Per-file comment facts, line-indexed."""
    suppressions: Dict[int, Suppression]
    guarded_by: Dict[int, Tuple[str, ...]]   # line -> lock names
    holds: Dict[int, Tuple[str, ...]]        # line -> lock names


def scan_comments(source: str) -> Comments:
    suppressions: Dict[int, Suppression] = {}
    guarded: Dict[int, Tuple[str, ...]] = {}
    holds: Dict[int, Tuple[str, ...]] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [(t.start[0], t.string) for t in tokens
                    if t.type == tokenize.COMMENT]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        comments = []
    for line, text in comments:
        m = _IGNORE_RE.search(text)
        if m:
            codes = tuple(c.strip() for c in m.group(1).split(",")
                          if c.strip())
            suppressions[line] = Suppression(line, codes,
                                             m.group(2).strip())
        m = _GUARDED_RE.search(text)
        if m:
            guarded[line] = tuple(m.group(1).split("|"))
        m = _HOLDS_RE.search(text)
        if m:
            holds[line] = tuple(m.group(1).split("|"))
    return Comments(suppressions, guarded, holds)


def apply_suppressions(path: str, comments: Comments,
                       diags: List[Diagnostic],
                       check_unused: bool = True) -> List[Diagnostic]:
    """Drop suppressed findings; report suppression-hygiene violations.

    A diagnostic is suppressed when its line carries an ignore naming its
    code. RL000 findings are emitted for (a) ignores with no reason text,
    (b) ignores naming unknown codes, and (c) ignores that suppressed
    nothing (stale after a fix — delete them). RL000 itself cannot be
    suppressed. ``check_unused=False`` disables (c) — under ``--select``
    subsetting a suppression of an unselected rule is not stale.
    """
    used: Set[int] = set()
    kept: List[Diagnostic] = []
    for d in diags:
        sup = comments.suppressions.get(d.line)
        if sup is not None and d.code in sup.codes and d.code != "RL000":
            used.add(d.line)
        else:
            kept.append(d)
    for line, sup in sorted(comments.suppressions.items()):
        if not sup.reason:
            kept.append(Diagnostic(
                path, line, "RL000",
                f"suppression of {','.join(sup.codes)} has no reason — "
                "append why the finding is acceptable"))
        for code in sup.codes:
            if code not in RULES or code == "RL000":
                kept.append(Diagnostic(
                    path, line, "RL000",
                    f"unknown rule code {code!r} in suppression"))
        if check_unused and line not in used and all(
                c in RULES and c != "RL000" for c in sup.codes):
            kept.append(Diagnostic(
                path, line, "RL000",
                f"unused suppression of {','.join(sup.codes)} — nothing "
                "was diagnosed on this line; delete the stale ignore"))
    return sorted(kept)
