"""Parsed-file records shared by the engine and project-level checkers.

Lives in its own module so ``rules/rl004_keys`` (which needs to resolve
sibling files) and ``engine`` (which drives the walk) can both import it
without a cycle.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import NamedTuple, Optional

from repro_torch.analysis.suppress import Comments, scan_comments


class SourceFile(NamedTuple):
    path: str
    source: str
    tree: ast.Module
    comments: Comments


def load_file(path: Path) -> Optional[SourceFile]:
    """Parse one file; None when it does not parse (the engine turns that
    into its own diagnostic rather than crashing the whole run)."""
    source = path.read_text(encoding="utf-8")
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError:
        return None
    return SourceFile(str(path), source, tree, scan_comments(source))
