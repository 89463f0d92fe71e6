"""Inline suppressions: ``# check: disable=RULE[,RULE...] -- reason`` in
Python, ``// check: disable=RULE[,RULE...] -- reason`` in CUDA C++.

The Python syntax is ``repro/check/suppress.py``'s, so one directive
holds under both linters.  The reason is mandatory — a suppression is a
reviewed exception to a contract, and the justification must live next to
it.  A directive with no reason (or no parseable rule list) is reported
as CHK00 instead of honored.

Placement: a trailing comment binds to its own line; a comment-only line
binds to the next line of code below it (blank lines and further
comments are skipped downward).  Directives are recognized in real
comment tokens only, so docstrings and string literals that *mention*
the syntax are inert.
"""

from __future__ import annotations

import dataclasses
import io
import re
import tokenize
from typing import Callable, Dict, Iterable, List, Set, Tuple

_DIRECTIVE = re.compile(
    r"(?:#|//)\s*check:\s*disable=([A-Za-z0-9_,\s]*?)\s*"
    r"(?:--\s*(\S.*))?$")


@dataclasses.dataclass
class Malformed:
    line: int
    message: str


def _comments(lines: List[str]):
    """(line, col, text) for every comment token; tolerant of files that
    tokenize rejects (the parser reports those separately)."""
    out = []
    reader = io.StringIO("\n".join(lines) + "\n").readline
    try:
        for tok in tokenize.generate_tokens(reader):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.start[1], tok.string))
    except (tokenize.TokenizeError, IndentationError, SyntaxError):
        pass
    return out


def _bind_line(line: int, trailing: bool, n_lines: int,
               is_code: Callable[[int], bool]) -> int:
    """Standalone comments bind to the next code line below them."""
    if trailing:
        return line                   # trailing comment: binds in place
    for j in range(line + 1, n_lines + 1):
        if is_code(j):
            return j
    return line


def _parse(comments: Iterable[Tuple[int, int, str]], n_lines: int,
           trailing: Callable[[int, int], bool],
           is_code: Callable[[int], bool], syntax: str
           ) -> Tuple[Dict[int, Set[str]], List[Malformed]]:
    suppressed: Dict[int, Set[str]] = {}
    malformed: List[Malformed] = []
    for line, col, text in comments:
        m = _DIRECTIVE.search(text)
        if m is None:
            if "check: disable" in text:
                malformed.append(Malformed(
                    line, f"unparseable suppression directive (expected "
                          f"'{syntax} check: disable=RULE -- reason')"))
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        reason = m.group(2)
        if not rules:
            malformed.append(Malformed(
                line, f"suppression names no rules (expected "
                      f"'{syntax} check: disable=RULE -- reason')"))
            continue
        if not reason:
            malformed.append(Malformed(
                line, f"suppression of {','.join(sorted(rules))} has no "
                      f"reason — append ' -- <why this exception is "
                      f"sound>'"))
            continue
        target = _bind_line(line, trailing(line, col), n_lines, is_code)
        suppressed.setdefault(target, set()).update(rules)
    return suppressed, malformed


def parse(lines: List[str]) -> Tuple[Dict[int, Set[str]], List[Malformed]]:
    """Python: map line -> suppressed rule ids, plus the malformed
    directives."""
    def is_code(j: int) -> bool:
        s = lines[j - 1].strip()
        return bool(s) and not s.startswith("#")

    return _parse(_comments(lines), len(lines),
                  lambda line, col: bool(lines[line - 1][:col].strip()),
                  is_code, "#")


def parse_cuda(lines: List[str], code_lines: List[str],
               comments: Iterable[Tuple[int, int, str]]
               ) -> Tuple[Dict[int, Set[str]], List[Malformed]]:
    """CUDA C++: the same map from the ``//`` comments (``comments``:
    (line, col, text)); ``code_lines`` is the source with comments and
    string literals blanked, which says which lines hold code."""
    return _parse(comments, len(lines),
                  lambda line, col: bool(code_lines[line - 1][:col].strip()),
                  lambda j: bool(code_lines[j - 1].strip()), "//")
