"""A lexical view of a CUDA C++ source, enough for the linter's rules.

No C++ parser: the rules read the source with its comments and string
literals blanked to spaces (every character keeps its offset, every line
its number), preprocessor directives blanked the same way (a launch
written inside a macro is not seen: the rules under-report rather than
guess), and the tree of ``{}`` blocks, each classified from the text in
front of it as a namespace, an ``extern "C"`` block, a type, a function
body or an inner block.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple


class CudaParseError(ValueError):
    """The source does not lex: an unterminated comment or literal, or
    unbalanced brackets."""

    def __init__(self, line: int, message: str):
        super().__init__(message)
        self.lineno = line


@dataclasses.dataclass
class Lexed:
    code: str       # comments, string/char literals, directives blanked
    text: str       # comments blanked, literals and directives kept
    comments: List[Tuple[int, int, str]]     # (line, col, text) of //...
    strings: List[Tuple[int, int]]           # (start, end) of "..." bodies


def _blank(chars: List[str], start: int, end: int) -> None:
    for i in range(start, end):
        if chars[i] != "\n":
            chars[i] = " "


def lex(source: str) -> Lexed:
    n = len(source)
    code = list(source)
    text = list(source)
    comments: List[Tuple[int, int, str]] = []
    strings: List[Tuple[int, int]] = []
    i, line, line_start = 0, 1, 0
    at_line_start = True
    while i < n:
        c = source[i]
        if c == "\n":
            i += 1
            line += 1
            line_start = i
            at_line_start = True
            continue
        if c in " \t\r":
            i += 1
            continue
        if at_line_start and c == "#":
            # A directive runs to the end of its line and its continuations.
            j = i
            while j < n and source[j] != "\n":
                if source.startswith("//", j) or source.startswith("/*", j):
                    break
                j += 1
                if j < n and source[j] == "\n" and source[j - 1] == "\\":
                    j += 1
                    line += 1
                    line_start = j
            _blank(code, i, j)
            i = j
            at_line_start = False
            continue
        at_line_start = False
        if source.startswith("//", i):
            j = source.find("\n", i)
            j = n if j < 0 else j
            comments.append((line, i - line_start, source[i:j]))
            _blank(code, i, j)
            _blank(text, i, j)
            i = j
            continue
        if source.startswith("/*", i):
            j = source.find("*/", i + 2)
            if j < 0:
                raise CudaParseError(line, "unterminated /* comment")
            _blank(code, i, j + 2)
            _blank(text, i, j + 2)
            line += source.count("\n", i, j + 2)
            last_nl = source.rfind("\n", i, j + 2)
            if last_nl >= 0:
                line_start = last_nl + 1
            i = j + 2
            continue
        if c in "\"'":
            # A digit separator (1'000) is not a literal.
            if c == "'" and i > 0 and source[i - 1].isalnum():
                i += 1
                continue
            raw = (c == '"' and i > 0 and source[i - 1] == "R")
            if raw:
                m = re.match(r'"([^ ()\\\t\n]{0,16})\(', source[i:])
                if m is None:
                    raise CudaParseError(line, "malformed raw string")
                close = ")" + m.group(1) + '"'
                j = source.find(close, i + m.end())
                if j < 0:
                    raise CudaParseError(line, "unterminated raw string")
                end = j + len(close)
            else:
                j = i + 1
                while j < n and source[j] != c:
                    if source[j] == "\\":
                        j += 1
                    elif source[j] == "\n":
                        raise CudaParseError(
                            line, f"unterminated {c} literal")
                    j += 1
                if j >= n:
                    raise CudaParseError(line, f"unterminated {c} literal")
                end = j + 1
            strings.append((i + 1, end - 1))
            _blank(code, i + 1, end - 1)
            line += source.count("\n", i, end)
            i = end
            continue
        i += 1
    return Lexed("".join(code), "".join(text), comments, strings)


@dataclasses.dataclass
class Block:
    open: int                 # offset of '{'
    close: int                # offset of the matching '}'
    parent: Optional[int]     # index into the block list
    kind: str                 # namespace | extern_c | type | function | inner
    header: str               # code from the previous ; { } to the '{'


_CONTROL = re.compile(r"\b(if|for|while|switch|catch|do|else|try)\b")
_FUNC_TAIL = re.compile(
    r"\)\s*(?:const|noexcept|override|final|volatile|&|&&|\s)*"
    r"(?:->\s*[\w:<>,\s\*&]+)?$")


def _header_start(code: str, pos: int) -> int:
    j = pos - 1
    while j >= 0 and code[j] not in ";{}":
        j -= 1
    return j + 1


def blocks(code: str) -> List[Block]:
    """Every ``{}`` block, in the order of their opening braces."""
    out: List[Block] = []
    stack: List[int] = []
    pairs = {")": "(", "]": "["}
    brackets: List[Tuple[str, int]] = []
    for i, c in enumerate(code):
        if c in "([":
            brackets.append((c, i))
        elif c in ")]":
            if not brackets or brackets[-1][0] != pairs[c]:
                raise CudaParseError(code.count("\n", 0, i) + 1,
                                     f"unbalanced '{c}'")
            brackets.pop()
        elif c == "{":
            parent = stack[-1] if stack else None
            header = code[_header_start(code, i):i]
            out.append(Block(i, -1, parent,
                             _classify(header, out, parent, brackets),
                             header))
            stack.append(len(out) - 1)
        elif c == "}":
            if not stack:
                raise CudaParseError(code.count("\n", 0, i) + 1,
                                     "unbalanced '}'")
            out[stack.pop()].close = i
    if stack:
        raise CudaParseError(code.count("\n", 0, out[stack[-1]].open) + 1,
                             "unclosed '{'")
    if brackets:
        raise CudaParseError(code.count("\n", 0, brackets[-1][1]) + 1,
                             f"unclosed '{brackets[-1][0]}'")
    return out


def _classify(header: str, done: List[Block], parent: Optional[int],
              brackets) -> str:
    h = " ".join(header.split())
    outer = "top" if parent is None else done[parent].kind
    if brackets:
        return "inner"                # a brace inside (...) or [...]
    if re.search(r"\bnamespace\b[\w\s:]*$", h):
        return "namespace"
    if re.search(r'\bextern\s+"\s*"$', h):
        return "extern_c"
    if outer in ("top", "namespace", "extern_c"):
        if re.search(r"\b(struct|class|union|enum)\b[^()]*$", h):
            return "type"
        if _FUNC_TAIL.search(h) and not _CONTROL.match(h) \
                and not h.endswith("="):
            return "function"
    return "inner"


def function_name(header: str) -> Tuple[str, str]:
    """(return type, name) of a function header: the identifier in front
    of the parameter list's '(' and the words before it, less storage and
    CUDA qualifiers, templates and ``__launch_bounds__``."""
    h = header.rstrip()
    depth = 0
    j = len(h) - 1
    # The parameter list is the last top-level (...) group.
    while j >= 0:
        if h[j] == ")":
            depth += 1
        elif h[j] == "(":
            depth -= 1
            if depth == 0:
                break
        j -= 1
    before = h[:j]
    m = re.search(r"([~\w:]+)\s*$", before)
    name = m.group(1) if m else ""
    ret = before[:m.start()] if m else before
    ret = re.sub(r"template\s*<[^{;]*?>\s*(?=\w)", " ", ret)
    ret = re.sub(r"__launch_bounds__\s*\([^)]*\)", " ", ret)
    ret = re.sub(r'\bextern\s+"\s*"', " ", ret)
    ret = re.sub(r"\b(static|inline|constexpr|__host__|__device__|"
                 r"__global__|__forceinline__|__noinline__|extern)\b",
                 " ", ret)
    return " ".join(ret.split()), name.split("::")[-1]


def matching(code: str, pos: int) -> int:
    """Offset of the bracket closing the one at ``pos``, or -1."""
    opening = code[pos]
    closing = {"(": ")", "[": "]", "{": "}"}[opening]
    depth = 0
    for j in range(pos, len(code)):
        if code[j] == opening:
            depth += 1
        elif code[j] == closing:
            depth -= 1
            if depth == 0:
                return j
    return -1


def statement_bounds(code: str, pos: int) -> Tuple[int, int]:
    """(start, end) of the statement holding ``pos``: from after the
    previous ``;``, ``{`` or ``}`` to its ``;`` (inclusive)."""
    start = _header_start(code, pos)
    end = code.find(";", pos)
    return start, (len(code) if end < 0 else end + 1)
