"""The rule registry and the per-module analysis contexts.

A rule is a class with a stable ``id``, a one-line ``title``, the
``kinds`` of module it reads (``"py"``, ``"cu"`` or both) and a
``check(module)`` generator.  Registration is by decorator; the CLI and
the test suite both iterate ``all_rules()``, so a rule module only needs
to be imported (``rules/__init__.py`` does that) to participate.

``Module`` is a Python file (``repro/check/registry.py``'s), ``CudaModule``
a CUDA C++ source: its code with comments and string literals blanked, so
offsets and line numbers are the file's, its ``{}`` blocks, and its
``//`` suppressions.
"""

from __future__ import annotations

import ast
import bisect
import dataclasses
from typing import Dict, Iterator, List, Set, Tuple, Type, Union

from . import callgraph, cudasrc, suppress
from .report import Finding


@dataclasses.dataclass
class Module:
    """Everything a rule needs to know about one Python source file."""

    path: str
    source: str
    lines: List[str]
    tree: ast.Module
    imports: callgraph.Imports
    parents: Dict[ast.AST, ast.AST]
    functions: Dict[str, ast.FunctionDef]
    suppressions: Dict[int, Set[str]]
    malformed: List[suppress.Malformed]
    kind = "py"

    @classmethod
    def load(cls, path: str, source: str) -> "Module":
        tree = ast.parse(source, filename=path)
        lines = source.splitlines()
        suppressed, malformed = suppress.parse(lines)
        return cls(
            path=path, source=source, lines=lines, tree=tree,
            imports=callgraph.Imports.of(tree),
            parents=callgraph.parent_map(tree),
            functions=callgraph.local_functions(tree),
            suppressions=suppressed, malformed=malformed)

    def finding(self, node: ast.AST, rule: str, message: str) -> Finding:
        return Finding(path=self.path, line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0) + 1,
                       rule=rule, message=message)

    def suppressed(self, f: Finding) -> bool:
        rules = self.suppressions.get(f.line, ())
        return f.rule in rules


# The suffix that makes a file a CUDA C++ source.
CUDA_SUFFIX = ".cu"


@dataclasses.dataclass
class CudaModule:
    """Everything a rule needs to know about one CUDA C++ source file."""

    path: str
    source: str
    lines: List[str]
    code: str                     # comments, literals, directives blanked
    text: str                     # comments blanked, literals kept
    strings: List[Tuple[int, int]]
    blocks: List[cudasrc.Block]
    suppressions: Dict[int, Set[str]]
    malformed: List[suppress.Malformed]
    line_starts: List[int]
    kind = "cu"

    @classmethod
    def load(cls, path: str, source: str) -> "CudaModule":
        lexed = cudasrc.lex(source)
        lines = source.splitlines()
        suppressed, malformed = suppress.parse_cuda(
            lines, lexed.code.splitlines(), lexed.comments)
        starts = [0] + [i + 1 for i, c in enumerate(source) if c == "\n"]
        return cls(
            path=path, source=source, lines=lines, code=lexed.code,
            text=lexed.text, strings=lexed.strings,
            blocks=cudasrc.blocks(lexed.code), suppressions=suppressed,
            malformed=malformed, line_starts=starts)

    def line_col(self, pos: int) -> Tuple[int, int]:
        line = bisect.bisect_right(self.line_starts, pos)
        return line, pos - self.line_starts[line - 1] + 1

    def finding(self, pos: int, rule: str, message: str) -> Finding:
        line, col = self.line_col(pos)
        return Finding(path=self.path, line=line, col=col, rule=rule,
                       message=message)

    def suppressed(self, f: Finding) -> bool:
        return f.rule in self.suppressions.get(f.line, ())

    def innermost(self, pos: int, kinds=None) -> Union[cudasrc.Block, None]:
        """The innermost block (of one of ``kinds``) holding ``pos``."""
        best = None
        for b in self.blocks:
            if b.open < pos < b.close and (kinds is None or b.kind in kinds):
                if best is None or b.open > best.open:
                    best = b
        return best


AnyModule = Union[Module, CudaModule]


class Rule:
    """Base class; subclasses set ``id``/``title`` (and ``kinds`` when
    they read CUDA sources) and yield Findings."""

    id: str = ""
    title: str = ""
    kinds: Tuple[str, ...] = ("py",)

    def check(self, module: AnyModule) -> Iterator[Finding]:
        raise NotImplementedError


_RULES: Dict[str, Rule] = {}


def register(cls: Type[Rule]) -> Type[Rule]:
    assert cls.id and cls.title, f"{cls.__name__} must set id and title"
    assert cls.id not in _RULES, f"duplicate rule id {cls.id}"
    _RULES[cls.id] = cls()
    return cls


def all_rules() -> Dict[str, Rule]:
    from . import rules  # noqa: F401  (importing registers everything)

    return dict(sorted(_RULES.items()))


def get_rule(rule_id: str) -> Rule:
    return all_rules()[rule_id]
