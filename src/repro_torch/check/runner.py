"""File discovery + the check loop: parse each module once, run every
registered rule that reads its kind over it, filter suppressions, sort
deterministically (as ``repro.check`` does, with CUDA sources)."""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Sequence

from .cudasrc import CudaParseError
from .registry import CUDA_SUFFIX, AnyModule, CudaModule, Module, all_rules
from .report import Finding

# Directory names skipped during traversal.  ``check_fixtures`` holds the
# deliberately-contract-violating rule fixtures: the tests check them by
# explicit path (explicit files always win over the exclude list).
# ``build`` holds the kernels' nvcc outputs.
DEFAULT_EXCLUDE_DIRS = {"check_fixtures", "__pycache__", ".git",
                        ".pytest_cache", "results", "build"}
SUFFIXES = (".py", CUDA_SUFFIX)


def iter_source_files(paths: Sequence[str],
                      exclude_dirs: Optional[Iterable[str]] = None
                      ) -> List[str]:
    """Every ``.py`` and ``.cu`` file under ``paths``; a path naming a
    file is taken whatever its suffix."""
    excluded = (DEFAULT_EXCLUDE_DIRS if exclude_dirs is None
                else set(exclude_dirs))
    out: List[str] = []
    for path in paths:
        if os.path.isfile(path):
            out.append(path)
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs if d not in excluded)
            out.extend(os.path.join(root, f) for f in sorted(files)
                       if f.endswith(SUFFIXES))
    return sorted(dict.fromkeys(out))


def load_module(path: str) -> AnyModule:
    with open(path, "r", encoding="utf-8") as f:
        source = f.read()
    if path.endswith(CUDA_SUFFIX):
        return CudaModule.load(path, source)
    return Module.load(path, source)


def run_check(paths: Sequence[str],
              rule_ids: Optional[Sequence[str]] = None,
              exclude_dirs: Optional[Iterable[str]] = None) -> List[Finding]:
    """Run the (selected) rules over every .py and .cu file under
    ``paths``.

    Returns the unsuppressed findings, sorted by (path, line, col, rule).
    A file that does not parse (or, for CUDA, does not lex) yields one
    CHK00 finding instead of crashing the sweep.
    """
    rules = all_rules()
    if rule_ids is not None:
        unknown = sorted(set(rule_ids) - set(rules))
        if unknown:
            raise ValueError(f"unknown rule ids: {', '.join(unknown)} "
                             f"(registered: {', '.join(rules)})")
        rules = {rid: rules[rid] for rid in rules if rid in set(rule_ids)}

    findings: List[Finding] = []
    for path in iter_source_files(paths, exclude_dirs=exclude_dirs):
        try:
            module = load_module(path)
        except (SyntaxError, UnicodeDecodeError, CudaParseError) as e:
            if "CHK00" in rules:
                findings.append(Finding(
                    path=path, line=getattr(e, "lineno", 1) or 1, col=1,
                    rule="CHK00",
                    message=f"file does not parse: {type(e).__name__}: "
                            f"{e}"))
            continue
        for rule in rules.values():
            if module.kind not in rule.kinds:
                continue
            for f in rule.check(module):
                if not module.suppressed(f):
                    findings.append(f)
    return sorted(findings)
