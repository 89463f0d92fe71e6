"""CHK00 — linter hygiene.

Malformed suppression directives (no rule list, or no ``-- reason``), in
Python or in CUDA C++, surface here instead of being silently honored or
ignored: a suppression is a reviewed contract exception and must carry
its justification.  Unparsable files (for CUDA: an unterminated comment
or literal, unbalanced brackets) are reported under the same id by
``runner.run_check``.
"""

from __future__ import annotations

from typing import Iterator

from ..registry import AnyModule, Rule, register
from ..report import Finding


@register
class Chk00(Rule):
    id = "CHK00"
    title = ("linter hygiene: unparsable file or malformed suppression "
             "(reason is mandatory)")
    kinds = ("py", "cu")

    def check(self, module: AnyModule) -> Iterator[Finding]:
        for m in module.malformed:
            yield Finding(path=module.path, line=m.line, col=1,
                          rule=self.id, message=m.message)
