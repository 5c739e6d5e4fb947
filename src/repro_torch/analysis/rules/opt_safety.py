"""opt-safety: no bare ``assert`` guarding runtime behaviour.

``python -O`` compiles asserts away, so an ``assert`` that guards a
runtime invariant (queue started, worker initialised, shape contract)
silently stops guarding.  Guards must raise real exceptions
(``RuntimeError`` / ``ValueError``).  Every ``assert`` statement under
the scan root is reported; genuinely debug-only ones are suppressed via
the baseline file, which keeps them *explicit* instead of tribal.
"""
from __future__ import annotations

import ast
from typing import Iterable

from ..lint import LintContext, LintFinding
from ._util import snippet

NAME = "opt-safety"


def check(ctx: LintContext) -> Iterable[LintFinding]:
    for rel, pf in sorted(ctx.files.items()):
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.Assert):
                yield LintFinding(
                    rule=NAME, path=rel, line=node.lineno,
                    token=snippet(node.test),
                    message=("bare `assert` is stripped under `python -O`"
                             f": assert {snippet(node.test)}"),
                )
