"""Lint rule registry.

Each rule module exposes ``NAME: str`` and ``check(ctx) ->
Iterable[LintFinding]``.  Register new rules here; the CLI and
:func:`repro_torch.analysis.lint.run_lint` pick them up by name.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable

from ..lint import LintContext, LintFinding
from . import cuda_wrapper, fork_safety, hash_determinism, opt_safety

Rule = Callable[[LintContext], Iterable[LintFinding]]

ALL_RULES: Dict[str, Rule] = {
    mod.NAME: mod.check
    for mod in (fork_safety, opt_safety, hash_determinism, cuda_wrapper)
}
