"""hash-determinism: canonical keys must be ``PYTHONHASHSEED``-stable.

The campaign canonicalizer (``core/campaign.py``) and every
``*signature*`` / ``*canonical*`` function produce keys that must be
byte-for-byte identical across processes — they name cells in the
sharded dataset and route requests to warm shards.  Builtin ``hash()``
is salted per process, and iteration order over ``set``/``frozenset``
depends on it; either one silently forks the keyspace.  This rule flags,
inside the scoped code only:

* any call to builtin ``hash(...)``;
* any ``for`` loop or comprehension iterating a raw unordered set
  expression (a set literal, set comprehension, or direct
  ``set(...)``/``frozenset(...)`` call) — wrap in ``sorted(...)``.

Scope: whole modules whose last dotted component matches
``config.hash_module_suffixes``, plus the body of any function whose
name contains one of ``config.hash_func_fragments`` anywhere in the
tree.
"""
from __future__ import annotations

import ast
from typing import Iterable, Iterator, List, Set, Tuple

from ..lint import LintContext, LintFinding
from ._util import snippet

NAME = "hash-determinism"

_SET_CTORS = {"set", "frozenset"}


def _is_unordered(expr: ast.expr) -> bool:
    if isinstance(expr, (ast.Set, ast.SetComp)):
        return True
    return (isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Name)
            and expr.func.id in _SET_CTORS)


def _scan(scope: ast.AST) -> Iterator[Tuple[int, str, str]]:
    """Yield (lineno, token, message) for violations inside ``scope``."""
    for node in ast.walk(scope):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "hash"):
            yield (node.lineno, f"hash:{snippet(node, 40)}",
                   f"builtin `hash()` is salted per process: "
                   f"{snippet(node)}")
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            if _is_unordered(node.iter):
                yield (node.lineno, f"set-iter:{snippet(node.iter, 40)}",
                       f"iteration over unordered set `{snippet(node.iter)}`"
                       f" — wrap in sorted(...)")
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                if _is_unordered(gen.iter):
                    yield (gen.iter.lineno,
                           f"set-iter:{snippet(gen.iter, 40)}",
                           f"comprehension over unordered set "
                           f"`{snippet(gen.iter)}` — wrap in sorted(...)")


def check(ctx: LintContext) -> Iterable[LintFinding]:
    cfg = ctx.config
    for rel, pf in sorted(ctx.files.items()):
        scopes: List[ast.AST] = []
        if pf.module.split(".")[-1] in cfg.hash_module_suffixes:
            scopes.append(pf.tree)
        else:
            for node in ast.walk(pf.tree):
                if (isinstance(node, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))
                        and any(frag in node.name
                                for frag in cfg.hash_func_fragments)):
                    scopes.append(node)
        seen: Set[Tuple[int, str]] = set()
        for scope in scopes:
            for lineno, token, message in _scan(scope):
                if (lineno, token) in seen:
                    continue
                seen.add((lineno, token))
                yield LintFinding(rule=NAME, path=rel, line=lineno,
                                  token=token, message=message)
