"""fork-safety: the CDCL worker that the solver pool forks stays torch-free.

The port's mapping shards are *spawned* (``core/workers.py``), so they
need no fork rule. What forks is the CDCL process pool
(``core/sat/portfolio.py`` over ``core/sat/cdcl.py``), possibly in a
process that started CUDA long before: a forked child cannot use CUDA,
and one that imports torch (or triton, or an XLA runtime) at module scope
inherits state it must not touch. This rule walks the *module-scope*
import graph (imports inside function bodies run later and are fine) from
every entry module — any module whose last dotted component matches
``config.fork_entry_suffixes`` — adding each module's enclosing packages,
which Python imports first, and reports each edge through which a
forbidden root becomes reachable, with the offending chain. It is the
static form of ``tests/test_torch_imports.py::
test_cdcl_worker_closure_is_torch_free``.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from ..lint import LintContext, LintFinding

NAME = "fork-safety"


def _resolve_internal(ctx: LintContext, name: str) -> Optional[str]:
    """Longest known module prefix of ``name``, if any."""
    parts = name.split(".")
    for k in range(len(parts), 0, -1):
        cand = ".".join(parts[:k])
        if cand in ctx.modules:
            return cand
    return None


def _packages(ctx: LintContext, mod: str) -> List[str]:
    """The scanned packages that enclose ``mod``, outermost first."""
    parts = mod.split(".")
    return [p for p in (".".join(parts[:k]) for k in range(1, len(parts)))
            if p in ctx.modules]


def check(ctx: LintContext) -> Iterable[LintFinding]:
    cfg = ctx.config
    entries = [m for m in sorted(ctx.modules)
               if m.split(".")[-1] in cfg.fork_entry_suffixes]
    for entry in entries:
        # BFS over module-scope imports, remembering how we got there
        parent: Dict[str, Tuple[str, int]] = {}  # module -> (importer, line)
        queue: List[str] = [entry]
        visited = {entry}
        while queue:
            mod = queue.pop(0)
            for pkg in _packages(ctx, mod):
                if pkg not in visited:
                    visited.add(pkg)
                    parent[pkg] = (mod, 0)
                    queue.append(pkg)
            for imp, lineno in ctx.module_scope_imports.get(mod, ()):
                root = imp.split(".")[0]
                if root in cfg.fork_forbidden_roots:
                    chain = _chain(entry, mod, parent)
                    rel = ctx.modules[mod]
                    yield LintFinding(
                        rule=NAME, path=rel, line=lineno,
                        token=f"{mod}->{root}",
                        message=(f"module-scope `{imp}` import reachable "
                                 f"from fork entry `{entry}` via "
                                 f"{' -> '.join(chain)}"),
                    )
                    continue
                internal = _resolve_internal(ctx, imp)
                if internal and internal not in visited:
                    visited.add(internal)
                    parent[internal] = (mod, lineno)
                    queue.append(internal)


def _chain(entry: str, mod: str, parent: Dict[str, Tuple[str, int]]
           ) -> List[str]:
    chain = [mod]
    while chain[-1] != entry and chain[-1] in parent:
        chain.append(parent[chain[-1]][0])
    return list(reversed(chain))
