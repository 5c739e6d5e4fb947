"""cuda-wrapper: every kernel keeps its plain version and never falls back.

The port's kernels (``kernels/<name>/``) are CUDA C++ behind a Python
wrapper (``ops.py``). A wrapper launches its kernel on a CUDA tensor and
takes the plain torch version (``ref.py``) only for a CPU tensor; the
tests and ``chip_smoke.py`` hold the kernel to that plain version. This
rule checks, over every file whose scan-relative path contains
``config.kernels_path_fragment``:

* every directory with an ``ops.py`` also has a ``ref.py`` (the oracle
  the CPU route and the card's checks need);
* no ``float64``/``double``/``complex128`` mention in the kernels tree's
  Python: the kernels compute in f32/bf16/int32, and a double reference
  would compare in a dtype the kernel never uses;
* every ``except`` handler ends in ``raise``: a failed build, load or
  launch surfaces (``_cuda.py`` re-raises as ``KernelError``), it never
  silently continues on another route.
"""
from __future__ import annotations

import ast
from typing import Iterable

from ..lint import LintContext, LintFinding
from ._util import snippet

NAME = "cuda-wrapper"

_F64 = {"float64", "double", "complex128"}


def check(ctx: LintContext) -> Iterable[LintFinding]:
    frag = ctx.config.kernels_path_fragment
    for rel, pf in sorted(ctx.files.items()):
        if frag not in rel:
            continue
        head, _, base = rel.rpartition("/")
        if base == "ops.py" and f"{head}/ref.py" not in ctx.files:
            yield LintFinding(
                rule=NAME, path=rel, line=1, token=f"no-ref:{head}",
                message=f"`{rel}` wraps a kernel but `{head}/ref.py` (its "
                        f"plain version) is missing")
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.Attribute) and node.attr in _F64:
                yield LintFinding(
                    rule=NAME, path=rel, line=node.lineno,
                    token=f"f64:{node.attr}",
                    message=f"`{snippet(node)}`: the kernels never compute "
                            f"in double precision")
            elif (isinstance(node, ast.Constant)
                  and node.value in _F64):
                yield LintFinding(
                    rule=NAME, path=rel, line=node.lineno,
                    token=f"f64:{node.value}",
                    message=f"dtype string {node.value!r} in the kernels "
                            f"tree")
            elif (isinstance(node, ast.ExceptHandler)
                  and not isinstance(node.body[-1], ast.Raise)):
                caught = (snippet(node.type, 40) if node.type is not None
                          else "everything")
                yield LintFinding(
                    rule=NAME, path=rel, line=node.lineno,
                    token=f"swallow:{caught}",
                    message=f"`except {caught}` does not end in `raise`: "
                            f"a kernel failure must surface, never fall "
                            f"back")
