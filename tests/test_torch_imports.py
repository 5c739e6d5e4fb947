"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither jax nor anything of the JAX package ``repro``, at run time or in
their source, and the CDCL worker that the solver pool forks imports no
torch at all (a child forked after CUDA started must never touch CUDA)."""
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def _run(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_compile_with_the_walk_loads_no_jax_and_no_reference():
    last = _run(r"""
import sys
import repro_torch
repro_torch.set_default_device("cpu")
from repro_torch import MapRequest, compile
from repro_torch.core import suite
res = compile(MapRequest(dfg=suite.get("srand"), arch="2x2", sweep_width=2,
                         solver="walksat"))
assert res.success and any(a.via == "walksat" for a in res.attempts)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print("LOADED:" + ",".join(bad))
""")
    assert last == "LOADED:"


def test_lm_serving_loads_no_jax_and_no_reference():
    last = _run(r"""
import sys
import repro_torch
repro_torch.set_default_device("cpu")
import repro_torch.convert
import repro_torch.models.model
import repro_torch.launch.serve
repro_torch.launch.serve.main(["--arch", "hymba_1_5b", "--smoke", "--batch",
                               "1", "--steps", "2"])
from repro_torch.kernels.ssd_scan import ssd_scan
import torch
ssd_scan(torch.zeros(1, 4, 1, 2), torch.zeros(1, 4, 1), torch.zeros(1),
         torch.zeros(1, 4, 2), torch.zeros(1, 4, 2), torch.zeros(1), chunk=2)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print("LOADED:" + ",".join(bad))
""")
    assert last == "LOADED:"


def test_cdcl_worker_closure_is_torch_free():
    last = _run(r"""
import sys
import repro_torch
import repro_torch.core.sat.portfolio
from repro_torch.core.sat.cdcl import solve_arena_worker, solve_clauses_worker
print("TORCH:" + ",".join(sorted(m for m in sys.modules
                                  if m == "torch" or m.startswith("torch."))))
""")
    assert last == "TORCH:"


def _sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_jax_and_no_reference(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names = [str(node.args[0].value)]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"
    assert "sys.modules[" not in open(path).read(), path
