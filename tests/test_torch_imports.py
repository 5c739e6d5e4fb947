"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the torch
examples import neither jax (nor optax, nor ml_dtypes) nor anything of the
JAX package ``repro``, at run time or in their source (the serving tier,
the frontend, a spawned shard, the campaign, a guided compile, training,
the dry run and the ranks of a host world included), and the CDCL worker
that the solver pool forks imports no torch at all (a child forked after
CUDA started must never touch CUDA), nor do the numpy guide, the
campaign engine and the static analysis."""
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def _run(code: str) -> str:
    # one torch thread: the CPU walk gains no wall time from more, and
    # under a parallel test run its spinning threads oversubscribe the
    # cores (a guided compile took 4 min of CPU for 52 s of wall alone)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
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


def test_training_loads_no_jax_no_reference_and_no_ml_dtypes(tmp_path):
    """The training CLI (data, AdamW, remat, checkpoints and a resume) runs
    with neither jax, the reference nor ml_dtypes loaded."""
    last = _run(r"""
import sys
from repro_torch.launch import steps, train
from repro_torch.checkpoint import checkpoint
from repro_torch.data import pipeline
from repro_torch.optim import adamw
args = ["--arch", "hymba_1_5b", "--smoke", "--steps", "2", "--global-batch",
        "2", "--seq-len", "8", "--device", "cpu", "--ckpt-dir", %r,
        "--ckpt-every", "1"]
train.main(args)
train.main(args[:4] + ["3"] + args[5:] + ["--resume"])
state, manifest = checkpoint.restore(%r)
assert manifest["step"] == 3 and int(state["opt"]["step"]) == 3
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
print("LOADED:" + ",".join(bad))
""" % (str(tmp_path), str(tmp_path)))
    assert last == "LOADED:"


def _host_world_rank(ckpt_dir):
    """A rank of ``test_host_world_loads_no_jax_and_no_reference`` (each
    spawned rank imports this module for it): trains on the host world's
    mesh, a checkpoint and a resume included, serves on the partitioned
    LM, and returns the forbidden modules it has loaded."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh, serve, train
    from repro_torch.models.model import LM
    cfg = get_config("hymba_1_5b").smoke()
    kw = dict(global_batch=2, seq_len=8, ckpt_dir=ckpt_dir, ckpt_every=1,
              log_every=0)
    with mesh.host_world(2) as dm:
        train.train_loop(cfg, steps=1, mesh=dm, **kw)
        train.train_loop(cfg, steps=2, resume=True, mesh=dm, **kw)
        lm = LM(cfg, "cpu", mesh=dm).init(torch.Generator().manual_seed(0))
        serve.serve_lm(lm, torch.zeros((2, 4), dtype=torch.long), 1)
    return sorted(m for m in sys.modules if _forbidden(m))


def test_host_world_loads_no_jax_and_no_reference(tmp_path):
    """Two gloo ranks started by ``launch.mesh.launch`` (torch's elastic
    launch API) train and serve over the host world with neither jax, the
    reference nor ml_dtypes loaded, in the ranks or in the launcher."""
    last = _run(r"""
import sys
sys.path.insert(0, %r)
import repro_torch
repro_torch.set_default_device("cpu")
from repro_torch.launch.mesh import launch
import test_torch_imports as t
res = launch(t._host_world_rank, (%r,), n_ranks=2)
assert sorted(res) == [0, 1]
bad = sorted(set(m for r in res.values() for m in r)
             | {m for m in sys.modules if t._forbidden(m)})
print("LOADED:" + ",".join(bad))
""" % (os.path.dirname(os.path.abspath(__file__)), str(tmp_path)))
    assert last == "LOADED:"


def test_service_tier_loads_no_jax_and_no_reference():
    last = _run(r"""
import sys
import repro_torch
repro_torch.set_default_device("cpu")
from repro_torch import MapRequest, compile
from repro_torch.core import suite
from repro_torch.core.workers import WorkerPool
from repro_torch.launch import map_cgra, serve
res = compile(MapRequest(dfg=suite.get("srand"), arch="2x2",
                         service="default"))
assert res.success and res.service.via == "cold"
with WorkerPool(workers=2, inline=True) as pool:
    assert pool.map(suite.get("nw"), map_cgra.arch("2x2")).success
map_cgra.main(["--arch", "hymba_1_5b", "--cgra", "3x3", "--service",
               "--device", "cpu"])
serve.main(["--arch", "hymba_1_5b", "--smoke", "--batch", "1", "--steps",
            "1", "--device", "cpu", "--offload-cgra", "3x3"])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print("LOADED:" + ",".join(bad))
""")
    assert last == "LOADED:"


def test_spawned_shard_loads_no_jax_and_no_reference():
    """A shard process imports what unpickling its work needs and its
    initialiser: no jax, nothing of repro."""
    last = _run(r"""
import repro_torch
repro_torch.set_default_device("cpu")
from repro_torch.core import suite
from repro_torch.core.cgra import CGRA
from repro_torch.core.workers import WorkerPool
with WorkerPool(workers=1) as pool:
    assert pool.map(suite.get("srand"), CGRA(2, 2)).success
    loaded = pool._shards[0].submit(
        eval, "sorted(m for m in __import__('sys').modules"
              " if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))").result()
print("LOADED:" + ",".join(loaded))
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


def test_guide_campaign_and_analysis_import_no_torch():
    """The numpy guide, the campaign engine and the static analysis load
    neither torch nor jax nor the reference: the guide runs inside shards
    before the CDCL pool forks, and torch is imported by train_guide."""
    last = _run(r"""
import sys
import repro_torch.core.guide
import repro_torch.core.campaign
import repro_torch.analysis
import repro_torch.analysis.rules
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "jaxlib", "optax",
                                    "repro"))
print("LOADED:" + ",".join(bad))
""")
    assert last == "LOADED:"


def test_guided_compile_loads_no_jax_and_no_cuda():
    """A guided compile with the walk, through the campaign launcher's
    imports: no jax, nothing of repro, and CUDA never initialised."""
    last = _run(r"""
import sys
import repro_torch
repro_torch.set_default_device("cpu")
import repro_torch.launch.campaign
from repro_torch import MapRequest, compile
from repro_torch.core import suite
from repro_torch.core.guide import init_guide, register_guide
register_guide("g", init_guide(seed=1))
res = compile(MapRequest(dfg=suite.get("srand"), arch="2x2", sweep_width=4,
                         solver="walksat", guide="g"))
assert res.success and res.guidance["used"], res.guidance
import torch
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "repro"))
print("LOADED:" + ",".join(bad) + ":" + str(torch.cuda.is_initialized()))
""")
    assert last == "LOADED::False"


def test_dry_run_and_examples_load_no_jax_and_no_reference():
    """The dry run (meta device, the mesh, specs and roofline modules) and
    the torch examples run with neither jax nor the reference loaded."""
    last = _run(r"""
import runpy, sys, tempfile
import repro_torch
repro_torch.set_default_device("cpu")
from repro_torch.launch import dryrun, mesh, roofline, specs
out = tempfile.mkdtemp() + "/d.jsonl"
dryrun.main(["--arch", "hymba_1_5b", "--shape", "decode_32k", "--mesh",
             "both", "--out", out, "--override", '{"n_layers": 1}'])
assert open(out).read().count('"status": "ok"') == 2
for name, args in (("quickstart_torch", []), ("map_torch_loop", []),
                   ("train_lm_torch", ["--steps", "1"])):
    sys.argv = [name] + args + ["--device", "cpu"]
    try:
        runpy.run_path("%s/examples/" + name + ".py", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, (name, e.code)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
print("LOADED:" + ",".join(bad))
""" % REPO)
    assert last == "LOADED:"


EXAMPLES = ("quickstart_torch.py", "map_torch_loop.py",
            "portfolio_mapper_torch.py", "train_lm_torch.py")


def _sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    for f in EXAMPLES:
        yield os.path.join(REPO, "examples", f)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "optax", "ml_dtypes", "repro")


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
