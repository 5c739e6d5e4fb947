"""The SSM path's collectives come from layouts the port names, so the
partitioned dry run counts the same on every torch version.

- ``dryrun.record_collectives`` (a ``CollectiveCounter`` that records
  each op's call site and issuer): in the SSM cells on the CPU every
  collective comes from an explicit ``redistribute``, local map or
  ``from_local`` of the port (or the backward of one), none from
  DTensor's sharding propagation; the gated norm's two sums over the
  split channels are all-reduces of [B/dp, S, 1] f32.
- The committed counts (``src/repro_torch/launch/collective_counts.json``,
  written by ``python -m repro_torch.launch.dryrun --counts``) equal a
  fresh count of the mamba2_370m cells, and list every probed cell.
- Four gloo ranks on the CPU running ``ssm_layer`` forward and backward
  (and a decode step from the prefill's state) on their shards equal one
  device in values and gradients.
"""
import inspect
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

import repro_torch
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import layers
from repro_torch.models.config import SHAPES, ShapeConfig

repro_torch.set_default_device("cpu")
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def _explicit_only(rec):
    ops = rec.records
    assert ops
    bad = [r for r in ops if r[5] == "propagation"]
    assert not bad, bad[:4]
    assert all(r[3] and r[3].startswith("repro_torch/") for r in ops), \
        [r for r in ops if not (r[3] or "").startswith("repro_torch/")][:4]
    assert {r[5] for r in ops} <= {"redistribute", "local_map", "autograd"}
    return ops


# the probes of the SSM cells at their published widths on 16x16 (cut to
# one or two layers), and the widened smoke configs on 2x2
CELLS = {
    "mamba2-train-16x16": ("mamba2_370m", SHAPES["train_4k"], 2, False),
    "mamba2-decode-16x16": ("mamba2_370m", SHAPES["decode_32k"], 2, False),
    "hymba-prefill-16x16": ("hymba_1_5b", SHAPES["prefill_32k"], 1, False),
    "hymba-train-2x2": ("hymba_1_5b", ShapeConfig("t", 64, 4, "train"), 2,
                        True),
    "mamba2-prefill-2x2": ("mamba2_370m", ShapeConfig("p", 64, 4, "prefill"),
                           2, True),
}


@pytest.mark.parametrize("cell", list(CELLS))
def test_every_collective_comes_from_an_explicit_layout(cell):
    arch, shape, depth, smoke = CELLS[cell]
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
        mesh = make_mesh((2, 2), ("data", "model"))
    else:
        mesh = make_production_mesh(multi_pod=False)
    cfg = cfg.replace(n_layers=depth, scan_layers=False)
    ops = _explicit_only(dryrun.record_collectives(cfg, shape, mesh))
    tp = mesh.shape["model"]
    dp = mesh.size // tp
    # the gated norm's sums over the channels split over "model": one
    # all-reduce of [B/dp, S, 1] f32 a layer forward, and where the step
    # trains one more backward (and one in remat's recomputation); a decode
    # step's first norm, on the embedding's feature shards, one more
    stat = f"all-reduce g={tp} float32[{shape.global_batch // dp}, " \
        f"{1 if shape.kind == 'decode' else shape.seq_len}, 1]"
    site = _line(layers._feature_mean, "total.redistribute")
    norm = [r for r in ops if r[3].startswith(site)]
    want = depth * ((2 + cfg.remat) if shape.kind == "train" else 1)
    assert [r[0] for r in norm] == [stat] * (
        want + (shape.kind == "decode"))


def _line(fn, text):
    """``repro_torch/models/layers.py:N `` of the line of ``fn`` that holds
    ``text``."""
    src, first = inspect.getsourcelines(fn)
    n = first + next(i for i, ln in enumerate(src) if text in ln)
    return f"repro_torch/models/layers.py:{n} "


def test_the_recorder_names_the_propagation_it_sees():
    """A plain DTensor product whose operands disagree is relaid out by
    DTensor's propagation, and the recorder says so, with the port's
    line that made the product."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import device_mesh, fake_world
    mesh = make_mesh((1, 4), ("data", "model"))
    rec = dryrun.CollectiveRecorder()
    with fake_world(4):
        dm = device_mesh(mesh, "cuda")
        a = distribute_tensor(torch.empty(8, 16, device="meta"), dm,
                              [Replicate(), Shard(1)], src_data_rank=None)
        b = distribute_tensor(torch.empty(16, 8, device="meta"), dm,
                              [Replicate(), Shard(1)], src_data_rank=None)
        with rec:
            layers._laid_out(a, [Replicate(), Replicate()])   # explicit
            a @ b                                             # propagation
    assert [r[5] for r in rec.records] == ["redistribute", "propagation"]
    assert rec.records[0][3].startswith("repro_torch/models/layers.py:")
    assert rec.records[1][3] is None          # no frame of the port
    assert rec.records[0][4] == "forward"


# --------------------------------------------------------------- counts
def _counts():
    with open(dryrun.COUNTS_FILE) as f:
        return json.load(f)


def test_the_counts_file_lists_every_probed_cell():
    got = _counts()
    assert set(got["cells"]) == {dryrun.cell_key(*c)
                                 for c in dryrun.probed_cells()}
    for key, row in got["cells"].items():
        assert set(row) == {"wire_bytes", "count", "by_kind"}, key
        assert row["count"] > 0 and row["wire_bytes"] > 0, key
        assert sum(row["by_kind"].values()) == pytest.approx(
            row["wire_bytes"], rel=1e-12), key
    assert "--counts" in got["command"]


@pytest.mark.parametrize("cell", [("mamba2_370m", "train_4k", False),
                                  ("mamba2_370m", "prefill_32k", False),
                                  ("mamba2_370m", "decode_32k", False),
                                  ("mamba2_370m", "decode_32k", True)])
def test_committed_counts_equal_a_fresh_count(cell):
    want = _counts()["cells"][dryrun.cell_key(*cell)]
    assert dryrun.collective_counts(*cell) == want


# ---------------------------------------------------------- gloo ranks
# four gloo ranks on the CPU, each running ``ssm_layer`` on its shards of
# one set of seeded weights and tokens and on the whole of them: the
# partitioned output, the prefill's final state and conv tails, every
# gradient, and a decode step from that state, against one device's;
# rank 0 writes the results
_GLOO_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
import repro_torch
repro_torch.set_default_device("cpu")
torch.set_num_threads(1)
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import get_config
from repro_torch.launch.mesh import device_mesh, make_mesh
from repro_torch.models import layers
from repro_torch.models.model import param_shapes, param_specs
from repro_torch.models.sharding import placements

rank, world, port, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=world, rank=rank)
rng = np.random.default_rng(0)
results = []
for sizes, over in json.loads(sys.argv[5]):
    cfg = get_config("mamba2_370m").smoke().replace(dtype="float32", **over)
    shapes = {k[len("blocks.ssm."):]: s[0][1:]
              for k, s in param_shapes(cfg, 1).items()
              if k.startswith("blocks.ssm.")}
    whole = {}
    for k, s in shapes.items():
        if k in ("norm", "D"):
            v = 1.0 + rng.normal(0, 0.1, s)
        elif k == "A_log":
            v = rng.normal(0, 0.5, s)
        elif k == "dt_bias":
            v = rng.normal(-1.0, 0.3, s)
        else:
            v = rng.normal(0, 0.2, s)
        whole[k] = torch.tensor(v, dtype=torch.float32)
    b, s, d = 4, 24, cfg.d_model
    x = torch.tensor(rng.normal(0, 1, (b, s, d)), dtype=torch.float32)
    x1 = torch.tensor(rng.normal(0, 1, (b, 1, d)), dtype=torch.float32)
    gout = torch.tensor(rng.normal(0, 1, (b, s, d)), dtype=torch.float32)

    one = {k: v.clone().requires_grad_() for k, v in whole.items()}
    xo = x.clone().requires_grad_()
    o1, c1 = layers.ssm_layer(cfg, one, xo, want_cache=True)
    (o1 * gout).sum().backward()
    with torch.no_grad():
        d1, _ = layers.ssm_layer(cfg, one, x1, cache=c1)

    mesh = make_mesh(tuple(sizes), ("data", "model"))
    dm = device_mesh(mesh, "cpu")
    specs = param_specs(cfg, mesh)
    part = {k: distribute_tensor(
        v, dm, placements(specs["blocks.ssm." + k][1:], dm),
        src_data_rank=None).detach().requires_grad_()
        for k, v in whole.items()}
    rows = placements(("data", None, None), dm)
    xp = distribute_tensor(x, dm, rows, src_data_rank=None
                           ).detach().requires_grad_()
    op, cp = layers.ssm_layer(cfg, part, xp, want_cache=True)
    out = op.full_tensor()
    (out * gout).sum().backward()
    with torch.no_grad():
        dp_, _ = layers.ssm_layer(
            cfg, part, distribute_tensor(x1, dm, rows, src_data_rank=None),
            cache=cp)
    res = {"out": float((out - o1).abs().max()),
           "cache": {k: float((cp[k].full_tensor() - c1[k]).abs().max())
                     for k in c1},
           "decode": float((dp_.full_tensor() - d1).abs().max()),
           "grads": {k: float((part[k].grad.full_tensor()
                               - one[k].grad).abs().max())
                     for k in whole} | {
               "x": float((xp.grad.full_tensor() - xo.grad).abs().max())},
           "scale": float(o1.abs().max()),
           "grad_scale": {k: float(one[k].grad.abs().max()) for k in whole}
           | {"x": float(xo.grad.abs().max())},
           "placements": {k: [str(p) for p in v.placements]
                          for k, v in cp.items()}}
    results.append(res)
if rank == 0:
    json.dump(results, open(out_path, "w"))
dist.destroy_process_group()
"""
# (mesh, overrides): data only, data and model, model only (the gated
# norm's channels split four ways; the sequence of 24 tokens in chunks
# of 8 padded to none, and in chunks of 16 padded by 8)
GLOO_CASES = {
    "4x1": ((4, 1), {}),
    "2x2": ((2, 2), {}),
    "1x4": ((1, 4), {}),
    "1x4-padded-chunk": ((1, 4), {"ssm_chunk": 16}),
}


@pytest.fixture(scope="module")
def gloo_ssm(tmp_path_factory):
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out = str(tmp_path_factory.mktemp("gloo") / "ssm.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    cases = json.dumps(list(GLOO_CASES.values()))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_WORKER, str(r), "4", str(port), out,
         cases], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), errs[0][-2000:]
    return dict(zip(GLOO_CASES, json.load(open(out))))


@pytest.mark.parametrize("case", list(GLOO_CASES))
def test_ssm_layer_on_gloo_ranks_equals_one_device(case, gloo_ssm):
    """Output, the prefill's state and conv tails, and the decode step
    from them agree with one device's in f32 to 1e-5 (outputs of order
    one); every gradient (tokens, projections, convs, dt bias, A_log, D,
    norm; sums over 96 positions, up to a few hundred) to 2e-6 of its
    largest entry."""
    res = gloo_ssm[case]
    assert 0.1 < res["scale"] < 100
    assert res["out"] < 1e-5
    assert max(res["cache"].values()) < 1e-5, res["cache"]
    assert res["decode"] < 1e-5
    rel = {k: err / res["grad_scale"][k] for k, err in res["grads"].items()}
    assert max(rel.values()) < 2e-6, rel
    # the state handed to decode: batch over "data", heads over "model"
    assert res["placements"]["state"] == ["S(0)", "S(1)"]
