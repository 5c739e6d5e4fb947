"""Every batch the reference's host mesh takes, on a host world on the CPU:
gloo ranks, one process each, started through
``repro_torch.launch.mesh.launch`` and joined by ``host_world``, one
launch for each world size (1, 2 and 4 ranks).

- A batch of one row on a world of one rank, the ``(1, 1)`` mesh that
  ``torchrun --nproc-per-node 1`` gives: ``serve_lm`` and
  ``train_loop(global_batch=1)``. ``spec`` splits that row over the data
  axis of one rank, which DTensor cannot fold; the LM replicates it
  (``LM._batch_spec``).
- A global batch that the data axes do not divide (3 on 2x1, 6 on 4x1 and
  3 on 2x2): replicated over them, as the reference's ``spec(...,
  batch_size=)`` falls back, every rank drawing the whole batch
  (``mesh.data_shard``) and computing the whole step.
- Training: each step's loss and grad norm, the parameters and AdamW
  moments after the first and the last step within ``RTOL`` of the
  one-device ``train_loop`` on the same batches, for hymba_1_5b's and
  deepseek_moe_16b's smoke configs in f32 (deepseek: the aux loss's sums
  and their gradient count each token once); hymba on 4x1 at global batch
  6 against the reference's jitted step on its 4-device Auto-axis host
  mesh, fed the same batches, within ``test_train_steps_equal_the_
  reference``'s tolerance.
- A checkpoint written on 4x1 at global batch 6 restores on one device bit
  for bit and resumes there to the one-device run.
- Serving: a batch of one (and batches the data axes do not divide, and
  one row a rank on 2x2): greedy tokens equal one device's, logits within
  ``SERVE_ATOL``/``SERVE_RTOL``.
- The training and serving CLIs under ``torch.distributed.run`` with 3
  ranks, at a global batch of 8 and a batch of one.

The ranks run this module's ``_rank`` (spawned processes import it), in a
launcher subprocess with a time limit and one torch thread each (ROADMAP,
queue C, item 3); the reference's JAX code runs in its own subprocess.
"""
import json
import os
import pickle
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve, train
from repro_torch.models.model import LM

repro_torch.set_default_device("cpu")
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
STEPS, SEQ = 3, 17
# f32; the ranks sum gradients, losses and norms in another order than
# one device
RTOL = 1e-4
# served logits (f32, of order one) against one device's
SERVE_ATOL, SERVE_RTOL = 1e-5, 1e-4
# the CLIs train the smoke config's bf16: partial sums rounded to bf16 in
# another order
BF16_RTOL = 2e-3
# test_torch_train.test_train_steps_equal_the_reference's tolerance
REF_ATOL, REF_RTOL = 1e-5, 1e-4
# the reference's run: hymba on its 4x1 host mesh at a global batch of 6
REF_SHAPE, REF_BATCH = (4, 1), 6
# world size -> {case: (arch, mesh shape, global batch)}, trained for
# STEPS steps (the mesh of a world's own shape is the host world's; 2x2 is
# a mesh over the same four ranks)
TRAIN_CASES = {
    1: {"hymba-1x1-b1": ("hymba_1_5b", (1, 1), 1),
        "deepseek-1x1-b1": ("deepseek_moe_16b", (1, 1), 1)},
    2: {"hymba-2x1-b3": ("hymba_1_5b", (2, 1), 3),
        "deepseek-2x1-b3": ("deepseek_moe_16b", (2, 1), 3)},
    4: {"hymba-4x1-b6": ("hymba_1_5b", (4, 1), 6),
        "deepseek-4x1-b6": ("deepseek_moe_16b", (4, 1), 6),
        "deepseek-2x2-b2": ("deepseek_moe_16b", (2, 2), 2),
        "deepseek-2x2-b3": ("deepseek_moe_16b", (2, 2), 3)},
}
# world size -> {case: (arch, mesh shape, batch)}, served SERVE_STEPS steps
SERVE_CASES = {
    1: {"hymba-1x1-b1": ("hymba_1_5b", (1, 1), 1),
        "deepseek-1x1-b1": ("deepseek_moe_16b", (1, 1), 1)},
    2: {"hymba-2x1-b1": ("hymba_1_5b", (2, 1), 1),
        "deepseek-2x1-b3": ("deepseek_moe_16b", (2, 1), 3)},
    4: {"hymba-4x1-b1": ("hymba_1_5b", (4, 1), 1),
        "hymba-4x1-b3": ("hymba_1_5b", (4, 1), 3),
        "deepseek-2x2-b1": ("deepseek_moe_16b", (2, 2), 1),
        "hymba-2x2-b2": ("hymba_1_5b", (2, 2), 2)},
}
SERVE_STEPS = 5
LAUNCH_TIMEOUT_S = 420


def _cfg(arch):
    return get_config(arch).smoke().replace(dtype="float32")


def _kw(**over):
    return dict(dict(seq_len=SEQ, log_every=0), **over)


def _prompts(cfg, b):
    return torch.randint(0, cfg.vocab, (b, 8),
                         generator=torch.Generator().manual_seed(1))


def _numpy(tree):
    """Every leaf of a flat dict of (D)Tensors gathered whole as numpy (a
    collective for DTensors: every rank calls it in the same order)."""
    out = {}
    for k, t in tree.items():
        if hasattr(t, "full_tensor"):
            t = t.full_tensor()
        out[k] = t.detach().numpy().copy()
    return out


def _state(res):
    return {"params": _numpy(res["params"]),
            "m": _numpy(res["opt_state"]["m"]),
            "v": _numpy(res["opt_state"]["v"])}


def _mesh(dm, shape):
    """The host world's mesh, or a mesh of ``shape`` over its ranks."""
    if tuple(dm.shape) == tuple(shape):
        return dm
    return mesh_mod.device_mesh(mesh_mod.make_mesh(shape, ("data", "model")),
                                "cpu")


# ------------------------------------------------------------ the ranks
def _chain(cfg, dm, d, global_batch):
    """``STEPS`` runs of ``train_loop`` on ``dm``, each one step further
    than the last and resumed from its checkpoint in ``d`` (the first
    from whatever ``d`` holds): each run's final metrics are that step's.
    Returns the metrics and the states after the first and the last
    step."""
    metrics, states = [], {}
    for k in range(1, STEPS + 1):
        res = train.train_loop(cfg, **_kw(steps=k, global_batch=global_batch,
                                          ckpt_dir=d, ckpt_every=1,
                                          resume=True, mesh=dm))
        metrics.append([res["loss"], res["grad_norm"]])
        if k in (1, STEPS):
            states[k] = _state(res)
    return metrics, states


def _rank(tmp, n):
    """One rank's share of the cases of a world of ``n`` ranks
    (module-level: each spawned rank imports this module). Rank 0 returns
    the results; the others None."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    out = {"metrics": {}, "state": {}, "tokens": {}, "logits": {},
           "every_rank": {}}
    with mesh_mod.host_world(n) as dm:
        rank = dist.get_rank()
        out["mesh"] = [list(dm.mesh_dim_names), list(dm.shape)]
        for case, (arch, shape, gb) in TRAIN_CASES[n].items():
            metrics, states = _chain(_cfg(arch), _mesh(dm, shape),
                                     os.path.join(tmp, case), gb)
            out["metrics"][case] = metrics
            out["state"][case] = states
            out["every_rank"][case] = [None] * n
            dist.all_gather_object(out["every_rank"][case], metrics)
        if n == 4:
            # the reference's step-0 checkpoint, resumed on its mesh
            ref = os.path.join(tmp, "port-from-reference")
            if rank == 0:
                shutil.copytree(os.path.join(tmp, "reference"), ref)
            dist.barrier()
            out["metrics"]["reference"], _ = _chain(
                _cfg("hymba_1_5b"), _mesh(dm, REF_SHAPE), ref, REF_BATCH)
        for case, (arch, shape, b) in SERVE_CASES[n].items():
            cfg = _cfg(arch)
            lm = LM(cfg, "cpu", mesh=_mesh(dm, shape)).init(
                torch.Generator().manual_seed(0))
            got = serve.serve_lm(lm, _prompts(cfg, b), SERVE_STEPS,
                                 window=64)
            out["tokens"][case] = got.tokens.numpy()
            out["logits"][case] = [lg.numpy() for lg in got.logits]
    out["group_left_up"] = dist.is_initialized()
    return out if rank == 0 else None


def _launch(out_path, tmp):
    """The launcher subprocess: a world of each size in turn, each rank
    running ``_rank``; rank 0's results by world size, pickled."""
    got = {}
    for n in sorted(TRAIN_CASES):
        res = mesh_mod.launch(_rank, (tmp, n), n_ranks=n)
        got[n] = {"ranks": sorted(res), "out": res[0]}
    with open(out_path, "wb") as f:
        pickle.dump(got, f)


def _run(cmd, timeout):
    """``cmd`` in its own session with one torch thread, killed with all
    its processes at ``timeout`` seconds."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    return out


# the reference: its seeded hymba smoke weights checkpointed at step 0,
# then STEPS jitted train steps on its host mesh of forced host devices
# (an Auto-axis mesh: ROADMAP, queue C), fed the port's batches (numpy),
# whose rows the data axis does not divide; prints each step's metrics
_REFERENCE = r"""
import json, os, sys
out_dir, batches, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
dp, tp = (int(a) for a in sys.argv[4:6])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={dp * tp}"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType
from repro.checkpoint import checkpoint as ckpt
from repro.configs import get_config
from repro.launch import steps
from repro.models.model import LM
from repro.optim import adamw
batches = np.load(batches)
cfg = get_config("hymba_1_5b").smoke().replace(dtype="float32")
mesh = jax.make_mesh((dp, tp), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
lm = LM(cfg, mesh)
metrics = []
with mesh:
    params = lm.init(jax.random.PRNGKey(0))
    opt = adamw.init(params)
    ckpt.save(out_dir, 0, {"params": params, "opt": opt},
              extra={"data_cursor": 0, "seed": 0, "arch": cfg.name,
                     "mesh": [dp, tp]})
    step = jax.jit(steps.make_train_step(lm))
    for s in range(n):
        batch = {k: jnp.asarray(batches[f"{s}.{k}"])
                 for k in ("tokens", "labels")}
        params, opt, m = step(params, opt, batch)
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
print(json.dumps(metrics))
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The reference's run, then the worlds of 1, 2 and 4 ranks (the last
    resumes from the reference's checkpoint)."""
    tmp = tmp_path_factory.mktemp("host_batches")
    data = SyntheticLM(DataConfig(seed=0, global_batch=REF_BATCH,
                                  seq_len=SEQ), _cfg("hymba_1_5b"))
    np.savez(tmp / "batches.npz", **{
        f"{s}.{k}": v for s in range(STEPS)
        for k, v in data.batch_at(s).items()})
    ref = _run([sys.executable, "-c", _REFERENCE, str(tmp / "reference"),
                str(tmp / "batches.npz"), str(STEPS),
                *(str(n) for n in REF_SHAPE)], 300)
    out = tmp / "ranks.pkl"
    _run([sys.executable, "-c",
          f"import sys; sys.path.insert(0, {TESTS!r}); "
          f"import test_torch_host_batches as t; "
          f"t._launch({str(out)!r}, {str(tmp)!r})"], LAUNCH_TIMEOUT_S)
    with open(out, "rb") as f:
        got = pickle.load(f)
    got["reference"] = json.loads(ref.strip().splitlines()[-1])
    got["tmp"] = tmp
    return got


def _one_device_steps(arch, global_batch):
    """Each step's (loss, grad_norm) of one-device ``train_loop`` runs of
    1..STEPS steps, and the states after the first and the last step."""
    metrics, states = [], {}
    for k in range(1, STEPS + 1):
        res = train.train_loop(_cfg(arch), **_kw(steps=k,
                                                 global_batch=global_batch))
        metrics.append([res["loss"], res["grad_norm"]])
        if k in (1, STEPS):
            states[k] = _state(res)
    return metrics, states


@pytest.fixture(scope="module")
def one_device():
    pairs = {(arch, gb) for cases in TRAIN_CASES.values()
             for arch, _, gb in cases.values()}
    return {pair: _one_device_steps(*pair) for pair in sorted(pairs)}


def _close_state(got, want, what):
    for part in ("params", "m", "v"):
        assert set(got[part]) == set(want[part])
        for k in want[part]:
            np.testing.assert_allclose(
                got[part][k], want[part][k], rtol=RTOL,
                atol=RTOL * float(np.abs(want[part][k]).max()),
                err_msg=f"{what} {part}/{k}")


def _case(table, case):
    n = next(n for n, cases in table.items() if case in cases)
    return n, table[n][case]


# ------------------------------------------------------------- training
@pytest.mark.parametrize("case", [c for cases in TRAIN_CASES.values()
                                  for c in cases])
def test_train_loop_equals_one_device(case, worlds, one_device):
    """Each step's loss and grad norm, and the parameters and moments
    after the first and the last step (each leaf within RTOL of its
    largest magnitude), agree with one device's within RTOL: the same
    weights, the same global batch, sums in another order."""
    n, (arch, _, gb) = _case(TRAIN_CASES, case)
    want_metrics, want_states = one_device[(arch, gb)]
    out = worlds[n]["out"]
    np.testing.assert_allclose(out["metrics"][case], want_metrics,
                               rtol=RTOL, err_msg=case)
    for k, want in want_states.items():
        _close_state(out["state"][case][k], want, f"{case} step {k}")


@pytest.mark.parametrize("case", [c for cases in TRAIN_CASES.values()
                                  for c in cases])
def test_loss_and_grad_norm_are_the_same_on_every_rank(case, worlds):
    n, _ = _case(TRAIN_CASES, case)
    every = worlds[n]["out"]["every_rank"][case]
    assert len(every) == n
    assert all(metrics == every[0] for metrics in every), case


@pytest.mark.parametrize("n", sorted(TRAIN_CASES))
def test_each_world_is_the_host_mesh_and_no_group_stays_up(n, worlds):
    got = worlds[n]
    assert got["ranks"] == list(range(n))
    assert got["out"]["mesh"] == [["data", "model"], [n, 1]]
    assert not got["out"]["group_left_up"]


def test_the_reference_on_its_4x1_mesh_at_an_indivisible_batch(worlds):
    """The port's ranks, resumed from the reference's step-0 checkpoint of
    its own weights and fed the same batches of 6 rows, take the
    reference's steps on its 4-device host mesh, where its spec
    replicates the batch."""
    got = np.asarray(worlds[4]["out"]["metrics"]["reference"])
    want = np.asarray(worlds["reference"])
    assert got.shape == want.shape == (STEPS, 2)
    np.testing.assert_allclose(got, want, rtol=REF_RTOL, atol=REF_ATOL)


# ----------------------------------------------------------- checkpoint
def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8).tobytes()


def test_a_4x1_checkpoint_at_batch_6_restores_bit_for_bit(worlds):
    """The last checkpoint of the 4x1 run at global batch 6 says [4, 1]
    and restores on one device to the mesh's final state, bit for bit."""
    root = str(worlds["tmp"] / "hymba-4x1-b6")
    state, manifest = ckpt.restore(root, STEPS)
    assert manifest["extra"]["mesh"] == [4, 1]
    got = worlds[4]["out"]["state"]["hymba-4x1-b6"][STEPS]
    flat = {k: v.numpy() for k, v in ckpt._flatten(state).items()}
    for part in ("params", "m", "v"):
        prefix = "params/" if part == "params" else f"opt/{part}/"
        for k, v in got[part].items():
            assert _bits(flat[prefix + k.replace(".", "/")]) == _bits(v), k


def test_a_4x1_checkpoint_at_batch_6_resumes_on_one_device(worlds,
                                                          one_device,
                                                          tmp_path):
    """Step 1's checkpoint of the 4x1 run, resumed on one device to step
    STEPS, is the one-device run within RTOL."""
    src = worlds["tmp"] / "hymba-4x1-b6" / "ckpt_00000001"
    shutil.copytree(src, tmp_path / "ckpt_00000001")
    res = train.train_loop(_cfg("hymba_1_5b"), **_kw(
        steps=STEPS, global_batch=6, ckpt_dir=str(tmp_path), resume=True))
    want_metrics, want_states = one_device[("hymba_1_5b", 6)]
    np.testing.assert_allclose([res["loss"], res["grad_norm"]],
                               want_metrics[-1], rtol=RTOL)
    _close_state(_state(res), want_states[STEPS], "resumed")


# -------------------------------------------------------------- serving
@pytest.mark.parametrize("case", [c for cases in SERVE_CASES.values()
                                  for c in cases])
def test_served_tokens_equal_one_device(case, worlds):
    n, (arch, _, b) = _case(SERVE_CASES, case)
    cfg = _cfg(arch)
    lm = LM(cfg, "cpu").init(torch.Generator().manual_seed(0))
    want = serve.serve_lm(lm, _prompts(cfg, b), SERVE_STEPS, window=64)
    out = worlds[n]["out"]
    assert out["tokens"][case].shape == (b, SERVE_STEPS)
    assert np.array_equal(out["tokens"][case], want.tokens.numpy()), case
    assert len(out["logits"][case]) == SERVE_STEPS + 1
    for i, (got, w) in enumerate(zip(out["logits"][case], want.logits)):
        np.testing.assert_allclose(got, w.numpy(), atol=SERVE_ATOL,
                                   rtol=SERVE_RTOL, err_msg=f"{case} {i}")


# ------------------------------------------------------------------ CLI
_TORCHRUN = [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node", "3", "--rdzv-backend", "c10d",
             "--rdzv-endpoint", "127.0.0.1:0", "--local-addr", "127.0.0.1"]


def test_training_cli_on_3_ranks_at_a_global_batch_of_8(tmp_path, capsys):
    """Three ranks do not divide 8 rows: each trains on all of them. Rank
    0 alone prints; the final metrics agree with the one-device CLI's
    (bf16) within 2e-3; the checkpoint records [3, 1]."""
    args = ["--arch", "hymba_1_5b", "--smoke", "--steps", "3",
            "--global-batch", "8", "--seq-len", "16", "--device", "cpu"]
    out = _run(_TORCHRUN + ["-m", "repro_torch.launch.train", *args,
                            "--ckpt-dir", str(tmp_path), "--ckpt-every",
                            "3"], LAUNCH_TIMEOUT_S).splitlines()
    got = json.loads(out[-1])
    assert [ln.split(":")[0] for ln in out[:-1]] == ["step 0", "step 2"]
    train.main(args)
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert set(got) == set(want)
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(got[k], want[k], rtol=BF16_RTOL,
                                   err_msg=k)
    _, manifest = ckpt.restore(str(tmp_path))
    assert manifest["extra"]["mesh"] == [3, 1]


def test_serving_cli_on_3_ranks_serves_a_batch_of_one(capsys):
    args = ["--arch", "deepseek_moe_16b", "--smoke", "--batch", "1",
            "--steps", "5", "--device", "cpu"]
    out = _run(_TORCHRUN + ["-m", "repro_torch.launch.serve", *args],
               LAUNCH_TIMEOUT_S).splitlines()
    serve.main(args)
    want = capsys.readouterr().out.splitlines()
    reqs = [ln for ln in want if ln.startswith("  req")]
    assert len(reqs) == 1
    assert [ln for ln in out if ln.startswith("  req")] == reqs
    assert sum(ln.startswith("decoded ") for ln in out) == 1


# ------------------------------------------------------------- layouts
def test_a_batch_of_one_row_is_replicated_and_others_follow_spec():
    """On a fake world: ``spec`` splits one row over a data axis of one
    rank; the LM lays it out replicated (its inputs, the residual, the
    cache), and any other batch as ``spec`` does. ``data_shard`` gives
    (0, 1) where the data axes do not divide the batch."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.sharding import spec
    cfg = _cfg("hymba_1_5b")
    with mesh_mod.fake_world(4):
        for shape in ((1, 1), (1, 4)):
            logical = mesh_mod.make_mesh(shape, ("data", "model"))
            dm = mesh_mod.device_mesh(logical)
            lm = LM(cfg, "meta", mesh=dm)
            assert spec(logical, "batch", None, batch_size=1) == (
                "data", None)
            assert lm._batch_spec(1, None, None) == (None, None, None)
            assert lm._batch_spec(2, None, None) == ("data", None, None)
            one = lm.split_rows(torch.zeros(1, 8, dtype=torch.long))
            assert one.placements[0] == Replicate()
            two = lm.split_rows(torch.zeros(2, 8, dtype=torch.long))
            assert two.placements[0] == Shard(0)
            for k, t in lm.init_cache(1, 8).items():
                assert t.placements[0] == Replicate(), k
            for k, t in lm.init_cache(2, 8).items():
                assert t.placements[0] == Shard(1), k
            assert mesh_mod.data_shard(dm, 1) == (0, 1)
        dm = mesh_mod.device_mesh(mesh_mod.make_mesh((4, 1),
                                                     ("data", "model")))
        assert mesh_mod.data_shard(dm, 8) == (0, 4)
        assert mesh_mod.data_shard(dm, 6) == (0, 1)
        dm = mesh_mod.device_mesh(mesh_mod.make_mesh((2, 2),
                                                     ("data", "model")))
        assert mesh_mod.data_shard(dm, 4) == (0, 2)
        assert mesh_mod.data_shard(dm, 3) == (0, 1)
    assert mesh_mod.data_shard(None, 3) == (0, 1)
    assert not torch.distributed.is_initialized()


def test_a_batch_of_one_runs_the_partitioned_lm_on_meta():
    """The trace that failed in DTensor's view of the first projection: a
    prefill of one row on a (1, 1) mesh runs and keeps its shapes."""
    cfg = _cfg("hymba_1_5b")
    with mesh_mod.fake_world(1):
        dm = mesh_mod.device_mesh(mesh_mod.make_mesh((1, 1),
                                                     ("data", "model")))
        lm = LM(cfg, "meta", mesh=dm)
        with lm.sharded():
            lg, cache = lm.prefill_with_cache(
                lm.split_rows(torch.zeros(1, 8, dtype=torch.long,
                                          device="meta")))
        assert tuple(lg.shape) == (1, 1, lm.vocab_pad)
        assert tuple(cache["k"].shape)[:3] == (cfg.n_layers, 1, 8)
    assert not torch.distributed.is_initialized()
