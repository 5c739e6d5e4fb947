"""Training and serving over a host world on the CPU: four gloo ranks, one
process each, started through ``repro_torch.launch.mesh.launch`` (torch's
elastic launch API) and joined by ``host_world``, as the port runs one
rank a card on a host of several cards (NCCL there).

- ``train_loop(mesh=)`` for 4 steps of hymba_1_5b's smoke config in f32
  at 4x1 and 2x2 and deepseek_moe_16b's at 2x2 (the expert-parallel
  path): each step's loss and grad norm, the final parameters and AdamW
  moments within 1e-4 relative of the one-device ``train_loop``, and the
  loss and grad norm the same on every rank.
- The reference on the same 4x1 mesh: the JAX package's jitted train step
  on a 4-device host mesh (a subprocess, forced host devices, an
  Auto-axis mesh: ROADMAP, queue C) from its own seeded weights; the
  port's ranks resume from the reference's checkpoint of those weights
  and train on the same batches. Each step's metrics agree within
  ``test_train_steps_equal_the_reference``'s tolerance.
- Elastic restore: a checkpoint written on 4x1 (its manifest says
  ``[4, 1]``) restores on 2x2, on one device and through the reference's
  ``restore`` bit for bit, and resumes on 2x2 to the one-device run; a
  crash and resume on 4x1 equals the uninterrupted run bit for bit.
- Serving (``serve_lm`` on the partitioned LM, prompts split over
  "data"): greedy tokens equal one device's, hymba at 4x1 and 2x2,
  deepseek at 4x1 and 2x2.
- The CLIs under ``torch.distributed.run --nproc-per-node 4``.
- Refusals: a host world beside a ``fake`` one and a ``fake`` world
  inside a host world, a process that is no rank of a world. No process
  group is left up. (Batches the data axis does not divide:
  ``tests/test_torch_host_batches.py``.)

The ranks run this module's ``_rank`` (spawned processes import it), in a
launcher subprocess with a time limit and one torch thread each (ROADMAP,
queue C, item 3); the reference's JAX code is imported only where it
runs, so the ranks never load it.
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
RANKS = 4
STEPS, GLOBAL_BATCH, SEQ = 4, 8, 17
# f32; the ranks sum gradients, losses and norms in another order than
# one device
RTOL = 1e-4
# the CLIs train the smoke config's bf16: partial sums rounded to bf16 in
# another order
BF16_RTOL = 2e-3
# test_torch_train.test_train_steps_equal_the_reference's tolerance
REF_ATOL, REF_RTOL = 1e-5, 1e-4
# (arch, mesh shape) trained for STEPS steps
TRAIN_CASES = {"hymba-4x1": ("hymba_1_5b", (4, 1)),
               "hymba-2x2": ("hymba_1_5b", (2, 2)),
               "deepseek-2x2": ("deepseek_moe_16b", (2, 2))}
SERVE_CASES = {"hymba-4x1": ("hymba_1_5b", (4, 1)),
               "hymba-2x2": ("hymba_1_5b", (2, 2)),
               "deepseek-4x1": ("deepseek_moe_16b", (4, 1)),
               "deepseek-2x2": ("deepseek_moe_16b", (2, 2))}
SERVE_STEPS = 6
LAUNCH_TIMEOUT_S = 420


def _cfg(arch):
    return get_config(arch).smoke().replace(dtype="float32")


def _kw(**over):
    return dict(dict(global_batch=GLOBAL_BATCH, seq_len=SEQ, log_every=0),
                **over)


def _prompts(cfg):
    return torch.randint(0, cfg.vocab, (4, 8),
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


# ------------------------------------------------------------ the ranks
def _chain(cfg, dm, d):
    """``STEPS`` runs of ``train_loop`` on ``dm``, each one step further
    than the last and resumed from its checkpoint (the first from
    whatever ``d`` holds): each run's final metrics are that step's."""
    metrics = []
    for k in range(1, STEPS + 1):
        res = train.train_loop(cfg, **_kw(steps=k, ckpt_dir=d, ckpt_every=1,
                                          resume=True, mesh=dm))
        metrics.append([res["loss"], res["grad_norm"]])
    return metrics, res


def _rank(tmp):
    """One rank's share of every case (module-level: each spawned rank
    imports this module). Rank 0 returns the results; the others None."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    out = {"metrics": {}, "state": {}, "tokens": {}}
    with mesh_mod.host_world(RANKS) as dm41:
        rank = dist.get_rank()
        meshes = {(4, 1): dm41, (2, 2): mesh_mod.device_mesh(
            mesh_mod.make_mesh((2, 2), ("data", "model")), "cpu")}
        out["mesh"] = [list(dm41.mesh_dim_names), list(dm41.shape)]
        # (a) each step of a chain of resumed runs
        for case, (arch, shape) in TRAIN_CASES.items():
            metrics, res = _chain(_cfg(arch), meshes[shape],
                                  os.path.join(tmp, case))
            out["metrics"][case] = metrics
            out["state"][case] = _state(res)
        # (b) the reference's checkpoint resumed on 4x1
        ref = os.path.join(tmp, "port-from-reference")
        if rank == 0:
            shutil.copytree(os.path.join(tmp, "reference"), ref)
        dist.barrier()
        out["metrics"]["reference-4x1"], _ = _chain(_cfg("hymba_1_5b"),
                                                    dm41, ref)
        # (c) uninterrupted, crashed and resumed, restored on 2x2
        cfg = _cfg("hymba_1_5b")
        straight = os.path.join(tmp, "straight")
        res = train.train_loop(cfg, **_kw(steps=STEPS, ckpt_dir=straight,
                                          ckpt_every=2, mesh=dm41))
        out["state"]["straight"] = _state(res)
        crashed = os.path.join(tmp, "crashed")
        try:
            train.train_loop(cfg, **_kw(steps=STEPS, ckpt_dir=crashed,
                                        ckpt_every=2, fail_at=3, mesh=dm41))
        except RuntimeError as e:
            out["crash"] = str(e)
        res = train.train_loop(cfg, **_kw(steps=STEPS, ckpt_dir=crashed,
                                          ckpt_every=2, resume=True,
                                          mesh=dm41))
        out["state"]["resumed"] = _state(res)
        specs = train.state_specs(LM(cfg, "cpu", mesh=meshes[(2, 2)]))
        state, _ = ckpt.restore(straight, STEPS, mesh=meshes[(2, 2)],
                                specs=specs)
        out["restored-2x2"] = _numpy({
            k: v for k, v in ckpt._flatten(state).items()})
        rescaled = os.path.join(tmp, "rescaled")
        if rank == 0:
            shutil.copytree(os.path.join(straight, "ckpt_00000002"),
                            os.path.join(rescaled, "ckpt_00000002"))
        dist.barrier()
        res = train.train_loop(cfg, **_kw(steps=STEPS, ckpt_dir=rescaled,
                                          resume=True, mesh=meshes[(2, 2)]))
        out["state"]["rescaled-2x2"] = _state(res)
        out["metrics"]["rescaled-2x2"] = [res["loss"], res["grad_norm"]]
        # (d) serving
        for case, (arch, shape) in SERVE_CASES.items():
            cfg = _cfg(arch)
            lm = LM(cfg, "cpu", mesh=meshes[shape]).init(
                torch.Generator().manual_seed(0))
            got = serve.serve_lm(lm, _prompts(cfg), SERVE_STEPS, window=64)
            out["tokens"][case] = got.tokens.numpy()
        # (f) refusals
        try:
            with mesh_mod.fake_world(RANKS):
                pass
        except RuntimeError as e:
            out["fake_inside"] = str(e)
        every = [None] * RANKS
        dist.all_gather_object(every, out["metrics"])
        out["every_rank_metrics"] = every
    out["group_left_up"] = dist.is_initialized()
    return out if rank == 0 else None


def _launch(out_path, tmp):
    """The launcher subprocess: RANKS ranks of ``_rank``; rank 0's results
    and whether a process group is up here afterwards, pickled."""
    import torch.distributed as dist
    res = mesh_mod.launch(_rank, (tmp,), n_ranks=RANKS)
    with open(out_path, "wb") as f:
        pickle.dump({"ranks": sorted(res), "out": res[0],
                     "launcher_group_up": dist.is_initialized()}, f)


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
# then STEPS jitted train steps on a 4x1 mesh of forced host devices, fed
# the port's batches (numpy); prints each step's metrics
_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
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
out_dir, batches, n = sys.argv[1], np.load(sys.argv[2]), int(sys.argv[3])
assert jax.device_count() == 4
cfg = get_config("hymba_1_5b").smoke().replace(dtype="float32")
mesh = jax.make_mesh((4, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
lm = LM(cfg, mesh)
metrics = []
with mesh:
    params = lm.init(jax.random.PRNGKey(0))
    opt = adamw.init(params)
    ckpt.save(out_dir, 0, {"params": params, "opt": opt},
              extra={"data_cursor": 0, "seed": 0, "arch": cfg.name,
                     "mesh": [4, 1]})
    step = jax.jit(steps.make_train_step(lm))
    for s in range(n):
        batch = {k: jnp.asarray(batches[f"{s}.{k}"])
                 for k in ("tokens", "labels")}
        params, opt, m = step(params, opt, batch)
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
print(json.dumps(metrics))
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's run, then the four ranks' (they resume from its
    checkpoint)."""
    tmp = tmp_path_factory.mktemp("host_mesh")
    data = SyntheticLM(DataConfig(seed=0, global_batch=GLOBAL_BATCH,
                                  seq_len=SEQ), _cfg("hymba_1_5b"))
    np.savez(tmp / "batches.npz", **{
        f"{s}.{k}": v for s in range(STEPS)
        for k, v in data.batch_at(s).items()})
    ref = _run([sys.executable, "-c", _REFERENCE, str(tmp / "reference"),
                str(tmp / "batches.npz"), str(STEPS)], 300)
    out = tmp / "ranks.pkl"
    _run([sys.executable, "-c",
          f"import sys; sys.path.insert(0, {TESTS!r}); "
          f"import test_torch_host_mesh as t; "
          f"t._launch({str(out)!r}, {str(tmp)!r})"], LAUNCH_TIMEOUT_S)
    with open(out, "rb") as f:
        got = pickle.load(f)
    got["reference"] = json.loads(ref.strip().splitlines()[-1])
    got["tmp"] = tmp
    return got


def _one_device_steps(arch):
    """Each step's (loss, grad_norm) of one-device ``train_loop`` runs of
    1..STEPS steps, and the STEPS-step run's final state."""
    metrics = []
    for k in range(1, STEPS + 1):
        res = train.train_loop(_cfg(arch), **_kw(steps=k))
        metrics.append([res["loss"], res["grad_norm"]])
    return metrics, _state(res)


@pytest.fixture(scope="module")
def one_device():
    return {arch: _one_device_steps(arch)
            for arch in ("hymba_1_5b", "deepseek_moe_16b")}


def _close_state(got, want, what):
    for part in ("params", "m", "v"):
        assert set(got[part]) == set(want[part])
        for k in want[part]:
            np.testing.assert_allclose(
                got[part][k], want[part][k], rtol=RTOL,
                atol=RTOL * float(np.abs(want[part][k]).max()),
                err_msg=f"{what} {part}/{k}")


def _same_state(got, want, what):
    for part in ("params", "m", "v"):
        assert set(got[part]) == set(want[part])
        for k in want[part]:
            assert np.array_equal(got[part][k], want[part][k]), \
                f"{what} {part}/{k}"


# ------------------------------------------------------------- (a) train
@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_loop_on_gloo_ranks_equals_one_device(case, world,
                                                    one_device):
    """Each step's loss and grad norm, and the final parameters and
    moments (each leaf within 1e-4 of its largest magnitude), agree with
    one device's within 1e-4 relative: the same weights (``LM.init``
    draws each whole leaf on a real mesh), the same batches (a data
    shard is a slice of the global batch), sums in another order."""
    arch, _ = TRAIN_CASES[case]
    want_metrics, want_state = one_device[arch]
    got = world["out"]["metrics"][case]
    np.testing.assert_allclose(got, want_metrics, rtol=RTOL, err_msg=case)
    _close_state(world["out"]["state"][case], want_state, case)


def test_loss_and_grad_norm_are_the_same_on_every_rank(world):
    every = world["out"]["every_rank_metrics"]
    assert len(every) == RANKS
    for rank, metrics in enumerate(every):
        assert metrics == every[0], rank


def test_the_world_is_the_host_mesh_and_no_group_stays_up(world):
    out = world["out"]
    assert world["ranks"] == list(range(RANKS))
    assert out["mesh"] == [["data", "model"], [4, 1]]
    assert not out["group_left_up"] and not world["launcher_group_up"]


# --------------------------------------------------------- (b) reference
def test_the_reference_on_the_same_4x1_mesh(world):
    """The port's ranks, resumed from the reference's step-0 checkpoint of
    its own weights and fed the same batches, take the reference's steps
    on its 4-device host mesh."""
    got = np.asarray(world["out"]["metrics"]["reference-4x1"])
    want = np.asarray(world["reference"])
    assert got.shape == want.shape == (STEPS, 2)
    np.testing.assert_allclose(got, want, rtol=REF_RTOL, atol=REF_ATOL)


# ----------------------------------------------------- (c) elastic restore
def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8).tobytes()


def test_a_4x1_checkpoint_restores_bit_for_bit_everywhere(world):
    """Written on 4x1: its manifest says so; restored on 2x2 (each rank
    slicing its shard), on one device and by the reference's ``restore``,
    every leaf is the same bits."""
    from repro.checkpoint import checkpoint as ref_ckpt
    root = str(world["tmp"] / "straight")
    plain, manifest = ckpt.restore(root, STEPS)
    assert manifest["extra"]["mesh"] == [4, 1]
    plain = {k: v.numpy() for k, v in ckpt._flatten(plain).items()}
    ref, ref_manifest = ref_ckpt.restore(root, STEPS)
    ref = ckpt._flatten(ref)
    on_2x2 = world["out"]["restored-2x2"]
    assert set(plain) == set(ref) == set(on_2x2)
    assert ref_manifest["extra"]["mesh"] == [4, 1]
    for k, v in plain.items():
        assert _bits(on_2x2[k]) == _bits(v) == _bits(np.asarray(ref[k])), k


def test_crash_and_resume_on_4x1_is_bit_exact(world):
    out = world["out"]
    assert out["crash"] == "injected failure at step 3"
    _same_state(out["state"]["resumed"], out["state"]["straight"], "resumed")
    # a chain of one-step runs, each resumed, lands on the same bits
    _same_state(out["state"]["hymba-4x1"], out["state"]["straight"], "chain")


def test_a_4x1_checkpoint_resumes_on_2x2(world, one_device):
    """Step 2's checkpoint of the 4x1 run, resumed on 2x2 for two more
    steps, is the one-device run within 1e-4."""
    want_metrics, want_state = one_device["hymba_1_5b"]
    np.testing.assert_allclose(world["out"]["metrics"]["rescaled-2x2"],
                               want_metrics[-1], rtol=RTOL)
    _close_state(world["out"]["state"]["rescaled-2x2"], want_state,
                 "rescaled")


# ------------------------------------------------------------- (d) serve
@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_served_tokens_on_gloo_ranks_equal_one_device(case, world):
    arch, _ = SERVE_CASES[case]
    cfg = _cfg(arch)
    lm = LM(cfg, "cpu").init(torch.Generator().manual_seed(0))
    want = serve.serve_lm(lm, _prompts(cfg), SERVE_STEPS, window=64)
    got = world["out"]["tokens"][case]
    assert got.shape == (4, SERVE_STEPS)
    assert np.array_equal(got, want.tokens.numpy()), case


# --------------------------------------------------------------- (e) CLI
_TORCHRUN = [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node", str(RANKS), "--rdzv-backend", "c10d",
             "--rdzv-endpoint", "127.0.0.1:0", "--local-addr", "127.0.0.1"]


def test_training_cli_under_torchrun(tmp_path, capsys):
    """Rank 0 alone prints the log lines and the final metrics, which
    agree with the one-device CLI's (bf16) within 2e-3; the checkpoint
    records [4, 1]."""
    args = ["--arch", "hymba_1_5b", "--smoke", "--steps", "3",
            "--global-batch", "4", "--seq-len", "16", "--device", "cpu"]
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
    assert manifest["extra"]["mesh"] == [4, 1]


def test_serving_cli_under_torchrun(capsys):
    args = ["--arch", "deepseek_moe_16b", "--smoke", "--batch", "4",
            "--steps", "5", "--device", "cpu"]
    out = _run(_TORCHRUN + ["-m", "repro_torch.launch.serve", *args],
               LAUNCH_TIMEOUT_S).splitlines()
    serve.main(args)
    want = capsys.readouterr().out.splitlines()
    assert [ln for ln in out if ln.startswith("  req")] == \
        [ln for ln in want if ln.startswith("  req")]
    assert sum(ln.startswith("decoded ") for ln in out) == 1


# ---------------------------------------------------------- (f) refusals
def test_a_fake_world_and_a_host_world_refuse_each_other(world,
                                                         monkeypatch):
    assert "cannot start beside it" in world["out"]["fake_inside"]
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with mesh_mod.fake_world(2):
        with pytest.raises(RuntimeError, match="cannot start beside it"):
            with mesh_mod.host_world():
                pass
    assert not torch.distributed.is_initialized()


def test_host_world_needs_a_world(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh_mod.world_env() is None
    assert mesh_mod.host_ranks() == 1          # the CPU runs one rank
    with pytest.raises(RuntimeError, match="no rank of a world"):
        with mesh_mod.host_world():
            pass
    assert not torch.distributed.is_initialized()
