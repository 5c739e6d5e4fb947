"""The port's checkpoints and crash/resume on the CPU: the reference's
on-disk format (save/restore with bf16 and 0-d leaves, chunks, retention,
an interrupted write never visible), each package restoring the other's
checkpoint (a bare tree, and a training state that the other package's
LM then evaluates), and ``train_loop``'s crash-and-resume bit-exact
against an uninterrupted run (the reference's contract,
``tests/test_checkpoint.py``). The JAX side runs on an Auto-axis mesh
(ROADMAP, queue C)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import repro_torch
from repro.checkpoint import checkpoint as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.launch import steps as ref_steps
from repro.models.model import LM as RefLM
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.launch import train
from repro_torch.models.model import LM

repro_torch.set_default_device("cpu")
torch.set_num_threads(1)


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _bits(t):
    """A leaf's raw bytes and dtype name, from torch or numpy (bf16 of
    either as its 16-bit pattern)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().tobytes(), "bfloat16"
        return t.numpy().tobytes(), str(t.numpy().dtype)
    a = np.asarray(t)
    return a.tobytes(), a.dtype.name


def _tree():
    return {"a": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                  "b16": torch.full((4, 2), 1.5, dtype=torch.bfloat16)
                  + torch.arange(8).reshape(4, 2).to(torch.bfloat16) / 64},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_save_restore_roundtrip(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 3, tree, extra={"data_cursor": 3}, chunks=2)
    got, manifest = ckpt.restore(str(tmp_path))
    assert manifest["step"] == 3 and manifest["extra"]["data_cursor"] == 3
    assert manifest["index"]["a/b16"] == {"dtype": "bfloat16",
                                          "shape": [4, 2], "chunks": 2}
    assert manifest["index"]["step"] == {"dtype": "int32", "shape": [],
                                         "chunks": 1}
    for path, t in _flat(tree).items():
        assert _bits(_flat(got)[path]) == _bits(t), path
    assert got["a"]["b16"].dtype == torch.bfloat16
    assert got["step"].shape == () and got["step"].dtype == torch.int32
    names = sorted(os.listdir(tmp_path / "ckpt_00000003"))
    assert names == ["a.b16.0.npy", "a.b16.1.npy", "a.w.0.npy", "a.w.1.npy",
                     "manifest.json", "step.0.npy"]


def test_restore_places_on_a_device_and_raises_without_checkpoints(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    got, _ = ckpt.restore(str(tmp_path), device="cpu")
    assert got["a"]["w"].device == torch.device("cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"))


def test_latest_and_retention(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, {"x": torch.ones(2)}, keep_last=3)
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert ckpt.all_steps(str(tmp_path)) == [3, 4, 5]
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def test_interrupted_write_is_invisible(tmp_path):
    """A .tmp dir (killed writer) and a directory without its manifest are
    never picked up."""
    ckpt.save(str(tmp_path), 1, {"x": torch.ones(2)})
    os.makedirs(os.path.join(str(tmp_path), "ckpt_00000002.tmp"))
    os.makedirs(os.path.join(str(tmp_path), "ckpt_00000003"))
    assert ckpt.latest_step(str(tmp_path)) == 1
    # a rewrite of step 2 clears the stale .tmp and publishes
    ckpt.save(str(tmp_path), 2, {"x": torch.zeros(2)})
    assert ckpt.all_steps(str(tmp_path)) == [1, 2]
    assert not os.path.exists(os.path.join(str(tmp_path),
                                           "ckpt_00000002.tmp"))


def test_the_reference_restores_the_ports_checkpoint(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 4, tree, extra={"seed": 1}, chunks=2)
    got, manifest = ref_ckpt.restore(str(tmp_path))
    assert manifest["extra"] == {"seed": 1}
    for path, t in _flat(tree).items():
        assert _bits(_flat(got)[path]) == _bits(t), path


def test_the_port_restores_the_references_checkpoint(tmp_path):
    tree = {"a": {"w": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
                  "b16": jnp.ones((4, 2), jnp.bfloat16) * 1.5},
            "step": jnp.int32(7)}
    ref_ckpt.save(str(tmp_path), 2, tree, chunks=2)
    got, manifest = ckpt.restore(str(tmp_path))
    assert manifest["step"] == 2
    for path, t in _flat(tree).items():
        assert _bits(_flat(got)[path]) == _bits(t), path
    assert got["a"]["b16"].dtype == torch.bfloat16


def _eval_batch(cfg):
    rng = np.random.default_rng(5)
    return {"tokens": rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)}


def test_a_reference_training_state_resumes_in_the_port(tmp_path):
    """The reference trains one step and checkpoints params and AdamW
    state; the port's train_loop resumes from it (params, m, v, step and
    the data cursor), and its restored LM gives the reference's loss."""
    arch = "hymba_1_5b"
    rcfg = ref_get_config(arch).smoke().replace(dtype="float32")
    mesh = _mesh()
    ref = RefLM(rcfg, mesh)
    batch = _eval_batch(rcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with mesh:
        params = ref.init(jax.random.PRNGKey(0))
        params, opt, _ = jax.jit(ref_steps.make_train_step(ref))(
            params, ref_adamw.init(params), jb)
        want, _ = ref.loss_fn(params, jb)
    ref_ckpt.save(str(tmp_path), 1, {"params": params, "opt": opt},
                  extra={"data_cursor": 1, "seed": 0, "arch": rcfg.name,
                         "mesh": [1, 1]})
    state, _ = ckpt.restore(str(tmp_path))
    cfg = get_config(arch).smoke().replace(dtype="float32")
    lm = LM(cfg)
    lm.load_state_dict(lm_params_from_numpy(
        jax.tree.map(lambda t: t.numpy(), state["params"]), cfg))
    with torch.no_grad():
        got, _ = lm.loss_fn({k: torch.from_numpy(v)
                             for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    out = train.train_loop(cfg, steps=3, global_batch=2, seq_len=8,
                           ckpt_dir=str(tmp_path), ckpt_every=1, resume=True,
                           log_every=0)
    assert np.isfinite(out["loss"])
    final, manifest = ckpt.restore(str(tmp_path))
    assert int(final["opt"]["step"]) == 3
    assert manifest["extra"] == {"data_cursor": 3, "seed": 0,
                                 "arch": cfg.name, "mesh": [1, 1]}


def test_a_port_training_state_restores_in_the_reference(tmp_path):
    """The port trains two steps and checkpoints; the reference restores
    the tree, its LM gives the port's loss on the trained params, and one
    reference train step runs from the restored AdamW state."""
    arch = "minitron_8b"
    cfg = get_config(arch).smoke().replace(dtype="float32")
    out = train.train_loop(cfg, steps=2, global_batch=2, seq_len=8,
                           ckpt_dir=str(tmp_path), ckpt_every=2, log_every=0)
    lm = LM(cfg)
    lm.load_state_dict(out["params"])
    batch = _eval_batch(cfg)
    with torch.no_grad():
        want, _ = lm.loss_fn({k: torch.from_numpy(v)
                              for k, v in batch.items()})
    state, manifest = ref_ckpt.restore(str(tmp_path))
    assert manifest["extra"]["data_cursor"] == 2
    assert set(_flat(state["params"])) == {
        k.replace(".", "/") for k in lm.state_dict()}
    rcfg = ref_get_config(arch).smoke().replace(dtype="float32")
    mesh = _mesh()
    ref = RefLM(rcfg, mesh)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with mesh:
        params = jax.tree.map(jnp.asarray, state["params"])
        opt = jax.tree.map(jnp.asarray, state["opt"])
        got, _ = ref.loss_fn(params, jb)
        _, opt2, m = jax.jit(ref_steps.make_train_step(ref))(params, opt, jb)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert int(opt2["step"]) == 3 and np.isfinite(float(m["loss"]))
    # the port's params as a JAX tree equal what the reference restored
    mine = _flat(lm_params_to_numpy(lm))
    for path, a in _flat(state["params"]).items():
        assert np.array_equal(mine[path], np.asarray(a)), path


@pytest.mark.parametrize("arch", ["minitron_8b", "hymba_1_5b",
                                  "deepseek_moe_16b"])
def test_crash_resume_is_bitwise_exact(tmp_path, arch):
    """Train 8 steps (bf16, the smoke config's dtype) with a crash at 5 and
    a resume == train 8 uninterrupted: params, m, v, step and the final
    loss, bit for bit."""
    cfg = get_config(arch).smoke()
    kw = dict(steps=8, global_batch=4, seq_len=16, ckpt_every=2, log_every=0)
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        train.train_loop(cfg, ckpt_dir=d1, fail_at=5, **kw)
    assert ckpt.latest_step(d1) == 4
    resumed = train.train_loop(cfg, ckpt_dir=d1, resume=True, **kw)
    straight = train.train_loop(cfg, ckpt_dir=d2, **kw)
    p1, p2 = resumed.pop("params"), straight.pop("params")
    assert set(p1) == set(p2)
    for k in p1:
        assert _bits(p1[k]) == _bits(p2[k]), k
    o1, o2 = resumed.pop("opt_state"), straight.pop("opt_state")
    assert int(o1["step"]) == int(o2["step"]) == 8
    for part in ("m", "v"):
        assert set(o1[part]) == set(o2[part]) == set(p1)
        for k in o1[part]:
            assert _bits(o1[part][k]) == _bits(o2[part][k]), (part, k)
    assert resumed == straight
    s1, m1 = ckpt.restore(d1)
    s2, m2 = ckpt.restore(d2)
    assert m1["extra"] == m2["extra"] and m1["step"] == m2["step"] == 8
    f1, f2 = _flat(s1), _flat(s2)
    assert set(f1) == set(f2)
    for k in f1:
        assert _bits(f1[k]) == _bits(f2[k]), k
    assert int(s1["opt"]["step"]) == 8


def test_manifest_is_the_references_layout(tmp_path):
    """A training checkpoint's leaf paths, dtypes and extra keys are the
    reference's: params/..., opt/m/..., opt/v/..., opt/step."""
    cfg = get_config("hymba_1_5b").smoke()
    train.train_loop(cfg, steps=1, global_batch=2, seq_len=8,
                     ckpt_dir=str(tmp_path), ckpt_every=1, log_every=0)
    with open(tmp_path / "ckpt_00000001" / "manifest.json") as f:
        manifest = json.load(f)
    rcfg = ref_get_config("hymba_1_5b").smoke()
    ref = RefLM(rcfg, _mesh())
    shapes = _flat(ref.param_shapes())
    want = {f"params/{k}": (str(v.dtype), list(v.shape))
            for k, v in shapes.items()}
    for part in ("m", "v"):
        want.update({f"opt/{part}/{k}": ("float32", list(v.shape))
                     for k, v in shapes.items()})
    want["opt/step"] = ("int32", [])
    got = {k: (v["dtype"], v["shape"]) for k, v in manifest["index"].items()}
    # the reference keeps dt_bias, A_log and D in f32 whatever the dtype
    for k in want:
        if k.split("/")[-1] in ("dt_bias", "A_log", "D") and \
                k.startswith("params/"):
            want[k] = ("float32", want[k][1])
    assert got == want
    assert manifest["extra"] == {"data_cursor": 1, "seed": 0,
                                 "arch": cfg.name, "mesh": [1, 1]}
