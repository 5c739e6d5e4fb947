"""The port's training path on the CPU against the JAX package: the
rmsnorm custom VJP, ``LM.loss_fn`` and every gradient leaf on the smoke
configs of every family (remat on and off, labels of -1 included), a full
AdamW train step, microbatch accumulation, the synthetic data pipeline,
``train_loop``'s flags and the training CLI; and the flash repair (the
kernel has no backward, so it raises under autograd). Inputs are seeded
numpy arrays handed to both packages, in f32. The JAX side runs on an
Auto-axis mesh: under jax 0.9, ``make_host_mesh`` builds Explicit axes,
which the reference LM's ``with_sharding_constraint`` refuses (ROADMAP,
queue C)."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import repro_torch
from repro.configs import get_config as ref_get_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.launch import steps as ref_steps
from repro.models import layers as jl
from repro.models.model import LM as RefLM
from repro.optim import adamw as ref_adamw
from repro_torch.configs import get_config
from repro_torch.convert import (lm_params_from_numpy, lm_params_to_numpy,
                                 opt_state_from_numpy, opt_state_to_numpy)
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.launch import steps, train
from repro_torch.models import layers as tl
from repro_torch.models.model import LM
from repro_torch.optim import adamw

repro_torch.set_default_device("cpu")
torch.set_num_threads(1)

# f32 on both sides; products and sums in another order
ATOL, RTOL = 1e-5, 1e-4
# one of each family; internvl2_76b feeds tokens and prepended embeds
FAMILIES = ["minitron_8b", "deepseek_moe_16b", "mamba2_370m", "hymba_1_5b",
            "internvl2_76b"]
B, S = 2, 16


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _dotted(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_dotted(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _close(got, want, what, atol=ATOL, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


def _batch(cfg, seed=0, b=B, s=S):
    """A seeded batch for ``cfg`` with some labels of -1 (masked)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, :3] = -1
    labels[-1, -1] = -1
    out = {"labels": labels}
    if cfg.frontend != "audio_frames":
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.frontend != "none":
        n = s if cfg.frontend == "audio_frames" else cfg.frontend_len
        out["embeds"] = rng.standard_normal(
            (b, n, cfg.d_model)).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The JAX side of ``arch``'s smoke config in f32: params (numpy), a
    batch, and jax.value_and_grad of the reference's loss_fn on it."""
    cfg = ref_get_config(arch).smoke().replace(dtype="float32")
    mesh = _mesh()
    ref = RefLM(cfg, mesh)
    batch = _batch(cfg)
    with mesh:
        params = ref.init(jax.random.PRNGKey(0))
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            ref.loss_fn, has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    return (jax.tree.map(np.asarray, params), batch, float(loss),
            {k: float(v) for k, v in metrics.items()}, _dotted(grads))


def _port_lm(arch, params, **kw):
    cfg = get_config(arch).smoke().replace(dtype="float32", **kw)
    lm = LM(cfg)
    lm.load_state_dict(lm_params_from_numpy(params, cfg))
    return lm


# ------------------------------------------------------------ rmsnorm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_vjp_equals_the_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32) * 3
    w = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    dy = rng.standard_normal((3, 5, 32)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    y_ref, vjp = jax.vjp(lambda a, b: jl.rmsnorm(a, b, 1e-5),
                         jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    dx_ref, dw_ref = vjp(jnp.asarray(dy, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    wt = torch.from_numpy(w).to(tdt).requires_grad_(True)
    y = tl.rmsnorm(xt, wt, 1e-5)
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(dy).to(tdt))
    assert y.dtype == dx.dtype == dw.dtype == tdt     # the cotangent boundary
    for got, want, what in ((y, y_ref, "y"), (dx, dx_ref, "dx"),
                            (dw, dw_ref, "dw")):
        want = np.asarray(want, np.float32)
        got = got.detach().float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0,
                                       err_msg=what)
        else:
            # both round f32 math, summed in another order, to bf16 once:
            # a value near a rounding boundary may land one bf16 ulp away
            # (2^-7 of its binade), never more
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(
                np.abs(got), np.abs(want)) + 1e-30)) - 7)
            assert np.all(np.abs(got - want) <= ulp), what
            assert np.mean(got != want) < 0.05, what


def test_rmsnorm_forward_is_unchanged_for_serving():
    """Under no_grad the Function's forward is the plain formula, bit for
    bit, in bf16 and f32."""
    rng = np.random.default_rng(1)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.standard_normal((4, 64)).astype(
            np.float32)).to(dt)
        w = torch.from_numpy(rng.standard_normal(64).astype(np.float32)
                             ).to(dt)
        xf = x.float()
        want = (xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True)
                                 + 1e-5)).to(dt) * w
        with torch.no_grad():
            assert torch.equal(tl.rmsnorm(x, w, 1e-5), want)


# ------------------------------------------------------ loss and grads
@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_every_gradient_equal_the_reference(arch, remat):
    params, batch, loss_ref, metrics_ref, grads_ref = _reference(arch)
    lm = _port_lm(arch, params, remat=remat)
    loss, metrics, grads = steps.value_and_grad(lm, _torch_batch(batch))
    _close(loss, loss_ref, "loss")
    _close(metrics["ce"], metrics_ref["ce"], "ce")
    _close(metrics["aux"], metrics_ref["aux"], "aux")
    assert set(grads) == set(grads_ref)
    for name, g in grads.items():
        assert g.shape == grads_ref[name].shape, name
        _close(g, grads_ref[name], name)


def test_remat_recomputes_each_block():
    """With remat each block's forward runs twice in a backward (once more
    to rebuild what the block saved), without it once."""
    params, batch, *_ = _reference("minitron_8b")
    counts = {}
    for remat in (False, True):
        lm = _port_lm("minitron_8b", params, remat=remat)
        calls = []
        inner = lm._block

        def counting(*a, _inner=inner, _calls=calls, **k):
            _calls.append(1)
            return _inner(*a, **k)
        lm._block = counting
        steps.value_and_grad(lm, _torch_batch(batch))
        counts[remat] = len(calls)
    assert counts == {False: 2, True: 4}


def test_masked_labels_carry_no_loss():
    """A label of -1 contributes neither loss nor gradient: setting the
    masked positions' labels to anything else gives the same loss."""
    params, batch, *_ = _reference("minitron_8b")
    lm = _port_lm("minitron_8b", params)
    other = dict(batch, labels=np.where(batch["labels"] < 0, 5,
                                        batch["labels"]))
    keep = other["labels"].copy()
    keep[batch["labels"] < 0] = -1
    a, _, _ = steps.value_and_grad(lm, _torch_batch(batch))
    b, _, _ = steps.value_and_grad(lm, _torch_batch(dict(other,
                                                         labels=keep)))
    assert torch.equal(a, b)
    c, _, _ = steps.value_and_grad(lm, _torch_batch(other))
    assert not torch.equal(a, c)


def test_ssd_gradient_stays_finite_where_the_reference_overflows():
    """A chunk whose decay passes e^88 overflows exp(rel) above the
    diagonal; the reference masks after the exp, so its gradient is NaN
    there (0 * inf). The port masks before it: the same forward, and a
    finite gradient (ROADMAP, queue C). On a short chunk both agree."""
    rng = np.random.default_rng(2)
    b, h, p, n = 1, 2, 4, 3
    for s, dt0, ref_finite in ((256, 0.8, False), (16, 0.3, True)):
        x = rng.standard_normal((b, s, h, p)).astype(np.float32)
        dt = np.full((b, s, h), dt0, np.float32)
        Bm = rng.standard_normal((b, s, n)).astype(np.float32)
        Cm = rng.standard_normal((b, s, n)).astype(np.float32)
        A_log, D = np.zeros(h, np.float32), np.ones(h, np.float32)

        def ref_fn(x_, dt_):
            return jl.ssd_chunked(x_, dt_, A_log, Bm, Cm, D, s).sum()
        y_ref, (gx_ref, gdt_ref) = jax.value_and_grad(ref_fn, (0, 1))(
            jnp.asarray(x), jnp.asarray(dt))
        xt = torch.from_numpy(x).requires_grad_(True)
        dtt = torch.from_numpy(dt).requires_grad_(True)
        y = tl.ssd_chunked(xt, dtt, torch.from_numpy(A_log),
                           torch.from_numpy(Bm), torch.from_numpy(Cm),
                           torch.from_numpy(D), s).sum()
        gx, gdt = torch.autograd.grad(y, (xt, dtt))
        _close(y, y_ref, "y", rtol=1e-5)
        assert bool(torch.isfinite(gdt).all())
        assert bool(np.isfinite(np.asarray(gdt_ref)).all()) == ref_finite
        _close(gx, gx_ref, "dx", rtol=1e-4)
        if ref_finite:
            _close(gdt, gdt_ref, "ddt", atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------- train step
@pytest.mark.parametrize("arch", ["minitron_8b", "hymba_1_5b"])
def test_train_steps_equal_the_reference(arch):
    """Three AdamW steps on three batches: params, m, v, step and the
    metrics after each equal the JAX package's jitted make_train_step."""
    params, *_ = _reference(arch)
    rcfg = ref_get_config(arch).smoke().replace(dtype="float32")
    mesh = _mesh()
    ref = RefLM(rcfg, mesh)
    lm = _port_lm(arch, params)
    opt = adamw.init(dict(lm.named_parameters()))
    step = steps.make_train_step(lm)
    with mesh:
        rp = jax.tree.map(jnp.asarray, params)
        ropt = ref_adamw.init(rp)
        rstep = jax.jit(ref_steps.make_train_step(ref))
        for i in range(3):
            batch = _batch(rcfg, seed=10 + i)
            rp, ropt, rm = rstep(rp, ropt, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
            opt, m = step(opt, _torch_batch(batch))
            assert set(m) == set(rm)
            for k in rm:
                _close(m[k], rm[k], f"step {i} {k}")
    assert int(opt["step"]) == int(ropt["step"]) == 3
    got_p = _dotted(lm_params_to_numpy(lm))
    got_o = opt_state_to_numpy(opt)
    for name, want in _dotted(jax.tree.map(np.asarray, rp)).items():
        _close(got_p[name], want, name)
    for part in ("m", "v"):
        want = _dotted(jax.tree.map(np.asarray, ropt[part]))
        got = _dotted(got_o[part])
        assert set(got) == set(want)
        for name in want:
            _close(got[name], want[name], f"{part}/{name}")


def test_adamw_update_order_from_a_later_state():
    """One update from a non-zero state at step 7 with clipping active and
    every leaf decayed: equal to the reference's update (carried across
    with opt_state_from_numpy)."""
    rng = np.random.default_rng(3)
    p_np = {"a": {"w": rng.standard_normal((4, 3)).astype(np.float32)},
            "norm": rng.standard_normal(3).astype(np.float32)}
    g_np = {"a": {"w": 5 * rng.standard_normal((4, 3)).astype(np.float32)},
            "norm": rng.standard_normal(3).astype(np.float32)}
    m_np = jax.tree.map(lambda a: 0.1 * a, g_np)
    v_np = jax.tree.map(lambda a: 0.01 * a * a, g_np)
    cfg = ref_adamw.AdamWConfig()
    rp, ro, rm = ref_adamw.update(
        cfg, jax.tree.map(jnp.asarray, g_np),
        {"m": jax.tree.map(jnp.asarray, m_np),
         "v": jax.tree.map(jnp.asarray, v_np), "step": jnp.int32(7)},
        jax.tree.map(jnp.asarray, p_np))
    assert float(rm["grad_norm"]) > cfg.grad_clip       # clipping active
    flat = {k: torch.from_numpy(v.copy()) for k, v in _dotted(p_np).items()}
    state = {"m": {k: torch.from_numpy(v) for k, v in _dotted(m_np).items()},
             "v": {k: torch.from_numpy(v) for k, v in _dotted(v_np).items()},
             "step": torch.tensor(7, dtype=torch.int32)}
    grads = {k: torch.from_numpy(v) for k, v in _dotted(g_np).items()}
    state, m = adamw.update(adamw.AdamWConfig(), grads, state, flat)
    assert int(state["step"]) == 8
    _close(m["grad_norm"], rm["grad_norm"], "grad_norm")
    _close(m["lr"], rm["lr"], "lr")
    for name, want in _dotted(jax.tree.map(np.asarray, rp)).items():
        _close(flat[name], want, name, atol=1e-7, rtol=1e-6)
    for part in ("m", "v"):
        for name, want in _dotted(jax.tree.map(np.asarray, ro[part])).items():
            _close(state[part][name], want, f"{part}/{name}", atol=1e-7,
                   rtol=1e-6)


def test_opt_state_roundtrips_through_numpy():
    cfg = get_config("hymba_1_5b").smoke()
    lm = LM(cfg).init(torch.Generator().manual_seed(0))
    state = adamw.init(dict(lm.named_parameters()))
    for k in state["m"]:
        state["m"][k].normal_()
        state["v"][k].uniform_()
    state["step"].fill_(5)
    back = opt_state_from_numpy(opt_state_to_numpy(state), cfg)
    assert int(back["step"]) == 5 and back["step"].dtype == torch.int32
    for part in ("m", "v"):
        assert set(back[part]) == set(state[part])
        for k, t in state[part].items():
            assert torch.equal(back[part][k], t), k
    bad = opt_state_to_numpy(state)
    bad["m"]["embed"] = bad["m"]["embed"][:1]
    with pytest.raises(ValueError, match="embed"):
        opt_state_from_numpy(bad, cfg)


def test_grad_accumulation_matches_single_shot():
    """accum_steps=4 gives the update of accum_steps=1 (the reference's own
    check, tests/test_scale_features.py, on the port)."""
    cfg = get_config("qwen1_5_32b").smoke().replace(dtype="float32")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
                 rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)),
             "labels": torch.from_numpy(
                 rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32))}
    out = {}
    for a in (1, 4):
        lm = LM(cfg.replace(accum_steps=a)).init(
            torch.Generator().manual_seed(0))
        opt = adamw.init(dict(lm.named_parameters()))
        _, m = steps.make_train_step(lm)(opt, batch)
        out[a] = (float(m["loss"]), lm.state_dict())
    assert abs(out[1][0] - out[4][0]) < 1e-4
    for k, t in out[1][1].items():
        _close(out[4][1][k], t.numpy(), k, atol=1e-5, rtol=1e-5)


def test_accumulated_gradients_equal_the_reference():
    """accum_steps=2: the f32 accumulated gradients and the mean loss equal
    the reference's scan over microbatches."""
    arch = "minitron_8b"
    params, *_ = _reference(arch)
    rcfg = ref_get_config(arch).smoke().replace(dtype="float32",
                                               accum_steps=2)
    mesh = _mesh()
    ref = RefLM(rcfg, mesh)
    batch = _batch(rcfg, seed=4, b=4)
    with mesh:
        rp, ropt, rm = jax.jit(ref_steps.make_train_step(ref))(
            jax.tree.map(jnp.asarray, params),
            ref_adamw.init(jax.tree.map(jnp.asarray, params)),
            {k: jnp.asarray(v) for k, v in batch.items()})
    lm = _port_lm(arch, params, accum_steps=2)
    opt, m = steps.make_train_step(lm)(
        adamw.init(dict(lm.named_parameters())), _torch_batch(batch))
    for k in ("loss", "ce", "aux", "grad_norm"):
        _close(m[k], rm[k], k)
    got = _dotted(lm_params_to_numpy(lm))
    for name, want in _dotted(jax.tree.map(np.asarray, rp)).items():
        _close(got[name], want, name)


# ----------------------------------------------------------------- data
def test_data_pipeline_stateless_and_sharded():
    cfg = get_config("minitron_8b").smoke()
    data = SyntheticLM(DataConfig(seed=1, global_batch=8, seq_len=16), cfg)
    a, b = data.batch_at(5), data.batch_at(5)
    assert np.array_equal(a["tokens"], b["tokens"])          # deterministic
    assert np.array_equal(a["labels"], b["labels"])
    assert not np.array_equal(a["tokens"], data.batch_at(6)["tokens"])
    again = SyntheticLM(DataConfig(seed=1, global_batch=8, seq_len=16), cfg)
    assert np.array_equal(again.batch_at(5)["tokens"], a["tokens"])
    other = SyntheticLM(DataConfig(seed=2, global_batch=8, seq_len=16), cfg)
    assert not np.array_equal(other.batch_at(5)["tokens"], a["tokens"])
    s0 = data.batch_at(5, shard=0, n_shards=2)
    s1 = data.batch_at(5, shard=1, n_shards=2)
    assert s0["tokens"].shape == s1["tokens"].shape == (4, 15)
    assert not np.array_equal(s0["tokens"], s1["tokens"])
    assert np.array_equal(data.batch_at(5, shard=1, n_shards=2)["tokens"],
                          s1["tokens"])
    it = data.iterate(start_step=5)
    assert np.array_equal(next(it)["tokens"], a["tokens"])
    assert np.array_equal(next(it)["tokens"], data.batch_at(6)["tokens"])


def test_data_pipeline_rejects_a_shard_count_that_does_not_divide():
    cfg = get_config("minitron_8b").smoke()
    data = SyntheticLM(DataConfig(global_batch=8, seq_len=16), cfg)
    with pytest.raises(ValueError, match="shards"):
        data.batch_at(0, shard=0, n_shards=3)
    with pytest.raises(ValueError):
        data.batch_at(-1)


def test_data_stream_structure():
    """Labels are the inputs shifted by one, and each step of the stream
    adds 0..16 modulo the vocabulary."""
    cfg = get_config("minitron_8b").smoke()
    bt = SyntheticLM(DataConfig(seed=3, global_batch=4, seq_len=32),
                     cfg).batch_at(2)
    toks, labels = bt["tokens"], bt["labels"]
    assert toks.dtype == labels.dtype == np.int32
    assert np.array_equal(toks[:, 1:], labels[:, :-1])
    d = (labels[:, -1:] - toks[:, -1:]) % cfg.vocab
    assert ((d >= 0) & (d < 17)).all()
    steps_ = np.diff(toks.astype(np.int64), axis=1) % cfg.vocab
    assert ((steps_ >= 0) & (steps_ < 17)).all()
    assert ((toks >= 0) & (toks < cfg.vocab)).all()


@pytest.mark.parametrize("arch", ["minitron_8b", "musicgen_large",
                                  "internvl2_76b"])
def test_data_batches_have_the_reference_shapes(arch):
    """Keys, shapes and dtypes of a batch equal the reference's for each
    frontend (none, audio frames, vision patches); the values differ (the
    generators differ, ROADMAP queue C)."""
    cfg = get_config(arch).smoke()
    rcfg = ref_get_config(arch).smoke()
    got = SyntheticLM(DataConfig(seed=0, global_batch=4, seq_len=12),
                      cfg).batch_at(3, shard=1, n_shards=2)
    want = RefSyntheticLM(RefDataConfig(seed=0, global_batch=4, seq_len=12),
                          rcfg).batch_at(3, shard=1, n_shards=2)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k


# ---------------------------------------------------------- train loop
def test_train_loop_flags(capsys):
    """fail_at raises the reference's message; skip_anomalous_grads counts
    the steps over the limit and, as the reference does, keeps their
    update (ROADMAP queue C): the parameters equal a run without it."""
    cfg = get_config("minitron_8b").smoke()
    kw = dict(steps=3, global_batch=2, seq_len=8, log_every=1)
    with pytest.raises(RuntimeError, match="injected failure at step 1"):
        train.train_loop(cfg, fail_at=1, **kw)
    plain = train.train_loop(cfg, **kw)
    skipping = train.train_loop(cfg, skip_anomalous_grads=True,
                                grad_norm_limit=0.0, **kw)
    assert plain["skipped_steps"] == 0 and skipping["skipped_steps"] == 3
    for k, t in plain["params"].items():
        assert torch.equal(skipping["params"][k], t), k
    assert skipping["loss"] == plain["loss"]
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == [ln for ln in lines[:2] if ln.startswith("step ")]
    assert lines[0].startswith("step 0: loss=") and " gnorm=" in lines[0]


def test_training_cli(capsys):
    train.main(["--arch", "hymba_1_5b", "--smoke", "--steps", "3",
                "--global-batch", "2", "--seq-len", "16", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    final = json.loads(out[-1])
    assert set(final) == {"ce", "aux", "loss", "grad_norm", "lr",
                          "skipped_steps"}
    assert np.isfinite(final["loss"]) and final["skipped_steps"] == 0
    assert [ln.split(":")[0] for ln in out[:-1]] == ["step 0", "step 2"]


def test_loss_falls():
    """Sixty steps on the synthetic stream at a raised learning rate (the
    default warms up over 100 steps): the last steps' loss is well below
    the first's."""
    cfg = get_config("minitron_8b").smoke().replace(dtype="float32")
    lm = LM(cfg).init(torch.Generator().manual_seed(0))
    data = SyntheticLM(DataConfig(seed=0, global_batch=8, seq_len=32), cfg)
    opt = adamw.init(dict(lm.named_parameters()))
    step = steps.make_train_step(lm, adamw.AdamWConfig(lr=1e-2,
                                                       warmup_steps=1))
    losses = []
    for s in range(60):
        opt, m = step(opt, _torch_batch(data.batch_at(s)))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < losses[0] - 1.0, losses


# --------------------------------------------------------- flash repair
def _qkv(requires_grad):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 8, 16, generator=g)
    k = torch.randn(1, 2, 8, 16, generator=g)
    v = torch.randn(1, 2, 8, 16, generator=g)
    return tuple(t.requires_grad_(requires_grad) for t in (q, k, v))


@pytest.mark.parametrize("which", [0, 1, 2])
def test_flash_raises_under_autograd(which):
    q, k, v = _qkv(False)
    args = [q, k, v]
    args[which] = args[which].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="blockwise"):
        flash_attention(*args, causal=True)
    with torch.no_grad():
        out = flash_attention(*args, causal=True)
    assert torch.equal(out, attention_ref(q, k, v, causal=True))


def test_flash_without_grad_equals_its_plain_version():
    q, k, v = _qkv(False)
    assert torch.equal(flash_attention(q, k, v, causal=True, window=4),
                       attention_ref(q, k, v, causal=True, window=4))


def test_flash_attention_layer_and_loss_raise_under_autograd():
    """attention_layer(impl="flash") and a training step of an LM with
    attn_impl="flash" raise the named error; blockwise trains."""
    cfg = get_config("minitron_8b").smoke().replace(dtype="float32",
                                                   attn_impl="flash")
    lm = LM(cfg).init(torch.Generator().manual_seed(0))
    batch = _torch_batch(_batch(cfg))
    with pytest.raises(NotImplementedError, match="blockwise"):
        steps.value_and_grad(lm, batch)
    lp = lm._layers()[0]
    x = torch.randn(B, S, cfg.d_model)
    pos = torch.arange(S)[None].expand(B, S)
    with pytest.raises(NotImplementedError, match="reference"):
        tl.attention_layer(cfg, lm.plan, lp["attn"], x, pos, impl="flash")
    with torch.no_grad():
        got, _ = tl.attention_layer(cfg, lm.plan, lp["attn"], x, pos,
                                    impl="flash")
        want, _ = tl.attention_layer(cfg, lm.plan, lp["attn"], x, pos,
                                     impl="blockwise")
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    lm.cfg = cfg.replace(attn_impl="blockwise")
    loss, _, _ = steps.value_and_grad(lm, batch)
    assert bool(torch.isfinite(loss))


def test_prefill_and_decode_steps_wrap_the_lm():
    cfg = get_config("hymba_1_5b").smoke().replace(dtype="float32")
    lm = LM(cfg).init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_batch(cfg)["tokens"])
    assert torch.equal(steps.make_prefill_step(lm)({"tokens": toks}),
                       lm.prefill(toks))
    _, c1 = lm.prefill_with_cache(toks)
    _, c2 = lm.prefill_with_cache(toks)
    got, _ = steps.make_decode_step(lm)(c1, toks[:, -1:], S)
    want, _ = lm.decode_step(c2, toks[:, -1:], S)
    assert torch.equal(got, want)
