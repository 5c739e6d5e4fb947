"""The port's LM slice on the CPU against the JAX package: the configs and
the head plan, each ported layer function, and the whole serving path
(``prefill_with_cache`` then ``decode_step``s) on the smoke configs in
f32, with the JAX parameter tree carried across by
``convert.lm_params_from_numpy``. Inputs are seeded numpy arrays handed to
both packages. The JAX side runs on an Auto-axis mesh: under jax 0.9,
``make_host_mesh`` builds Explicit axes, which the reference LM's
``with_sharding_constraint`` refuses (ROADMAP, queue C)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import repro_torch
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import canonical as ref_canonical
from repro.configs import get_config as ref_get_config
from repro.models import layers as jl
from repro.models.config import SHAPES as REF_SHAPES
from repro.models.config import shape_applicable as ref_shape_applicable
from repro.models.model import LM as RefLM
from repro.models.sharding import pad_to as ref_pad_to
from repro.models.sharding import plan_attention as ref_plan
from repro_torch.configs import ARCHS, all_configs, canonical, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import layers as tl
from repro_torch.models.config import SHAPES, shape_applicable
from repro_torch.models.model import LM, param_shapes
from repro_torch.models.sharding import pad_to, plan_attention

repro_torch.set_default_device("cpu")
torch.set_num_threads(1)

# f32 on both sides; products and sums in another order
ATOL, RTOL = 1e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _pair(arch, **kw):
    """The reference LM with initialised params and the port's LM holding
    the same weights, both in f32 on the smoke config of ``arch``."""
    rcfg = ref_get_config(arch).smoke().replace(dtype="float32", **kw)
    pcfg = get_config(arch).smoke().replace(dtype="float32", **kw)
    mesh = _mesh()
    ref = RefLM(rcfg, mesh)
    with mesh:
        params = ref.init(jax.random.PRNGKey(0))
    lm = LM(pcfg)
    lm.load_state_dict(lm_params_from_numpy(
        jax.tree.map(np.asarray, params), pcfg))
    return mesh, ref, params, lm


# ------------------------------------------------------------ configs
def test_configs_equal_the_reference():
    assert ARCHS == REF_ARCHS
    for arch, cfg in all_configs().items():
        ref = ref_get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref), arch
        assert dataclasses.asdict(cfg.smoke()) == \
            dataclasses.asdict(ref.smoke()), arch
        assert (cfg.d_head_total, cfg.is_attention_free, cfg.has_ssm,
                cfg.subquadratic) == (ref.d_head_total, ref.is_attention_free,
                                      ref.has_ssm, ref.subquadratic)
        for shape in SHAPES:
            assert shape_applicable(cfg, SHAPES[shape]) == \
                ref_shape_applicable(ref, REF_SHAPES[shape])
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    assert canonical("hymba-1.5b") == ref_canonical("hymba-1.5b")
    with pytest.raises(KeyError):
        canonical("no_such_arch")


@pytest.mark.parametrize("tp", [1, 2, 4, 8, 16])
def test_head_plan_equals_the_reference(tp):
    for cfg in all_configs().values():
        if cfg.is_attention_free:
            continue
        assert dataclasses.asdict(plan_attention(cfg.n_heads, cfg.n_kv_heads,
                                                 tp)) == \
            dataclasses.asdict(ref_plan(cfg.n_heads, cfg.n_kv_heads, tp))
    assert [pad_to(n, tp) for n in (1, 31, 32001)] == \
        [ref_pad_to(n, tp) for n in (1, 31, 32001)]


def test_param_shapes_and_dead_head_mask_equal_the_reference():
    """Every config (published widths, no allocation), the MoE family
    included: the port's parameter names and shapes are the reference
    tree's, and the dead-head mask at tp=1 is the reference's."""
    mesh = _mesh()
    for arch, cfg in all_configs().items():
        ref = RefLM(ref_get_config(arch), mesh)
        want = {}
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                ref.param_shapes()):
            want[".".join(p.key for p in path)] = tuple(leaf.shape)
        got = {k: tuple(s) for k, (s, _) in param_shapes(cfg).items()}
        assert got == want, arch
        if not cfg.is_attention_free:
            lm = LM(cfg.smoke())
            ref_smoke = RefLM(ref_get_config(arch).smoke(), mesh)
            np.testing.assert_array_equal(
                lm._dead_head_mask().numpy(),
                np.asarray(ref_smoke._dead_head_mask()))


# ------------------------------------------------------------- layers
def test_rmsnorm_and_rope_match():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, 3, 16).astype(np.float32)
    w = rng.rand(16).astype(np.float32)
    _close(tl.rmsnorm(_t(x), _t(w), 1e-5),
           jl.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    pos = np.broadcast_to(np.arange(7) + 5, (2, 7)).astype(np.int32)
    _close(tl.rope(_t(x), _t(pos), 10000.0),
           jl.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    # bf16 in: the norm and RoPE compute in f32 and round once
    xb = jnp.asarray(x, jnp.bfloat16)
    tb = _t(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    for got, want in ((tl.rmsnorm(tb, _t(w).to(torch.bfloat16), 1e-5),
                       jl.rmsnorm(xb, jnp.asarray(w, jnp.bfloat16), 1e-5)),
                      (tl.rope(tb, _t(pos), 500000.0),
                       jl.rope(xb, jnp.asarray(pos), 500000.0))):
        assert got.dtype == torch.bfloat16
        _close(got, want.astype(jnp.float32), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("window,sk", [(0, 70), (24, 70), (0, 600)])
def test_naive_and_blockwise_attention_match(window, sk):
    """sk=600 crosses the 512-key block (the padded last block)."""
    rng = np.random.RandomState(sk + window)
    b, sq, h, kv, d = 2, 9, 6, 2, 16
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k = rng.randn(b, sk, kv, d).astype(np.float32)
    v = rng.randn(b, sk, kv, d).astype(np.float32)
    qpos = np.broadcast_to(np.arange(sq) + sk - sq, (b, sq)).astype(np.int32)
    kpos = np.broadcast_to(np.arange(sk), (b, sk)).astype(np.int32).copy()
    kpos[:, :3] = 2 ** 30                       # stale ring slots
    args = [q, k, v, qpos, kpos]
    for tfn, jfn in ((tl.naive_attention, jl.naive_attention),
                     (tl.blockwise_attention, jl.blockwise_attention)):
        _close(tfn(*map(_t, args), window=window),
               jfn(*map(jnp.asarray, args), window=window))


def _attn_params(rng, cfg, plan, bias):
    d, hd = cfg.d_model, cfg.head_dim
    p = {"wq": rng.randn(d, plan.h_pad * hd), "wk": rng.randn(
        d, plan.kv_virtual * hd), "wv": rng.randn(d, plan.kv_virtual * hd),
        "wo": rng.randn(plan.h_pad * hd, d)}
    if bias:
        p.update(bq=rng.randn(plan.h_pad * hd), bk=rng.randn(
            plan.kv_virtual * hd), bv=rng.randn(plan.kv_virtual * hd))
    return {k: (v * 0.1).astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("impl", ["flash", "blockwise", "naive"])
@pytest.mark.parametrize("arch", ["hymba_1_5b", "qwen1_5_32b"])
def test_attention_layer_matches(impl, arch):
    """Prefill (the flash path where asked) and a decode call over a ring
    buffer with stale slots; qwen brings the qkv biases."""
    cfg = get_config(arch).smoke().replace(dtype="float32")
    plan = plan_attention(cfg.n_heads, cfg.n_kv_heads, 1)
    rng = np.random.RandomState(1)
    p = _attn_params(rng, cfg, plan, cfg.qkv_bias)
    b, s = 2, 21
    x = rng.randn(b, s, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    window = cfg.attn_window
    tp = {k: _t(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    got, gkv = tl.attention_layer(cfg, plan, tp, _t(x), _t(pos),
                                  window=window, impl=impl)
    want, wkv = jl.attention_layer(cfg, plan, jp, jnp.asarray(x),
                                   jnp.asarray(pos), window=window, impl=impl)
    _close(got, want)
    _close(gkv["k"], wkv["k"])
    _close(gkv["v"], wkv["v"])
    ring = 16
    cache = {"k": rng.randn(b, ring, plan.kv_virtual, cfg.head_dim),
             "v": rng.randn(b, ring, plan.kv_virtual, cfg.head_dim),
             "pos": np.where(np.arange(ring) < 12, np.arange(ring) + 9,
                             2 ** 30)[None].repeat(b, 0)}
    cache = {k: v.astype(np.int32 if k == "pos" else np.float32)
             for k, v in cache.items()}
    x1 = x[:, :1]
    t = np.full((b, 1), 21, np.int32)
    got, _ = tl.attention_layer(cfg, plan, tp, _t(x1), _t(t),
                                {k: _t(v) for k, v in cache.items()},
                                window=window, impl="blockwise")
    want, _ = jl.attention_layer(cfg, plan, jp, jnp.asarray(x1),
                                 jnp.asarray(t),
                                 {k: jnp.asarray(v) for k, v in cache.items()},
                                 window=window, impl="blockwise")
    _close(got, want)


@pytest.mark.parametrize("bias", [False, True])
def test_swiglu_matches(bias):
    rng = np.random.RandomState(2)
    d, f = 16, 40
    p = {"w_gate": rng.randn(d, f), "w_up": rng.randn(d, f),
         "w_down": rng.randn(f, d), "b_gate": rng.randn(f),
         "b_up": rng.randn(f), "b_down": rng.randn(d)}
    p = {k: (v * 0.2).astype(np.float32) for k, v in p.items()}
    x = rng.randn(2, 5, d).astype(np.float32)
    _close(tl.swiglu({k: _t(v) for k, v in p.items()}, _t(x), bias=bias),
           jl.swiglu({k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x), bias=bias))


def test_ssd_decode_step_and_causal_conv_match():
    rng = np.random.RandomState(3)
    b, h, p, n, f, k = 2, 3, 4, 5, 6, 4
    state = rng.randn(b, h, p, n).astype(np.float32)
    args = [rng.randn(b, h, p), rng.rand(b, h), rng.rand(h),
            rng.randn(b, n), rng.randn(b, n), rng.rand(h)]
    args = [state] + [a.astype(np.float32) for a in args]
    for g, w in zip(tl.ssd_decode_step(*map(_t, args)),
                    jl.ssd_decode_step(*map(jnp.asarray, args))):
        _close(g, w)
    x = rng.randn(b, 7, f).astype(np.float32)
    wc = rng.randn(k, f).astype(np.float32)
    prev = rng.randn(b, k - 1, f).astype(np.float32)
    for pv in (None, prev):
        got = tl._causal_conv(_t(x), _t(wc), None if pv is None else _t(pv))
        want = jl._causal_conv(jnp.asarray(x), jnp.asarray(wc),
                               None if pv is None else jnp.asarray(pv))
        for g, w in zip(got, want):
            _close(g, w)


def _ssm_params(rng, cfg):
    d, h, hp, n = cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di = h * hp
    shapes = {"w_z": (d, di), "w_x": (d, di), "w_B": (d, n), "w_C": (d, n),
              "w_dt": (d, h), "conv_x": (cfg.d_conv, di),
              "conv_B": (cfg.d_conv, n), "conv_C": (cfg.d_conv, n),
              "dt_bias": (h,), "A_log": (h,), "D": (h,), "norm": (di,),
              "w_out": (di, d)}
    return {k: (rng.randn(*s) * 0.2).astype(np.float32)
            for k, s in shapes.items()}


def test_ssm_layer_prefill_then_decode_matches():
    cfg = get_config("hymba_1_5b").smoke().replace(dtype="float32")
    rng = np.random.RandomState(4)
    p = _ssm_params(rng, cfg)
    tp = {k: _t(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    x = rng.randn(2, 13, cfg.d_model).astype(np.float32)   # 13 % chunk 8
    got, gc = tl.ssm_layer(cfg, tp, _t(x), want_cache=True)
    want, wc = jl.ssm_layer(cfg, jp, jnp.asarray(x), want_cache=True)
    _close(got, want)
    for key in wc:
        _close(gc[key], wc[key])
    x1 = rng.randn(2, 1, cfg.d_model).astype(np.float32)
    got, gc = tl.ssm_layer(cfg, tp, _t(x1), cache=gc)
    want, wc = jl.ssm_layer(cfg, jp, jnp.asarray(x1), cache=wc)
    _close(got, want)
    for key in wc:
        _close(gc[key], wc[key])
    assert tl.ssm_layer(cfg, tp, _t(x))[1] is None


# ------------------------------------------------------ the SSD's route
def _ssd_operands(device, b=2, s=24, h=3, p=4, n=5):
    """x, dt, A_log, B, C, D for :func:`ssd_route` and ``ssd_prefill``."""
    return [torch.randn(b, s, h, p, device=device),
            torch.rand(b, s, h, device=device) * 0.5,
            torch.rand(h, device=device), torch.randn(b, s, n, device=device),
            torch.randn(b, s, n, device=device),
            torch.rand(h, device=device)]


def _stand_in(calls, name):
    """A stand-in for an SSD that records each call's (name, chunk) in
    ``calls`` and returns tensors of the SSD's shapes and dtypes."""
    def run(x, dt, A_log, B, C, D, *args, **kwargs):
        chunk = kwargs.get("chunk", args[0] if args else None)
        calls.append((name, chunk))
        y = torch.zeros_like(x)
        if not kwargs.get("return_state", args[1] if len(args) > 1
                          else False):
            return y
        b, _, h, p = x.shape
        return y, x.new_zeros((b, h, p, B.shape[-1]), dtype=torch.float32)
    return run


@pytest.fixture
def launcher(monkeypatch):
    """A stand-in for the ``ssd_scan`` launch ``layers`` makes (this
    machine has no card); the calls are in the list it gives."""
    calls = []
    monkeypatch.setattr(tl, "ssd_scan", _stand_in(calls, "kernel"))
    return calls


def _counted(fn):
    """``fn()`` with tracing on; (its result, the counters of the record)."""
    from repro_torch import tracing
    tracing.reset()
    try:
        with tracing.recording():
            out = fn()
        return out, tracing.snapshot().counters
    finally:
        tracing.reset()


def test_traced_cpu_prefill_counts_only_ssd_chunked_calls(launcher):
    cfg = get_config("mamba2_370m").smoke()
    lm = LM(cfg, "cpu").init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 20),
                         generator=torch.Generator().manual_seed(1))
    _, counters = _counted(lambda: lm.prefill_with_cache(toks))
    assert counters == {"prefill": {"ssd_chunked_calls": cfg.n_layers}}
    assert launcher == []


# (grad mode on, which operand requires grad or None): a CUDA call goes to
# the kernel only where no autograd graph would be recorded
_GRAD_CASES = {"no_grad": (False, None), "no_grad_with_leaf": (False, 0),
               "grad_mode_no_leaf": (True, None), "grad_x": (True, 0),
               "grad_A_log": (True, 2), "grad_D": (True, 5)}


@pytest.mark.parametrize("case", list(_GRAD_CASES))
def test_ssd_route_on_cuda_follows_the_grad_mode(case, launcher,
                                                 monkeypatch):
    """On fake CUDA tensors (``FakeTensorMode``: shapes and devices, no
    card): a call recording no graph launches the kernel once and counts
    ``ssd_kernel_calls``; one recording a graph runs ``ssd_chunked``
    (a stand-in too: autograd needs a card for CUDA tensors)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    grad, leaf = _GRAD_CASES[case]
    kernel = not (grad and leaf is not None)
    monkeypatch.setattr(tl, "ssd_chunked", _stand_in(launcher, "chunked"))
    with FakeTensorMode():
        ops = _ssd_operands("cuda")
        if leaf is not None:
            ops[leaf].requires_grad_()
        with torch.set_grad_enabled(grad):
            assert tl.ssd_route(*ops) == ("kernel" if kernel else "chunked")
            (y, state), counters = _counted(
                lambda: tl.ssd_prefill(*ops, 8, return_state=True))
        assert y.device.type == state.device.type == "cuda"
        assert tuple(state.shape) == (2, 3, 4, 5)
        assert state.dtype == torch.float32
    assert launcher == [("kernel" if kernel else "chunked", 8)]
    name = "ssd_kernel_calls" if kernel else "ssd_chunked_calls"
    assert counters == {"": {name: 1}}


@pytest.mark.parametrize("device", ["cpu"])
def test_ssd_route_off_cuda_is_chunked(device, launcher):
    ops = _ssd_operands(device)
    with torch.no_grad():
        assert tl.ssd_route(*ops) == "chunked"
        y = tl.ssd_prefill(*ops, 8)
    assert launcher == [] and y.device.type == device
    if device == "cpu":
        torch.testing.assert_close(y, tl.ssd_chunked(*ops, 8), atol=0,
                                   rtol=0)


@pytest.mark.parametrize("case", list(_GRAD_CASES))
def test_ssd_route_on_meta_follows_the_grad_mode(case):
    """The meta device, the dry run's stand-in for the card, routes as
    CUDA does: a call recording no graph goes through ``ssd_scan``'s
    operator (its fake kernel: the shapes, no launch), one recording a
    graph through ``ssd_chunked``; each counted by its counter."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    grad, leaf = _GRAD_CASES[case]
    kernel = not (grad and leaf is not None)
    ops = _ssd_operands("meta")
    if leaf is not None:
        ops[leaf].requires_grad_()
    launches = ssd_scan.launches
    with torch.set_grad_enabled(grad):
        assert tl.ssd_route(*ops) == ("kernel" if kernel else "chunked")
        (y, state), counters = _counted(
            lambda: tl.ssd_prefill(*ops, 8, return_state=True))
    assert ssd_scan.launches == launches
    assert y.device.type == state.device.type == "meta"
    assert tuple(y.shape) == (2, 24, 3, 4)
    assert tuple(state.shape) == (2, 3, 4, 5)
    assert state.dtype == torch.float32
    assert (y.grad_fn is None) == kernel
    name = "ssd_kernel_calls" if kernel else "ssd_chunked_calls"
    assert counters == {"": {name: 1}}


def test_ssd_route_of_a_dtensor_is_chunked(launcher):
    """A DTensor (the partitioned LM's) takes ``ssd_chunked``'s local map,
    on a fake world of one rank on the CPU (the host-world fixtures give
    no DTensor on a card here)."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.launch import mesh as mesh_mod
    ops = _ssd_operands("cpu")
    with mesh_mod.fake_world(1), torch.no_grad():
        dm = mesh_mod.device_mesh(mesh_mod.make_mesh((1,), ("data",)))
        dops = [distribute_tensor(t, dm, [Replicate()]) for t in ops]
        assert tl.ssd_route(*dops) == "chunked"
        (y, state), counters = _counted(
            lambda: tl.ssd_prefill(*dops, 8, return_state=True))
        y, state = y.full_tensor(), state.full_tensor()
    assert launcher == []
    assert counters == {"": {"ssd_chunked_calls": 1}}
    want_y, want_state = tl.ssd_chunked(*ops, 8, return_state=True)
    torch.testing.assert_close(y, want_y, atol=0, rtol=0)
    torch.testing.assert_close(state, want_state, atol=0, rtol=0)


@pytest.mark.parametrize("want_cache", [False, True])
def test_ssm_layer_prefill_takes_the_route(want_cache, launcher,
                                           monkeypatch):
    """``ssm_layer``'s whole-sequence SSD goes where :func:`ssd_route`
    sends it (here made to pick the kernel on the CPU): the stand-in
    launch runs once at the config's chunk, its state is the decode
    cache's, and a decode step launches nothing."""
    cfg = get_config("hymba_1_5b").smoke().replace(dtype="float32")
    seen = []
    monkeypatch.setattr(tl, "ssd_route",
                        lambda *ops: seen.append(ops) or "kernel")
    p = {k: _t(v) for k, v in _ssm_params(np.random.RandomState(5),
                                           cfg).items()}
    x = torch.randn(2, 13, cfg.d_model)
    with torch.no_grad():
        (out, cache), counters = _counted(
            lambda: tl.ssm_layer(cfg, p, x, want_cache=want_cache))
        assert tuple(out.shape) == tuple(x.shape)
        assert launcher == [("kernel", cfg.ssm_chunk)]
        assert counters == {"": {"ssd_kernel_calls": 1}}
        assert len(seen) == 1 and seen[0][2] is p["A_log"]
        assert seen[0][0].shape == (2, 13, cfg.ssm_heads, cfg.ssm_head_dim)
        if want_cache:
            assert cache["state"].dtype == torch.float32
            tl.ssm_layer(cfg, p, x[:, :1], cache=cache)
            assert len(launcher) == 1
        else:
            assert cache is None


# ------------------------------------------------------ the whole slice
# (arch, impl, config changes): the MoE cases also run at small groups and
# half capacity, so that tokens are dropped and there are several groups
_MOE_SMALL = dict(moe_group=8, capacity_factor=0.5)
_SERVE_CASES = [
    ("hymba_1_5b", "flash", {}), ("minitron_8b", "flash", {}),
    ("mamba2_370m", "blockwise", {}), ("musicgen_large", "flash", {}),
    ("deepseek_moe_16b", "flash", {}), ("deepseek_moe_16b", "blockwise", {}),
    ("deepseek_moe_16b", "flash", dict(_MOE_SMALL, tag="dropping")),
    ("deepseek_moe_16b", "blockwise", dict(_MOE_SMALL, tag="dropping")),
    ("llama4_maverick_400b_a17b", "flash", {}),
    ("llama4_maverick_400b_a17b", "blockwise", {}),
    ("qwen1_5_32b", "flash", dict(kv_quant=True, tag="kv_quant")),
    ("qwen1_5_32b", "blockwise", dict(kv_quant=True, tag="kv_quant")),
    ("deepseek_moe_16b", "flash",
     dict(_MOE_SMALL, kv_quant=True, tag="dropping-kv_quant")),
]


@pytest.mark.parametrize("arch,impl,kw", [
    pytest.param(a, i, kw, id="-".join([a, i] + ([kw["tag"]] if kw else [])))
    for a, i, kw in _SERVE_CASES])
def test_prefill_then_decode_matches_reference(arch, impl, kw):
    """prefill_with_cache of 20 tokens (past hymba's smoke window of 16, so
    the ring buffer wraps and the window masks) then 4 decode_steps: the
    logits and every cache leaf agree with the reference (an int8 cache
    within one quantisation step: a value on a .5 boundary after products
    summed in another order may round the other way), and so do
    forward's hidden state and aux loss (summed over the MoE layers)."""
    kw = {k: v for k, v in kw.items() if k != "tag"}
    mesh, ref, params, lm = _pair(arch, attn_impl=impl, **kw)
    S, EXTRA = 20, 4
    toks = np.random.RandomState(5).randint(0, ref.cfg.vocab, (2, S + EXTRA))
    with mesh:
        want_lg, want_cache = ref.prefill_with_cache(
            params, jnp.asarray(toks[:, :S], jnp.int32))
        wants = [(want_lg, want_cache)]
        for t in range(S, S + EXTRA):
            want_lg, want_cache = ref.decode_step(
                params, want_cache, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                jnp.int32(t))
            wants.append((want_lg, want_cache))
        want_x, want_aux = ref.forward(params, jnp.asarray(toks, jnp.int32))
    tt = torch.from_numpy(toks)
    got_lg, cache = lm.prefill_with_cache(tt[:, :S])
    gots = [(got_lg, {k: v.clone() for k, v in cache.items()})]
    for t in range(S, S + EXTRA):
        got_lg, cache = lm.decode_step(cache, tt[:, t:t + 1], t)
        gots.append((got_lg, {k: v.clone() for k, v in cache.items()}))
    for (g_lg, g_cache), (w_lg, w_cache) in zip(gots, wants):
        assert float(np.abs(np.asarray(w_lg)).max()) > 0
        _close(g_lg, w_lg)
        assert set(g_cache) == set(w_cache)
        for key in w_cache:
            want = np.asarray(w_cache[key])
            if key == "pos":
                np.testing.assert_array_equal(g_cache[key].numpy(), want)
            elif want.dtype == np.int8:
                assert g_cache[key].dtype == torch.int8
                step = g_cache[key].numpy().astype(np.int32) - want
                assert np.abs(step).max() <= 1, key
            else:
                _close(g_cache[key], want)
    got_x, got_aux = lm.forward(tt)
    _close(got_x, want_x)
    assert (float(want_aux) > 0) == bool(lm.cfg.n_experts)
    _close(got_aux, want_aux)


def test_forward_and_prefill_with_embeds_match_reference():
    """The vlm family: stub patch embeddings prepended to the tokens."""
    mesh, ref, params, lm = _pair("internvl2_76b", attn_impl="flash")
    rng = np.random.RandomState(6)
    emb = rng.randn(2, ref.cfg.frontend_len, ref.cfg.d_model).astype(
        np.float32)
    toks = rng.randint(0, ref.cfg.vocab, (2, 10))
    with mesh:
        want_x, _ = ref.forward(params, jnp.asarray(toks, jnp.int32),
                                jnp.asarray(emb),
                                window=ref.cfg.attn_window)
        want_lg = ref.prefill(params, jnp.asarray(toks, jnp.int32),
                              jnp.asarray(emb))
    got_x, aux = lm.forward(torch.from_numpy(toks), _t(emb),
                            window=lm.cfg.attn_window)
    _close(got_x, want_x)
    assert float(aux) == 0.0
    _close(lm.prefill(torch.from_numpy(toks), _t(emb)), want_lg)


def test_prefill_then_decode_equals_decode_from_scratch():
    """The port on its own: continuing from the prefilled cache gives the
    logits of decoding every token from an empty cache."""
    cfg = get_config("hymba_1_5b").smoke().replace(dtype="float32")
    lm = LM(cfg).init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 14),
                         generator=torch.Generator().manual_seed(1))
    W = 16
    lg, cache = lm.prefill_with_cache(toks[:, :10], window=W)
    scratch = lm.init_cache(2, W)
    for t in range(14):
        lgb, scratch = lm.decode_step(scratch, toks[:, t:t + 1], t)
        if t >= 10:
            lg, cache = lm.decode_step(cache, toks[:, t:t + 1], t)
            torch.testing.assert_close(lg, lgb, atol=2e-5, rtol=2e-4)


# ------------------------------------------------------------ weights
def test_lm_init_follows_the_reference_rules():
    cfg = get_config("hymba_1_5b").smoke()
    lm = LM(cfg).init(torch.Generator().manual_seed(0))
    p = dict(lm.named_parameters())
    assert p["blocks.ln1"].dtype == torch.bfloat16
    assert p["blocks.ssm.A_log"].dtype == torch.float32
    assert torch.equal(p["blocks.ssm.A_log"], torch.zeros_like(
        p["blocks.ssm.A_log"]))
    assert torch.equal(p["blocks.ssm.D"], torch.ones_like(p["blocks.ssm.D"]))
    assert torch.equal(p["blocks.mix"], torch.ones_like(p["blocks.mix"]))
    assert torch.equal(p["blocks.ssm.dt_bias"],
                       torch.zeros_like(p["blocks.ssm.dt_bias"]))
    assert abs(float(p["blocks.attn.wq"].float().std()) - 0.02) < 0.002
    want_wo = 0.02 / np.sqrt(2 * cfg.n_layers)
    assert abs(float(p["blocks.attn.wo"].float().std()) - want_wo) < 0.002
    assert all(bool(torch.isfinite(t.float()).all()) for t in p.values())
    again = LM(cfg).init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(lm.parameters(),
                                                 again.parameters()))


def test_lm_params_from_numpy_checks_leaves():
    cfg = get_config("minitron_8b").smoke()          # bf16 leaves
    mesh = _mesh()
    ref = RefLM(ref_get_config("minitron_8b").smoke(), mesh)
    with mesh:
        tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    sd = lm_params_from_numpy(tree, cfg)
    assert sd["blocks.attn.wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        sd["embed"].float().numpy(), tree["embed"].astype(np.float32))
    missing = {k: v for k, v in tree.items() if k != "lm_head"}
    extra = dict(tree, bogus=np.zeros(3))
    bad = dict(tree, final_norm=np.zeros(cfg.d_model + 1))
    for t in (missing, extra, bad):
        with pytest.raises(ValueError):
            lm_params_from_numpy(t, cfg)


# ----------------------------------------------------------- the driver
def test_serve_lm_feeds_greedy_tokens_and_honours_feed():
    cfg = get_config("hymba_1_5b").smoke().replace(attn_impl="flash")
    lm = LM(cfg).init(torch.Generator().manual_seed(0))
    prompts = torch.randint(0, cfg.vocab, (3, 12),
                            generator=torch.Generator().manual_seed(1))
    res = serve.serve_lm(lm, prompts, 5)
    assert res.tokens.shape == res.fed.shape == (3, 5)
    assert len(res.logits) == 6
    first = torch.argmax(res.logits[0][:, :, :cfg.vocab], -1)[:, 0]
    assert torch.equal(res.fed[:, 0], first)
    assert torch.equal(res.fed[:, 1:], res.tokens[:, :-1])
    again = serve.serve_lm(lm, prompts, 5, feed=res.fed)
    for a, b in zip(res.logits, again.logits):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_serve_main_runs_smoke_on_cpu(capsys):
    serve.main(["--arch", "hymba_1_5b", "--smoke", "--device", "cpu",
                "--batch", "2", "--steps", "3"])
    out = capsys.readouterr().out
    assert "decoded 3 tokens x 2 requests" in out and "req1:" in out
    serve.main(["--arch", "hymba_1_5b", "--smoke", "--device", "cpu",
                "--batch", "1", "--steps", "1", "--offload-cgra", "3x3"])
    out = capsys.readouterr().out
    for loop in ("rmsnorm_acc", "rope_rotation", "ssd_recurrence"):
        assert loop in out
    assert "NO MAPPING" not in out and "decoded 1 tokens" in out
    # --offload-guide maps with a guided sweep of width 4 (a name that
    # resolves to nothing runs unguided, with the same IIs)
    serve.main(["--arch", "hymba_1_5b", "--smoke", "--device", "cpu",
                "--batch", "1", "--steps", "1", "--offload-cgra", "3x3",
                "--offload-guide", "no-such-guide"])
    out = capsys.readouterr().out
    assert "guided sweep k=4" in out and "NO MAPPING" not in out
    for loop in ("rmsnorm_acc", "rope_rotation", "ssd_recurrence"):
        assert loop in out
