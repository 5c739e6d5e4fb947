"""The port's MoE family on the CPU against the JAX package: the router
(top-k indices, gates, which slots fit their expert's capacity), both
dispatches (``moe_einsum``, ``moe_sort``) and their aux loss on
deepseek_moe_16b's and llama4_maverick_400b_a17b's smoke configs in f32,
with small groups and capacities so that tokens are dropped; the MoE
leaves of ``LM`` (shapes at the published widths, init, conversion) and
``serve.main``. Prefill + decode of both MoE configs against the
reference are cases of ``tests/test_torch_lm.py``'s
``test_prefill_then_decode_matches_reference``. Inputs are seeded numpy
arrays handed to both packages; the JAX side runs on an Auto-axis mesh
(ROADMAP, queue C)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import repro_torch
from repro.configs import get_config as ref_get_config
from repro.models import layers as jl
from repro.models.model import LM as RefLM
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import layers as tl
from repro_torch.models.model import LM

repro_torch.set_default_device("cpu")
torch.set_num_threads(1)

# f32 on both sides; products and sums in another order
ATOL, RTOL = 1e-5, 1e-4
MOE_ARCHS = ("deepseek_moe_16b", "llama4_maverick_400b_a17b")
# (moe_group, capacity_factor): one group and the default capacity; several
# groups of 8 tokens at half capacity (tokens dropped); a generous capacity
DISPATCH = [(512, 1.25), (8, 0.5), (16, 8.0)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _moe_params(cfg, seed):
    rng = np.random.RandomState(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    fs = cfg.n_shared_experts * f
    p = {"router": rng.randn(d, e) * 0.3,
         "w_gate": rng.randn(e, d, f) * 0.05,
         "w_up": rng.randn(e, d, f) * 0.05,
         "w_down": rng.randn(e, f, d) * 0.05}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    if fs:
        p["shared"] = {k: (rng.randn(*s) * 0.05).astype(np.float32)
                       for k, s in (("w_gate", (d, fs)), ("w_up", (d, fs)),
                                    ("w_down", (fs, d)))}
    return p


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


def _ref_routing(cfg, p, x):
    """The reference's routing, in its own jnp expressions
    (``repro/models/layers.py``, moe_einsum and moe_sort): top-k indices
    and gates, einsum's keep mask per (token, k) slot, and sort's keep mask
    carried back from sorted to (token, k) order."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    ng = jl._moe_groups(cfg, t)
    sg = t // ng
    cap = max(1, int(cfg.capacity_factor * sg * k / e))
    xg = jnp.asarray(x).reshape(ng, sg, d)
    logits = jnp.einsum("gsd,de->gse", xg.astype(jnp.float32),
                        jnp.asarray(p["router"]))
    probs = jax.nn.softmax(logits, axis=-1)
    gate, idx = jax.lax.top_k(probs, k)
    gate = gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9)
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.float32)
    pos = jnp.cumsum(onehot.reshape(ng, sg * k, e), axis=1) - 1.0
    keep_e = ((pos.reshape(ng, sg, k, e) < cap) & (onehot > 0)).any(-1)
    flat_e = idx.reshape(ng, sg * k)
    order = jnp.argsort(flat_e, axis=1)
    sorted_e = jnp.take_along_axis(flat_e, order, axis=1)
    first = jax.vmap(lambda a: jnp.searchsorted(a, a, side="left"))(sorted_e)
    keep_sorted = (jnp.arange(sg * k)[None, :] - first) < cap
    keep_s = np.zeros((ng, sg * k), bool)
    for g in range(ng):
        keep_s[g, np.asarray(order[g])] = np.asarray(keep_sorted[g])
    return (np.asarray(idx), np.asarray(gate), np.asarray(probs),
            np.asarray(keep_e), keep_s.reshape(ng, sg, k), cap)


@pytest.mark.parametrize("group,cf", DISPATCH)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dispatch_matches_reference(arch, group, cf):
    """Routing first (top-k indices, the renormalised gates, the keep masks
    of both reference dispatches), then each dispatch's output and aux."""
    cfg = get_config(arch).smoke().replace(dtype="float32", moe_group=group,
                                           capacity_factor=cf)
    rcfg = ref_get_config(arch).smoke().replace(
        dtype="float32", moe_group=group, capacity_factor=cf)
    p = _moe_params(cfg, 11)
    x = np.random.RandomState(12).randn(2, 24, cfg.d_model).astype(
        np.float32)
    tp, jp = _tree(p, _t), _tree(p, jnp.asarray)
    idx, gate, probs, keep_e, keep_s, cap = _ref_routing(rcfg, p, x)
    xg, g_probs, g_gate, g_idx, g_cap = tl._route(cfg, tp, _t(x))
    _, _, g_keep = tl._slots(g_idx, cfg.n_experts, g_cap)
    assert g_cap == cap
    np.testing.assert_array_equal(g_idx.numpy(), idx)
    np.testing.assert_array_equal(g_keep.numpy(), keep_e)
    np.testing.assert_array_equal(g_keep.numpy(), keep_s)
    _close(g_gate, gate)
    _close(g_probs, probs)
    if cf < 1:
        assert not keep_e.all(), "the case is meant to drop tokens"
    for tfn, jfn in ((tl.moe_einsum, jl.moe_einsum),
                     (tl.moe_sort, jl.moe_sort)):
        got, g_aux = tfn(cfg, tp, _t(x))
        want, w_aux = jfn(rcfg, jp, jnp.asarray(x))
        assert got.dtype == torch.float32 and got.shape == x.shape
        _close(got, want)
        _close(g_aux, w_aux)
    for impl in ("einsum", "sort"):
        got, _ = tl.moe_layer(cfg.replace(moe_impl=impl), tp, _t(x))
        want, _ = jl.moe_layer(rcfg.replace(moe_impl=impl), jp,
                               jnp.asarray(x))
        _close(got, want)


def test_moe_einsum_matches_reference_in_bf16():
    """bf16 activations and weights: the router in f32 (the bf16 router
    cast, where JAX promotes), the combine weights rounded to bf16 before
    the product as in the reference; within two bf16 roundings."""
    cfg = get_config("deepseek_moe_16b").smoke().replace(moe_group=8,
                                                         capacity_factor=0.5)
    rcfg = ref_get_config("deepseek_moe_16b").smoke().replace(
        moe_group=8, capacity_factor=0.5)
    p = _moe_params(cfg, 13)
    x = np.random.RandomState(14).randn(2, 16, cfg.d_model).astype(
        np.float32)
    jp = _tree(p, lambda a: jnp.asarray(a, jnp.bfloat16))
    tp = _tree(jp, lambda a: _t(np.asarray(a.astype(jnp.float32))).to(
        torch.bfloat16))
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = _t(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)
    for tfn, jfn in ((tl.moe_einsum, jl.moe_einsum),
                     (tl.moe_sort, jl.moe_sort)):
        got, g_aux = tfn(cfg, tp, xt)
        want, w_aux = jfn(rcfg, jp, xj)
        assert got.dtype == torch.bfloat16
        _close(got, want.astype(jnp.float32), atol=2e-2, rtol=2e-2)
        _close(g_aux, w_aux)


def test_moe_sort_equals_moe_einsum():
    """The port's two dispatches agree with each other, as the reference's
    do (tests/test_models.py::test_moe_sort_equals_einsum)."""
    cfg = get_config("deepseek_moe_16b").smoke().replace(
        capacity_factor=8.0, moe_group=64, dtype="float32")
    p = _tree(_moe_params(cfg, 15), _t)
    x = _t(np.random.RandomState(16).randn(2, 32, cfg.d_model).astype(
        np.float32))
    o1, a1 = tl.moe_sort(cfg, p, x)
    o2, a2 = tl.moe_einsum(cfg, p, x)
    torch.testing.assert_close(o1, o2, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(a1, a2, atol=0, rtol=1e-5)


@pytest.mark.parametrize("impl", ["einsum", "sort"])
def test_top_k_ties_go_to_the_lower_expert(impl):
    """A zero router gives every expert the same probability: like
    jax.lax.top_k, the port routes every token to experts 0..k-1 (the
    stable descending sort), where torch.topk promises no order."""
    cfg = get_config("deepseek_moe_16b").smoke().replace(dtype="float32")
    p = _moe_params(cfg, 17)
    p["router"] = np.zeros_like(p["router"])
    x = np.random.RandomState(18).randn(1, 8, cfg.d_model).astype(np.float32)
    _, _, _, idx, _ = tl._route(cfg, _tree(p, _t), _t(x))
    ref_idx = _ref_routing(cfg, p, x)[0]
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    assert (idx.numpy() == np.arange(cfg.top_k)).all()
    got, _ = tl.moe_layer(cfg.replace(moe_impl=impl), _tree(p, _t), _t(x))
    want, _ = jl.moe_layer(cfg.replace(moe_impl=impl),
                           _tree(p, jnp.asarray), jnp.asarray(x))
    _close(got, want)


# ------------------------------------------------------------ the LM
def test_moe_lm_init_follows_the_reference_rules():
    """The MoE leaves: ln2 one, the router and the expert matrices
    N(0, 0.02), w_down (routed and shared) scaled by 1/sqrt(2 n_layers),
    all in the model dtype and seeded."""
    cfg = get_config("deepseek_moe_16b").smoke().replace(n_layers=4)
    lm = LM(cfg).init(torch.Generator().manual_seed(0))
    p = dict(lm.named_parameters())
    assert all(t.dtype == torch.bfloat16 for t in p.values())
    assert torch.equal(p["blocks.ln2"], torch.ones_like(p["blocks.ln2"]))
    assert "blocks.mlp.w_gate" not in p
    want_down = 0.02 / np.sqrt(2 * cfg.n_layers)
    for name, std in (("moe.router", 0.02), ("moe.w_gate", 0.02),
                      ("moe.w_up", 0.02), ("moe.shared.w_up", 0.02),
                      ("moe.w_down", want_down),
                      ("moe.shared.w_down", want_down)):
        got = float(p[f"blocks.{name}"].float().std())
        assert abs(got - std) < 0.1 * std, (name, got, std)
    again = LM(cfg).init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(lm.parameters(),
                                                 again.parameters()))


def test_lm_params_from_numpy_checks_moe_leaves():
    cfg = get_config("deepseek_moe_16b").smoke()         # bf16 leaves
    mesh = _mesh()
    ref = RefLM(ref_get_config("deepseek_moe_16b").smoke(), mesh)
    with mesh:
        tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    sd = lm_params_from_numpy(tree, cfg)
    for name in ("blocks.moe.router", "blocks.moe.w_down",
                 "blocks.moe.shared.w_gate"):
        assert sd[name].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        sd["blocks.moe.w_up"].float().numpy(),
        tree["blocks"]["moe"]["w_up"].astype(np.float32))
    moe = tree["blocks"]["moe"]
    missing = dict(moe, shared={k: v for k, v in moe["shared"].items()
                                if k != "w_up"})
    bad = dict(moe, w_gate=moe["w_gate"][:, :, :, :-1])
    extra = dict(moe, bogus=np.zeros(3))
    for m in (missing, bad, extra):
        with pytest.raises(ValueError):
            lm_params_from_numpy(dict(tree, blocks=dict(tree["blocks"],
                                                        moe=m)), cfg)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_main_serves_moe_smoke_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                "--batch", "2", "--steps", "3"])
    out = capsys.readouterr().out
    assert "decoded 3 tokens x 2 requests" in out and "req1:" in out


def test_moe_lm_constructs_at_published_widths_on_meta():
    """deepseek_moe_16b at its published widths (allocation-free on the
    meta device): 16.88 B parameters (ln1, attention, ln2, router, 64
    routed and 2 shared experts a layer; embed, head, final norm), the
    count its serving run moves. llama4_maverick's published widths
    construct too (they are served only at smoke size: ~800 GB in bf16)."""
    lm = LM(get_config("deepseek_moe_16b"), "meta")
    d, f, e, L = 2048, 1408, 64, 28
    per_layer = d + 4 * d * d + d + d * e + 3 * e * d * f + 3 * d * 2 * f
    assert sum(t.numel() for t in lm.parameters()) == \
        L * per_layer + 2 * 102400 * d + d == 16_879_568_896
    assert lm.blocks.moe.w_gate.shape == (L, e, d, f)
    big = LM(get_config("llama4_maverick_400b_a17b"), "meta")
    assert big.blocks.moe.w_down.shape == (48, 128, 8192, 5120)
    assert "mlp" not in dict(big.blocks.named_children())
