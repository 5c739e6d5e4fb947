"""A stack of layers of different kinds (``PatternConfig``) on the CPU, at
granite-4.0-h-small's smoke size: the config, the LM's two-kind cache
against the benchmark's plain float32 reference
(``perfbench/reference/granite.py``), the pieces it adds (NoPE and a
score scale in attention, the convolution bias, the multipliers), the
routing identity, the cache's counters, and the pins that keep the ten
shared architectures as they were."""
from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from repro_torch import set_default_device, tracing
from repro_torch.configs import ARCHS, PATTERN_ARCHS, canonical, get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.serve import serve_lm
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig, PatternConfig
from repro_torch.models.model import LM

ARCH = "granite-4.0-h-small"
# float32 on both sides: the two differ in the order of their sums only
# (blockwise and per-block softmax, the chunked SSD against the
# reference's blocks, the capacity dispatch's products against its
# gathers), a few units of float32 on logits of order 0.1 to 5
LOGIT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")


def _smoke(**kw) -> PatternConfig:
    return get_config(ARCH).smoke().replace(dtype="float32", **kw)


def _model(cfg: PatternConfig) -> dict:
    """The configuration file's ``model`` object of ``cfg``."""
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


# ------------------------------------------------------------- config
def test_the_config_round_trips_and_keeps_every_kind():
    cfg = get_config(ARCH)
    assert canonical("granite-4.0-h-small") == "granite_4_0_h_small"
    assert PatternConfig(**dataclasses.asdict(cfg)) == cfg
    assert PatternConfig(**_model(cfg)) == cfg     # lists back to tuples
    assert cfg.layers_of("attention") == (5, 15, 25, 35)
    assert len(cfg.layers_of("mamba")) == 36
    assert (cfg.attn_scale, cfg.embed_scale, cfg.residual_scale,
            cfg.logit_scale, cfg.rope, cfg.conv_bias) == \
        (1 / 128, 12.0, 0.22, 16.0, False, True)
    s = cfg.smoke()
    assert isinstance(s, PatternConfig)
    assert s.layer_kinds == ("mamba", "attention", "mamba")
    assert s.n_layers == 3 and s.d_model == 64 and s.name.endswith("-smoke")
    with pytest.raises(ValueError, match="layer_kinds"):
        cfg.replace(n_layers=3)
    with pytest.raises(ValueError, match="layer_kinds"):
        cfg.replace(layer_kinds=("mamba",) * 39 + ("moe",))


def test_a_patterned_stack_needs_its_moe():
    """A patterned layer's feed-forward is the MoE: a config without
    experts is refused when it is made, not when a layer runs."""
    with pytest.raises(ValueError, match="n_experts"):
        get_config(ARCH).replace(n_experts=0, top_k=0)


def test_the_shared_architectures_and_fields_are_as_before():
    """The JAX package's config is compared field for field with the
    port's (``test_configs_equal_the_reference``): the patterned
    architectures live in a list of their own, their fields in the
    subclass alone."""
    assert ARCHS == [
        "llama4_maverick_400b_a17b", "deepseek_moe_16b", "yi_34b",
        "qwen1_5_32b", "command_r_35b", "minitron_8b", "hymba_1_5b",
        "musicgen_large", "internvl2_76b", "mamba2_370m"]
    assert PATTERN_ARCHS == ["granite_4_0_h_small"]
    assert [f.name for f in dataclasses.fields(ModelConfig)] == [
        "name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
        "d_ff", "vocab", "head_dim", "qkv_bias", "mlp_bias", "n_experts",
        "n_shared_experts", "top_k", "capacity_factor",
        "router_aux_weight", "ssm_state", "ssm_heads", "ssm_head_dim",
        "ssm_chunk", "d_conv", "attn_window", "rope_theta", "norm_eps",
        "tie_embeddings", "frontend", "frontend_len", "dtype", "remat",
        "scan_layers", "zero1", "seq_shard", "moe_impl", "moe_group",
        "fsdp_experts", "grad_barrier", "accum_steps", "kv_quant",
        "attn_impl", "pp_stages"]


# ------------------------------------------------------ against the ref
def _served(cfg: PatternConfig, seed: int, b: int = 3, p: int = 40,
            n: int = 4, drop_bias: bool = False):
    from perfbench.harness import weights
    from perfbench.kinds import serve_patterned as sp
    m = _model(cfg)
    lm = LM(cfg, "cpu")
    params = dict(lm.named_parameters())
    sp.check_layout(params, m)
    weights.fill(params, m, seed)
    if drop_bias:
        for k, t in params.items():
            if k.endswith("_bias"):
                t.zero_()
    prompts = weights.tokens(seed, 0, b, p, m["vocab"], "cpu")
    res = serve_lm(lm, prompts, n, window=p + n)
    got = torch.stack([lg[:, 0, :m["vocab"]] for lg in res.logits], dim=1)
    return m, prompts, res, got


@pytest.mark.parametrize("impl", ["flash", "blockwise"])
def test_prefill_then_decode_through_both_caches_is_the_reference(impl):
    """The served logits (the prefill's last position, then each decode
    step through the KV ring of the attention layer and the SSM state and
    convolution windows of the two Mamba layers) are the float32
    reference's full forward over the prompt and the fed tokens, routed
    in the same calls; with the convolution biases dropped they are
    not."""
    from perfbench.kinds import serve_patterned as sp
    from perfbench.reference import granite as ref
    cfg = _smoke(attn_impl=impl, capacity_factor=1.0, moe_group=16)
    p, n = 40, 4
    m, prompts, res, got = _served(cfg, 7, p=p, n=n)
    w = sp.make(m, 7, "cpu")
    toks = torch.cat([prompts, res.fed], dim=1)
    positions = list(range(p - 1, p + n))
    want = ref.logits_at(m, w, toks, positions, sp.calls(
        {"prompt_len": p, "decode_steps": n}))
    assert (got - want).abs().max() < LOGIT_TOL
    _, _, res_nb, got_nb = _served(cfg, 7, p=p, n=n, drop_bias=True)
    assert torch.equal(res_nb.fed[:, :1], res.fed[:, :1])
    assert (got_nb[:, :1] - want[:, :1]).abs().max() > 10 * LOGIT_TOL


def test_nope_and_the_scale_reach_attention():
    """The attention layer without rotary positions and at the config's
    scale: flash (its plain version) and blockwise against the naive
    product, and apart from the rotary, default-scale layer."""
    cfg = _smoke()
    lm = LM(cfg, "cpu").init(torch.Generator().manual_seed(3))
    pa = lm._layers()[1]["attn"]
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4))
    pos = torch.arange(24)[None].expand(2, 24)
    outs = {impl: layers.attention_layer(cfg, lm.plan, pa, x, pos,
                                         impl=impl, rope_on=False,
                                         scale=cfg.attn_scale)[0]
            for impl in ("flash", "blockwise", "naive")}
    for impl in ("flash", "blockwise"):
        assert (outs[impl] - outs["naive"]).abs().max() < 1e-6
    plain = layers.attention_layer(cfg, lm.plan, pa, x, pos, impl="naive")[0]
    assert (plain - outs["naive"]).abs().max() > \
        1e-2 * outs["naive"].abs().max()


def test_the_routing_is_a_softmax_over_the_chosen_logits():
    """The port's gates (a softmax over all experts, the top k
    renormalised) are the published ones: a softmax over the k largest
    router logits."""
    cfg = get_config(ARCH).smoke().replace(dtype="float32", top_k=3,
                                           n_experts=8)
    gen = torch.Generator().manual_seed(5)
    p = {"router": torch.randn(cfg.d_model, cfg.n_experts, generator=gen)}
    x = torch.randn(2, 16, cfg.d_model, generator=gen)
    xg, _, gate, idx, _ = layers._route(cfg, p, x)
    logits = xg.float() @ p["router"]
    top, top_idx = torch.topk(logits, cfg.top_k, dim=-1)
    assert torch.equal(idx, top_idx)
    assert torch.allclose(gate, torch.softmax(top, dim=-1), atol=1e-6)


def test_a_decode_steps_convolution_with_bias_is_the_prefills():
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(2, 9, 12, generator=gen)
    w = torch.randn(4, 12, generator=gen)
    bias = torch.randn(12, generator=gen)
    whole, last = layers._causal_conv(x, w, None, bias)
    prev, steps = None, []
    for t in range(9):
        y, prev = layers._causal_conv(x[:, t:t + 1], w, prev, bias)
        steps.append(y)
    assert torch.allclose(torch.cat(steps, dim=1), whole, atol=1e-6)
    assert torch.equal(prev, last)
    no_bias, _ = layers._causal_conv(x, w, None)
    assert (no_bias - whole).abs().max() > 1e-2


# ------------------------------------------------------------- the LM
def test_the_two_cache_kinds_and_their_counters():
    cfg = _smoke()
    lm = LM(cfg, "cpu").init(torch.Generator().manual_seed(8))
    shapes = lm.cache_shapes(2, 30)
    assert shapes["k"][0] == (1, 2, 30, 2, 16)
    assert shapes["state"][0] == (2, 2, 4, 16, 16)
    assert shapes["conv_x"][0] == (2, 2, 3, 64)
    prompts = torch.randint(0, cfg.vocab, (2, 26),
                            generator=torch.Generator().manual_seed(9))
    with tracing.recording():
        serve_lm(lm, prompts, 2, window=30)
        snap = tracing.snapshot()
    c = snap.counters[""]         # serve_lm's, outside the LM's spans
    assert c["cache_bytes_kv"] == 2 * (2 * 30 * 2 * 16 * 4) + 2 * 30 * 4
    assert c["cache_bytes_ssm"] == 2 * 2 * (4 * 16 * 16 * 4
                                            + 3 * (64 + 16 + 16) * 4)
    assert snap.counters["prefill"]["ssd_chunked_calls"] == 2
    assert "prefill/ssm/conv" in snap.spans
    assert "decode_step/ssm/conv" in snap.spans
    assert "prefill/attention" in snap.spans
    report = tracing.report(snap)
    assert "cache_bytes_kv" in report and "cache_bytes_ssm" in report


def test_the_leaves_stack_over_their_own_kind():
    cfg = get_config(ARCH)
    lm = LM(cfg, "meta")
    shapes = {k: tuple(v.shape) for k, v in lm.named_parameters()}
    assert shapes["blocks.attn.wq"] == (4, 4096, 4096)
    assert shapes["blocks.attn.wk"] == (4, 4096, 1024)
    assert shapes["blocks.ssm.w_x"] == (36, 4096, 8192)
    assert shapes["blocks.ssm.conv_x_bias"] == (36, 8192)
    assert shapes["blocks.moe.w_gate"] == (40, 72, 4096, 768)
    assert shapes["blocks.moe.shared.w_up"] == (40, 4096, 1536)
    assert "lm_head" not in shapes
    total = sum(v.numel() for v in lm.parameters())
    assert 32.1e9 < total < 32.3e9
    layer = lm._layers()
    assert set(layer[5]) == {"ln1", "ln2", "attn", "moe"}
    assert set(layer[0]) == {"ln1", "ln2", "ssm", "moe"}


def test_the_partitioned_lm_does_not_take_a_pattern():
    with pytest.raises(NotImplementedError, match="PatternConfig"):
        LM(_smoke(), "cpu", mesh=object())


def test_serve_spans_print_the_cache_counters(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--spans",
                "--batch", "2", "--steps", "2", "--window", "16"])
    out = capsys.readouterr().out
    assert "cache_bytes_kv" in out and "cache_bytes_ssm" in out
    assert "prefill/ssm/conv" in out


# -------------------------------------------------------- flash scale
def test_flash_scale_on_the_cpu_is_naive_attentions():
    gen = torch.Generator().manual_seed(10)
    q = torch.randn(2, 20, 4, 16, generator=gen)
    k = torch.randn(2, 20, 2, 16, generator=gen)
    v = torch.randn(2, 20, 2, 16, generator=gen)
    pos = torch.arange(20)[None].expand(2, 20)
    for scale in (1 / 128, 0.5):
        got = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True,
                              scale=scale).transpose(1, 2)
        want = layers.naive_attention(q, k, v, pos, pos, scale=scale)
        assert (got - want).abs().max() < 1e-6
    default = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True)
    assert (default - flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, scale=16 ** -0.5)).abs().max() < 1e-6
    with pytest.raises(ValueError, match="scale"):
        flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), scale=0.0)


def test_flash_scale_on_meta_keeps_shape_and_flops():
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.flash_attention.ops import flash_flops
    q = torch.empty(1, 4, 32, 16, device="meta")
    k = torch.empty(1, 2, 32, 16, device="meta")
    with FlopCounterMode(display=False) as fc:
        out = flash_attention(q, k, k, causal=True, scale=1 / 128)
    assert out.shape == q.shape and out.device.type == "meta"
    want = 4 * 16 * 4 * (32 * 33 // 2)
    assert fc.get_total_flops() == want
    assert flash_flops(q.shape, k.shape, k.shape, True, 0, 0, 1 / 128) == want
