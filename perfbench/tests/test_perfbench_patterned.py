"""The benchmark's two kinds added with granite-4.0-h-small on the CPU: the
served stack of layers of different kinds (``kinds/serve_patterned.py``)
at a tiny width, and the host world's training (``kinds/train_world.py``)
on two gloo ranks; each sound run is correct, each fault is refused, and
so is the float8 control. Also the new metrics' counts and readers."""
from __future__ import annotations

import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from perfbench.harness import counts, registry, result, trace
from perfbench.kinds import serve_patterned, train_world
from perfbench.tests import tiny

PERFBENCH = registry.ROOT / "perfbench"
PATTERN = {"name": "tiny-pattern", "family": "moe", "n_layers": 3,
           "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
           "d_ff": 32, "vocab": 256, "n_experts": 4, "n_shared_experts": 2,
           "top_k": 2, "capacity_factor": 1.0, "moe_group": 16,
           "moe_impl": "einsum", "ssm_state": 16, "ssm_heads": 4,
           "ssm_head_dim": 16, "ssm_chunk": 8, "d_conv": 4,
           "norm_eps": 1e-5, "tie_embeddings": True, "dtype": "float32",
           "layer_kinds": ["mamba", "attention", "mamba"], "rope": False,
           "attn_scale": 0.0078125, "embed_scale": 12.0,
           "residual_scale": 0.22, "logit_scale": 16.0, "conv_bias": True}
SERVE_CELL = "tiny_pattern.tiny_pserve"
WORLD_CELL = "tiny_hybrid.tiny_world"
# float32 on both sides: the order of sums alone
SERVE_LIMITS = {"served_token_gap": tiny.LIMIT, "logit_error": tiny.LIMIT,
                "logit_error_mean": tiny.LIMIT}


@pytest.fixture(autouse=True)
def _cpu():
    from repro_torch import set_default_device
    set_default_device("cpu")


@pytest.fixture
def root(tmp_path):
    """The benchmark copied with a tiny patterned serve cell and a tiny
    two-rank world cell added, as files and entries."""
    root = tiny.make_root(tmp_path)
    d = root / "perfbench"
    (d / "configs" / "tiny_pattern.json").write_text(
        json.dumps({"name": "tiny_pattern", "model": PATTERN}))
    (d / "traffic" / "tiny_pserve.json").write_text(
        json.dumps(dict(tiny.TRAFFIC, kind="serve_patterned")))
    (d / "traffic" / "tiny_world.json").write_text(json.dumps(
        dict(tiny.TRAIN, kind="train_world", ranks=2, global_batch=4)))
    (d / "limits" / f"{SERVE_CELL}.json").write_text(json.dumps(
        {k: {"limit": v} for k, v in SERVE_LIMITS.items()}))
    (d / "limits" / f"{WORLD_CELL}.json").write_text(json.dumps(
        {k: {"limit": v} for k, v in tiny.TRAIN_LIMITS.items()}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_pattern", "source": "tests",
                             "file": "perfbench/configs/tiny_pattern.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"] += [
        {"name": SERVE_CELL, "config": "tiny_pattern",
         "traffic": "tiny_pserve", "chips": 1, "why": "tests"},
        {"name": WORLD_CELL, "config": "tiny_hybrid",
         "traffic": "tiny_world", "chips": 1, "why": "tests"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        ws = m.get("workloads", [])
        if "granite_4_0_h_small.serve_b4_p8192" in ws:
            ws.append(SERVE_CELL)
        if "hymba_1_5b.train_b16_s4096_4card" in ws:
            ws.append(WORLD_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _ctx(cell, seed=2 ** 31 + 17, seconds=0.0, traced=False):
    return registry.Context(cell, seed, seconds, traced,
                            torch.device("cpu"), time.perf_counter())


# ------------------------------------------------------ the served stack
def test_the_leaves_are_the_lms_at_published_widths():
    from repro_torch.models.model import LM
    c = registry.cell("granite_4_0_h_small.serve_b4_p8192")
    m = c.config["model"]
    lm = LM(serve_patterned.model_config(c), "meta")
    serve_patterned.check_layout(dict(lm.named_parameters()), m)
    assert c.config["reduced"] == []
    assert c.config["source"].startswith(
        "https://huggingface.co/ibm-granite/granite-4.0-h-small")
    # the catalog's keys at the top level, as published
    assert c.config["layer_types"] == m["layer_kinds"]
    assert (c.config["hidden_size"], c.config["num_local_experts"],
            c.config["num_experts_per_tok"], c.config["mamba_d_state"],
            c.config["mamba_n_heads"], c.config["mamba_d_head"]) == \
        (m["d_model"], m["n_experts"], m["top_k"], m["ssm_state"],
         m["ssm_heads"], m["ssm_head_dim"])
    assert c.config["shared_intermediate_size"] == \
        m["n_shared_experts"] * m["d_ff"]
    assert (c.config["attention_multiplier"], c.config["embedding_multiplier"],
            c.config["residual_multiplier"], c.config["logits_scaling"]) == \
        (m["attn_scale"], m["embed_scale"], m["residual_scale"],
         m["logit_scale"])
    assert set(c.config["published"]) <= set(c.config)


@pytest.mark.parametrize("traced", [False, True])
def test_a_served_stack_run_is_correct(root, traced):
    cell = registry.cell(SERVE_CELL, root)
    out = serve_patterned.run(_ctx(cell, seconds=0.2, traced=traced))
    assert out.correct, out.checks
    line = result.line(cell, out, traced, {"platform": "cpu"})
    assert list(line)[-1] == "compared"
    assert set(line["compared"]) == set(SERVE_LIMITS) | {"answers_missing"}
    if traced:
        assert line["metrics"]["mfu_stack.prefill"]["value"] > 0
        assert "mfu.prefill" not in line["metrics"]
    else:
        assert set(line["metrics"]) == {"ttft_p95_ms", "requests_per_s",
                                        "setup_s"}


@pytest.mark.parametrize("fault", sorted(serve_patterned.FAULTS))
def test_a_served_stack_refuses_a_broken_timed_path(root, fault):
    cell = registry.cell(SERVE_CELL, root)
    with serve_patterned.FAULTS[fault]():
        out = serve_patterned.run(_ctx(cell))
    assert not out.correct, (fault, out.checks)


def test_a_served_stack_refuses_the_float8_control(root):
    cell = registry.cell(SERVE_CELL, root)
    got = serve_patterned.readings(_ctx(cell, seed=2 ** 31 + 3), control=True)
    assert got["logit_error"] <= tiny.LIMIT < got["control_logit_error"]
    assert got["logit_error_mean"] <= tiny.LIMIT < \
        got["control_logit_error_mean"]


# ---------------------------------------------------- the host world
def test_a_world_run_is_correct_and_hands_back_its_record(root):
    from repro_torch import tracing
    cell = registry.cell(WORLD_CELL, root)
    out = train_world.run(_ctx(cell, seconds=0.3, traced=True))
    assert out.correct, out.checks
    assert out.end_to_end["train_tokens_per_s"] > 0
    snap = tracing.snapshot()
    assert "value_and_grad" in snap.spans and "grad_reduce" in snap.spans
    assert "optimizer" in snap.spans
    assert snap.counters["grad_reduce"]["grad_reduce_bytes"] > 0
    line = result.line(cell, out, True, {"platform": "cpu"})
    assert set(line["compared"]) == set(tiny.TRAIN_LIMITS)


@pytest.mark.parametrize("fault", sorted(train_world.FAULTS))
def test_a_world_refuses_a_broken_timed_path(root, fault):
    cell = registry.cell(WORLD_CELL, root)
    with train_world.FAULTS[fault]():
        out = train_world.run(_ctx(cell))
    assert not out.correct, (fault, out.checks)


def test_a_world_refuses_the_float8_control(root):
    cell = registry.cell(WORLD_CELL, root)
    got = train_world.readings(_ctx(cell, seed=2 ** 31 + 3), control=True)
    assert all(got[k] <= v for k, v in tiny.TRAIN_LIMITS.items()), got
    assert any(got["control_" + k] > v
               for k, v in tiny.TRAIN_LIMITS.items()), got


# ------------------------------------------------------------ metrics
def _reader(name):
    return registry.metric_reader(name)


def test_the_stacks_prefill_flops_by_hand():
    """granite-4.0-h-small at 4 x 8192: 36 Mamba layers (z, x, out
    4096 x 8192 each, B and C 4096 x 128, dt 4096 x 128; the scan 4 P N a
    head a token), 4 attention layers (q, o 4096 x 4096, k, v 4096 x
    1024; 4 D a visible pair a q head), a MoE in every layer (router 4096
    x 72, 10 routed and 2 shared SwiGLU experts of 3 x 4096 x 768), the
    tied head at each prompt's last token."""
    m = registry.cell("granite_4_0_h_small.serve_b4_p8192").config["model"]
    rows, s = 4, 8192
    tok = rows * s
    mamba = 2 * (3 * 4096 * 8192 + 2 * 4096 * 128 + 4096 * 128) * tok \
        + 4 * 128 * 64 * 128 * tok
    attn = 2 * (2 * 4096 * 4096 + 2 * 4096 * 1024) * tok \
        + (s * (s + 1) // 2) * 4 * 128 * 32 * rows
    moe = 2 * (4096 * 72 + 12 * 3 * 4096 * 768) * tok
    want = 36 * mamba + 4 * attn + 40 * moe + 2 * 4096 * 100352 * rows
    got = _reader("mfu_stack.prefill").prefill_flops(m, rows, s)
    assert got == want
    assert 5.635e14 < got < 5.637e14
    obs = SimpleNamespace(model=m, traffic={"batch": rows,
                                            "prompt_len": s},
                          prefill_s=[2.0, 3.0])
    assert _reader("mfu_stack.prefill").read(obs) == pytest.approx(
        100 * want / (2.5 * counts.PEAK_BF16_FLOPS))
    uniform = registry.cell("hymba_1_5b.serve_b96_p2048").config["model"]
    assert _reader("mfu_stack.prefill").read(SimpleNamespace(
        model=uniform, traffic=obs.traffic, prefill_s=[1.0])) is None


def test_the_stacks_flash_roofline_counts_its_attention_layers():
    """granite's 4 attention layers at 4 x 8192 (q 32 heads, k/v 8, D
    128, causal, no window): the bound of one call times 4, over the
    flash kernels' time in the prefill span; a gemm and a flash kernel
    outside the span do not count. A uniform stack reads nothing here."""
    cell = registry.cell("granite_4_0_h_small.serve_b4_p8192")
    m = cell.config["model"]
    ops = [trace.Op("flash_fwd_kernel_wgmma<128>", "kernel", 1e4 * i,
                    4000.0, "prefill") for i in range(4)]
    ops += [trace.Op("gemm", "kernel", 5e4, 9000.0, "prefill"),
            trace.Op("flash_fwd_kernel_wgmma<128>", "kernel", 6e4, 50.0,
                     "decode_step")]
    tr = trace.Trace(ops=ops, spans={}, window=(0.0, 1e5))
    obs = SimpleNamespace(model=m, traffic=cell.traffic, trace=tr)
    bound, by = counts.flash_bound_s(4, 32, 8, 8192, 128, 0, 2)
    assert by == "operations" and 2.2e-3 < bound < 2.25e-3
    reader = _reader("flash_roofline.prefill_stack")
    assert reader.read(obs) == pytest.approx(100 * bound * 4 / 16e-3)
    uniform = registry.cell("hymba_1_5b.serve_b96_p2048")
    assert reader.read(SimpleNamespace(
        model=uniform.config["model"], traffic=uniform.traffic,
        trace=tr)) is None
    assert reader.read(SimpleNamespace(model=m, traffic=cell.traffic,
                                       trace=None)) is None


def test_the_worlds_mfu_divides_by_every_card():
    """The four-card cell's step FLOPs (``counts.train_flops`` of the
    global batch) over the mean step time times 4 cards' peak; the
    one-card cell, whose mix names no ranks, reads nothing here."""
    cell = registry.cell("hymba_1_5b.train_b16_s4096_4card")
    m = cell.config["model"]
    obs = SimpleNamespace(model=m, traffic=cell.traffic,
                          step_s=[7.0, 7.4])
    flops = counts.train_flops(m, 16, 4096)
    reader = _reader("mfu.train_world")
    assert reader.read(obs) == pytest.approx(
        100 * flops / (7.2 * 4 * counts.PEAK_BF16_FLOPS))
    one = registry.cell("hymba_1_5b.train_b4_s4096")
    assert reader.read(SimpleNamespace(model=one.config["model"],
                                       traffic=one.traffic,
                                       step_s=[7.0])) is None
    assert reader.read(SimpleNamespace(model=m, traffic=cell.traffic,
                                       step_s=[])) is None


def test_the_nccl_share_reads_the_union_of_nccl_kernels():
    ops = [trace.Op("ncclDevKernel_ReduceScatter", "kernel", 100.0, 50.0,
                    None),
           trace.Op("ncclDevKernel_AllGather", "kernel", 120.0, 60.0, None),
           trace.Op("gemm", "kernel", 100.0, 500.0, None),
           trace.Op("ncclDevKernel_AllReduce", "kernel", 900.0, 100.0,
                    None)]
    tr = trace.Trace(ops=ops, spans={}, window=(0.0, 1000.0))
    got = _reader("nccl_share.train").read(SimpleNamespace(trace=tr))
    assert got == pytest.approx(100.0 * (80.0 + 100.0) / 1000.0)
    none = trace.Trace(ops=ops[2:3], spans={}, window=(0.0, 1000.0))
    assert _reader("nccl_share.train").read(SimpleNamespace(trace=none)) \
        is None


def test_the_conv_reader_reads_its_span():
    from repro_torch import tracing
    src = (PERFBENCH / "metrics" / "ssm_conv_ms.prefill.py").read_text()
    assert '"prefill/ssm/conv"' in src
    tracing.reset()
    tr = trace.Trace(ops=[], spans={}, window=(0.0, 1e9))
    assert _reader("ssm_conv_ms.prefill").read(SimpleNamespace(trace=tr)) \
        is None
    assert _reader("ssm_conv_ms.prefill").read(SimpleNamespace(trace=None)) \
        is None


def test_the_new_cells_and_metrics_are_entered():
    bench = registry.load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells["hymba_1_5b.train_b16_s4096_4card"]["chips"] == 4
    assert cells["granite_4_0_h_small.serve_b4_p8192"]["chips"] == 1
    c = registry.cell("hymba_1_5b.train_b16_s4096_4card")
    assert (c.traffic["ranks"], c.traffic["global_batch"],
            c.traffic["seq_len"]) == (4, 16, 4096)
    per = {m["name"]: m for m in bench["per_layer"]}
    for name in ("flash_roofline.prefill", "mfu.prefill", "mfu.train"):
        assert not {"granite_4_0_h_small.serve_b4_p8192",
                    "hymba_1_5b.train_b16_s4096_4card"} & \
            set(per[name]["workloads"])
    assert Path(PERFBENCH / "reference" / "granite.py").exists()
