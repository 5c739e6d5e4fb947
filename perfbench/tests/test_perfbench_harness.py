"""The benchmark's harness on the CPU: cells, configurations, mixes and
metrics found by name (and new ones found as added files), the frozen
counts against hand-worked values, the plain reference against the
port's LM at tiny sizes, the served cell's comparison refusing a broken
timed path and the float8 control, the trace reading, and the import
rules (no JAX, no JAX package; the reference imports nothing of the
port)."""
from __future__ import annotations

import ast
import contextlib
import hashlib
import json
import re
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench.harness import counts, registry, result, trace, weights
from perfbench.kinds import serve, train
from perfbench.reference import lm as ref
from perfbench.tests import tiny

BENCH = registry.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
PERFBENCH = registry.ROOT / "perfbench"


@pytest.fixture(autouse=True)
def _cpu():
    from repro_torch import set_default_device
    set_default_device("cpu")


@pytest.fixture
def tiny_root(tmp_path):
    return tiny.make_root(tmp_path)


def _ctx(cell, seed=2 ** 31 + 17, seconds=0.0, traced=False):
    return registry.Context(cell, seed, seconds, traced,
                            torch.device("cpu"), time.perf_counter())


# ----------------------------------------------------------- by name
@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves(name):
    cell = registry.cell(name)
    assert cell.config["name"] == cell.config_name
    assert registry.kind_module(cell.kind).run
    assert result.limits(name), "every cell has the limits of its checks"
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported


@pytest.mark.parametrize("name", PER_LAYER)
def test_every_metric_reader_resolves(name):
    entry = [m for m in BENCH["per_layer"] if m["name"] == name][0]
    mod = registry.metric_reader(name)
    assert mod.LAYER == entry["layer"] and mod.MOVES == entry["moves"]
    assert callable(mod.read)


def test_benchmark_json_follows_its_rules():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and c["file"].startswith("perfbench/")
        assert NAME.match(c["name"])
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(map(NAME.match, names))
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        for w in m.get("workloads", []):
            assert w in CELLS
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    # a full check with the 24 cells a benchmark may grow to fits its day
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def _digests(root: Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "perfbench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_added_files_are_found_and_nothing_is_edited(tmp_path):
    root = tiny.make_root(tmp_path / "a")
    before = _digests(root)
    d = root / "perfbench"
    (d / "configs" / "extra.json").write_text(
        json.dumps({"name": "extra", "model": tiny.HYBRID}))
    (d / "traffic" / "extra_mix.json").write_text(
        json.dumps(dict(tiny.TRAFFIC, batch=2)))
    (d / "limits" / "extra.extra_mix.json").write_text(
        json.dumps({"served_token_gap": {"limit": 1.0}}))
    (d / "metrics" / "extra_metric.py").write_text(
        'LAYER = "LM"\nMOVES = "requests_per_s"\n\n\n'
        'def read(obs):\n    return 42.0\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "extra", "source": "tests",
                             "file": "perfbench/configs/extra.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "extra.extra_mix", "config": "extra",
                               "traffic": "extra_mix", "chips": 1,
                               "why": "tests"})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "requests_per_s":
            m["workloads"].append("extra.extra_mix")
    bench["per_layer"].append({"name": "extra_metric", "unit": "x",
                               "better": "higher", "source": "host_clock",
                               "layer": "LM", "moves": "requests_per_s",
                               "workloads": ["extra.extra_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = registry.cell("extra.extra_mix", root)
    assert cell.traffic["batch"] == 2 and cell.config["name"] == "extra"
    assert [m["name"] for m in cell.per_layer] == ["extra_metric"]
    assert registry.metric_reader("extra_metric", root).read(None) == 42.0
    assert result.limits("extra.extra_mix", root) == {"served_token_gap": 1.0}
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


# ------------------------------------------------------------ counts
def test_visible_pairs_by_hand():
    for s, w in ((1, 0), (4, 0), (6, 3), (7, 7), (9, 2), (2048, 1024)):
        brute = sum(1 for i in range(s) for j in range(i + 1)
                    if not w or i - j < w)
        assert counts.visible_pairs(s, w) == brute
    assert counts.visible_pairs(4) == 10 and counts.visible_pairs(6, 3) == 15


def test_flash_bound_by_hand():
    # B=1, Hq=2, Hkv=1, S=4, D=16, causal: 10 pairs x 4 x 16 x 2 heads
    t, by = counts.flash_bound_s(1, 2, 1, 4, 16, 0, 2)
    flops, nbytes = 10 * 4 * 16 * 2, (2 * 2 * 4 * 16 + 2 * 1 * 4 * 16) * 2
    assert by == "bytes"
    assert t == pytest.approx(max(flops / 989.4e12, nbytes / 3.35e12))
    t, by = counts.flash_bound_s(16, 25, 5, 2048, 64, 1024, 2)
    assert by == "operations"
    assert t == pytest.approx(1573376 * 4 * 64 * 25 * 16 / 989.4e12)


def test_model_flops_by_hand():
    m = {"family": "dense", "n_layers": 2, "d_model": 8, "n_heads": 2,
         "n_kv_heads": 1, "head_dim": 4, "d_ff": 16, "vocab": 10}
    per_layer = 2 * 8 * 8 + 2 * 8 * 4 + 3 * 8 * 16         # q,o + k,v + mlp
    assert counts.matrix_params_per_token(m) == 2 * per_layer
    attn = 10 * 4 * 4 * 2 * 3 * 2                  # pairs(4) 4D H rows L
    assert counts.prefill_flops(m, 3, 4) == \
        2 * 2 * per_layer * 12 + attn + 2 * 8 * 10 * 3
    assert counts.train_flops(m, 3, 4) == \
        3 * (2 * 2 * per_layer * 12 + attn + 2 * 8 * 10 * 12)
    moe = dict(m, family="moe", n_experts=4, top_k=2, n_shared_experts=1)
    assert counts.matrix_params_per_token(moe) == 2 * (
        2 * 8 * 8 + 2 * 8 * 4 + 8 * 4 + 3 * 8 * 16 * 3)
    ssm = dict(m, family="hybrid", ssm_state=2, ssm_heads=2, ssm_head_dim=3,
               attn_window=2)
    assert counts.mixer_flops(ssm, 1, 4) == 2 * (
        7 * 4 * 4 * 2 + 4 * 2 * 3 * 2 * 4)


@pytest.mark.parametrize("config", ["hymba_1_5b", "deepseek_moe_16b"])
def test_published_counts(config):
    """The served configurations' counts, at their widths: hymba's block
    matrices 1.537 B, deepseek's 2.41 B a token (top-6 of 64 plus 2
    shared)."""
    m = json.loads((PERFBENCH / "configs" / f"{config}.json").read_text())
    got = counts.matrix_params_per_token(m["model"])
    want = {"hymba_1_5b": 32 * (6144000 + 15462400 + 26419200),
            "deepseek_moe_16b": 28 * (4 * 2048 * 2048 + 2048 * 64
                                      + 8 * 3 * 2048 * 1408)}[config]
    assert got == want


# ---------------------------------------------- weights and reference
@pytest.mark.parametrize("config", ["hymba_1_5b", "deepseek_moe_16b"])
def test_weights_are_the_lms_leaves_at_published_widths(config):
    from repro_torch.models.model import LM
    cell = [w for w in BENCH["workloads"] if w["config"] == config][0]
    c = registry.cell(cell["name"])
    lm = LM(registry.model_config(c), "meta")
    serve.check_layout(dict(lm.named_parameters()), c.config["model"])


def test_weights_repeat_from_the_seed():
    a = weights.make(tiny.MOE, 2 ** 31 + 5, "cpu")
    b = weights.make(tiny.MOE, 2 ** 31 + 5, "cpu")
    c = weights.make(tiny.MOE, 2 ** 31 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.moe.w_up"], c["blocks.moe.w_up"])
    assert torch.equal(a["blocks.ln1"], torch.ones_like(a["blocks.ln1"]))
    t = weights.tokens(2 ** 33, 3, 2, 5, 256, "cpu")
    assert torch.equal(t, weights.tokens(2 ** 33, 3, 2, 5, 256, "cpu"))


@pytest.mark.parametrize("config", sorted(tiny.MODELS))
def test_reference_matches_the_port(config):
    """Prefill and every decode step's logits through the cache, float32
    on both sides: the windowed ring and the SSM branch, MoE with dropped
    slots in the prefill's groups and in each step's."""
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models.model import LM
    m = tiny.MODELS[config]
    tr = dict(tiny.TRAFFIC)
    p, n, b = tr["prompt_len"], tr["decode_steps"], tr["batch"]
    lm = LM(registry.model_config(registry.Cell(
        config, 1, config, {"model": m}, tr), attn_impl="flash"), "cpu")
    weights.fill(dict(lm.named_parameters()), m, 9)
    prompts = weights.tokens(9, 0, b, p, m["vocab"], "cpu")
    res = serve_lm(lm, prompts, n, window=serve.window_slots(m, tr))
    w = weights.make(m, 9, "cpu")
    toks = torch.cat([prompts, res.fed], dim=1)
    want = ref.logits_at(m, w, toks, list(range(p - 1, p + n)),
                         serve.calls(tr))
    got = torch.stack([lg[:, 0, :m["vocab"]] for lg in res.logits], dim=1)
    assert (got - want).abs().max() < 1e-5
    if m.get("n_experts"):
        # the same tokens routed in one call: other groups, other drops
        whole = ref.logits_at(m, w, toks, list(range(p - 1, p + n)),
                              [(0, p + n)])
        assert (got - whole).abs().max() > 1e-3


# ------------------------------------------------------ the served cell
@pytest.mark.parametrize("config", sorted(tiny.MODELS))
@pytest.mark.parametrize("traced", [False, True])
def test_serve_run_is_correct(tiny_root, config, traced):
    cell = registry.cell(tiny.cell_name(config), tiny_root)
    out = serve.run(_ctx(cell, seconds=0.2, traced=traced))
    assert out.correct, out.checks
    line = result.line(cell, out, traced, {"platform": "cpu"})
    assert list(line)[-1] == "compared"
    assert line["compared"]["served_token_gap"]["limit"] == tiny.LIMIT
    if traced:
        assert "breakdown" in line
        assert line["metrics"]["decode_step_ms.serve"]["value"] > 0
    else:
        assert set(line["metrics"]) == {"ttft_p95_ms", "requests_per_s",
                                        "setup_s"}
        assert line["attempted"] >= 2 * tiny.TRAFFIC["batch"]


@pytest.mark.parametrize("config", sorted(tiny.MODELS))
@pytest.mark.parametrize("fault", sorted(serve.FAULTS))
def test_serve_run_refuses_a_broken_timed_path(tiny_root, config, fault):
    cell = registry.cell(tiny.cell_name(config), tiny_root)
    with serve.FAULTS[fault]():
        out = serve.run(_ctx(cell))
    assert not out.correct


@pytest.mark.parametrize("fault", [None] + sorted(serve.FAULTS))
def test_a_sample_of_rows_is_checked_and_refuses_faults(tiny_root, fault):
    """``check_rows`` of each checked batch, drawn from the seed: sound runs
    pass, each fault of the timed path is still refused."""
    cell = registry.cell(tiny.cell_name("tiny_hybrid"), tiny_root)
    cell.traffic = dict(cell.traffic, check_rows=2)
    with serve.FAULTS[fault]() if fault else contextlib.nullcontext():
        out = serve.run(_ctx(cell))
    assert out.correct == (fault is None), out.checks


def test_a_routed_model_checks_whole_batches(tiny_root):
    cell = registry.cell(tiny.cell_name("tiny_moe"), tiny_root)
    cell.traffic = dict(cell.traffic, check_rows=2)
    with pytest.raises(ValueError, match="whole batches"):
        serve.run(_ctx(cell))


@pytest.mark.parametrize("config", sorted(tiny.MODELS))
def test_float8_control_is_refused(tiny_root, config):
    """The reference in float8 in the program's place: at these widths
    its first tokens part from float32's on some of 2 x 4 x 13 positions
    (on every one of 8 seeds tried)."""
    cell = registry.cell(tiny.cell_name(config), tiny_root)
    cell.traffic = dict(cell.traffic, batch=4, decode_steps=12)
    got = serve.readings(_ctx(cell, seed=2 ** 31 + 3), control=True)
    assert got["served_token_gap"] <= tiny.LIMIT < \
        got["control_served_token_gap"]


# ----------------------------------------------------- the trained cell
@pytest.mark.parametrize("traced", [False, True])
def test_train_run_is_correct(tiny_root, traced):
    cell = registry.cell(tiny.TRAIN_CELL, tiny_root)
    out = train.run(_ctx(cell, seconds=0.2, traced=traced))
    assert out.correct, out.checks
    line = result.line(cell, out, traced, {"platform": "cpu"})
    if traced:
        assert set(line["metrics"]) == {"mfu.train",
                                        "device_idle_share.train"}
    else:
        assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}
        assert line["metrics"]["train_tokens_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(train.FAULTS))
def test_train_run_refuses_a_broken_timed_path(tiny_root, fault):
    cell = registry.cell(tiny.TRAIN_CELL, tiny_root)
    with train.FAULTS[fault]():
        out = train.run(_ctx(cell))
    assert not out.correct
    worst = max(c.value / c.limit for c in out.checks)
    assert worst > 10


def test_train_control_is_refused(tiny_root):
    cell = registry.cell(tiny.TRAIN_CELL, tiny_root)
    got = train.readings(_ctx(cell), control=True)
    assert all(got[k] <= v for k, v in tiny.TRAIN_LIMITS.items())
    assert any(got["control_" + k] > v for k, v in tiny.TRAIN_LIMITS.items())


# -------------------------------------------------------------- trace
def _chrome(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.window",
         "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.prefill",
         "ts": 10, "dur": 400},
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.decode_step",
         "ts": 500, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 20, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::cat", "ts": 520,
         "dur": 60},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 21, "dur": 2, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 30, "dur": 2, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 510, "dur": 2, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "flash_fwd_kernel_wgmma<64>",
         "ts": 100, "dur": 200, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 250, "dur": 100,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 530,
         "dur": 20, "args": {"correlation": 3}},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.read_chrome(str(path))


def test_trace_reading(tmp_path):
    tr = _chrome(tmp_path)
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s() == pytest.approx(270e-6)       # [100,350] + [530,550]
    assert [o.span for o in tr.ops] == ["prefill", "prefill", "decode_step"]
    assert tr.top_ops(2)[0] == ["flash_fwd_kernel_wgmma<64>", 200e-6]
    gaps = dict(tr.idle_gaps())      # [0, 100], [350, 530], [550, 1000]
    assert gaps == pytest.approx({"prefill: no host op": 100e-6,
                                  "outside spans: no host op": 630e-6})


def test_readers_on_a_trace(tmp_path):
    from types import SimpleNamespace
    m = dict(tiny.HYBRID)
    tr = dict(tiny.TRAFFIC)
    obs = SimpleNamespace(model=m, traffic=tr, trace=_chrome(tmp_path),
                          prefill_s=[0.5, 1.5], decode_step_s=[0.1, 0.3])
    read = {n: registry.metric_reader(n).read(obs) for n in PER_LAYER
            if n.endswith((".prefill", ".serve"))}
    bound, _ = counts.flash_bound_s(3, 4, 2, 40, 16, 16, 2)
    assert read["flash_roofline.prefill"] == pytest.approx(
        100 * bound * 2 / 200e-6)
    assert read["decode_step_ms.serve"] == pytest.approx(200.0)
    assert read["decode_launches_per_step.serve"] == 0      # a copy only
    assert read["device_idle_share.serve"] == pytest.approx(73.0)
    assert read["mfu.prefill"] == pytest.approx(
        100 * counts.prefill_flops(m, 3, 40) / 989.4e12)
    empty = SimpleNamespace(model=m, traffic=tr, trace=None, prefill_s=[],
                            decode_step_s=[])
    assert all(registry.metric_reader(n).read(empty) is None
               for n in PER_LAYER)


# ------------------------------------------------------ the command
def test_run_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    import runpy
    mod = runpy.run_path(str(PERFBENCH / "run.py"))
    rc = mod["main"](["--workload", CELLS[0], "--seed", str(2 ** 31 + 9),
                      "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", object())
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    got = result.forbidden_modules()
    assert "jax" in got and "repro_torch_extra" not in got


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_and_a_reference_free_of_the_port():
    files = [p for p in PERFBENCH.rglob("*.py") if "__pycache__" not in p.parts]
    assert files
    for path in files:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(result.FORBIDDEN), (path, tops)
        if "reference" in path.relative_to(PERFBENCH).parts:
            assert "repro_torch" not in tops, path
