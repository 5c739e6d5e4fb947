"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

- Every arch x shape at smoke size on both production meshes: the status
  (skips exactly ``shape_applicable``'s), the record's keys, the
  even-split per-device figures, the null collective term.
- Two cells at published widths: mamba2_370m decode_32k on the multi-pod
  mesh (the reference's own slow cell) and hymba_1_5b prefill_32k on the
  pod.
- ``memory.argument_bytes`` at published widths for every cell, from
  specs alone, against the same sum over the reference's
  ``ShapeDtypeStruct``s and ``NamedSharding.shard_shape``s (plus the
  bytes of the f32 leaves that the reference's ``param_shapes`` lists in
  the model dtype).
- The L=1/L=2 probes equal the direct count; the JSONL is appended and
  read back.
- On a 1x1 mesh the meta trace's FLOPs equal ``FlopCounterMode`` over
  the real step on the CPU, and the argument bytes the real tensors'
  bytes: ``chip_smoke.py``'s gates on the card, rehearsed at smoke size.
- A slow test holds ``argument_bytes`` of mamba2_370m decode_32k
  multi-pod to the reference's compiled ``memory_analysis``.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from torch.utils.flop_counter import FlopCounterMode

import repro_torch
from repro.configs import get_config as ref_get_config
from repro.launch import specs as ref_specs
from repro.models.config import SHAPES as REF_SHAPES
from repro.models.model import LM as RefLM
from repro.optim import adamw as ref_adamw
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import dryrun, roofline, steps
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models.config import SHAPES, ShapeConfig, shape_applicable
from repro_torch.models.model import LM
from repro_torch.optim import adamw

repro_torch.set_default_device("cpu")
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_LEAVES = ("dt_bias", "A_log", "D")
REF_MESH = {False: AbstractMesh((16, 16), ("data", "model")),
            True: AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
RECORD_KEYS = {"arch", "shape", "mesh", "kind", "status", "lower_s",
               "trace_s", "compile_s", "memory", "memory_global", "cost",
               "cost_global", "collectives", "roofline",
               "model_flops_global", "model_flops_per_chip",
               "useful_flop_ratio"}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _ref_bytes(shapes, specs, mesh):
    shapes, specs = _flat(shapes), _flat(specs)
    assert sorted(shapes) == sorted(specs)
    return sum(math.prod(NamedSharding(mesh, specs[k]).shard_shape(s.shape))
               * s.dtype.itemsize for k, s in shapes.items())


def _ref_argument_bytes(arch, shape, multi_pod):
    """The reference's step arguments, per device: params, AdamW state
    and batch (train), batch (prefill), cache + tokens + t (decode)."""
    cfg, shp, mesh = ref_get_config(arch), REF_SHAPES[shape], \
        REF_MESH[multi_pod]
    lm = RefLM(cfg, mesh)
    total = _ref_bytes(lm.param_shapes(), lm.param_specs(), mesh)
    if shp.kind == "train":
        total += _ref_bytes(ref_adamw.state_shapes(lm.param_shapes()),
                            ref_adamw.state_specs(
                                lm.param_specs(), lm.param_shapes(), mesh,
                                zero1=cfg.zero1), mesh)
        total += _ref_bytes(*ref_specs.train_batch_specs(cfg, shp, mesh),
                            mesh)
    elif shp.kind == "prefill":
        total += _ref_bytes(*ref_specs.prefill_inputs(cfg, shp, mesh), mesh)
    else:
        (cs, cp), (tok, tok_sp), (t, t_sp) = ref_specs.decode_inputs(
            lm, shp, mesh)
        total += _ref_bytes(cs, cp, mesh)
        total += _ref_bytes({"tok": tok, "t": t}, {"tok": tok_sp, "t": t_sp},
                            mesh)
    # the port holds dt_bias, A_log and D in f32, as the reference's init
    # makes them; the reference's param_shapes lists them in the model dtype
    specs = _flat(lm.param_specs())
    for k, s in _flat(lm.param_shapes()).items():
        if k.split(".")[-1] in F32_LEAVES:
            total += math.prod(NamedSharding(mesh, specs[k]).shard_shape(
                s.shape)) * (4 - s.dtype.itemsize)
    return total


def _smoke(arch, **changes):
    """The smoke config as ``run_cell`` overrides, with 16 routed experts
    and 16 SSM heads where it has them (its 4 cannot be split 16 ways, as
    the published 64, 128 and SSM widths can; jax's NamedSharding refuses
    such a layout too)."""
    cfg = get_config(arch).smoke()
    if cfg.n_experts:
        cfg = cfg.replace(n_experts=16)
    if cfg.has_ssm:
        cfg = cfg.replace(ssm_heads=16)
    return dataclasses.asdict(cfg.replace(**changes))


def _cut(shape):
    """A production shape with its sequence cut 16-fold (name, batch and
    kind kept), so the smoke sweep traces in seconds."""
    s = SHAPES[shape]
    return ShapeConfig(s.name, s.seq_len // 16, s.global_batch, s.kind)


def _check_record(rec, cfg, shp, mesh):
    assert set(rec) >= RECORD_KEYS, RECORD_KEYS - set(rec)
    n = mesh.size
    assert rec["mesh"] == mesh.name and rec["kind"] == shp.kind
    assert rec["memory"]["argument_bytes"] == dryrun.argument_bytes(
        cfg, shp, mesh)
    assert rec["cost"]["flops"] == rec["cost_global"]["flops"] / n
    assert rec["cost"]["bytes_accessed"] == \
        rec["cost_global"]["bytes_accessed"] / n
    assert rec["memory"]["temp_bytes"] == \
        rec["memory_global"]["temp_bytes"] / n
    assert rec["memory"]["total_bytes"] == (rec["memory"]["argument_bytes"]
                                            + rec["memory"]["temp_bytes"])
    assert rec["cost"]["per_device"] == "even_split"
    assert rec["collectives"]["wire_bytes"] is None
    assert rec["roofline"]["collective_s"] is None
    assert rec["roofline"]["bottleneck"] in ("compute_s", "memory_s")
    assert rec["cost_global"]["flops"] > 0
    assert rec["cost_global"]["bytes_accessed"] > 0
    assert rec["memory_global"]["temp_bytes"] > 0
    tokens = shp.global_batch * (shp.seq_len if shp.kind != "decode" else 1)
    assert rec["model_flops_global"] == roofline.model_flops(cfg, shp.kind,
                                                             tokens)
    assert rec["model_flops_per_chip"] == rec["model_flops_global"] / n
    assert rec["useful_flop_ratio"] == pytest.approx(
        rec["model_flops_per_chip"] / rec["cost"]["flops"])
    json.dumps(rec)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cells_on_both_meshes(arch):
    over = _smoke(arch)
    cfg = get_config(arch).replace(**over)
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        for shape in SHAPES:
            shp = _cut(shape)
            rec = dryrun.run_cell(arch, shp, multi_pod, over)
            ok, why = shape_applicable(cfg, SHAPES[shape])
            if not ok:
                assert rec == {"arch": arch, "shape": shape,
                               "mesh": mesh.name, "kind": shp.kind,
                               "status": "skipped", "reason": why}
                continue
            assert rec["status"] == "ok", rec
            _check_record(rec, cfg, shp, mesh)


def test_smoke_experts_that_do_not_split_are_refused():
    """Four routed experts cannot be split over the model axis of 16, so
    the cell raises, as NamedSharding does for the reference."""
    with pytest.raises(ValueError, match="do not divide"):
        dryrun.run_cell("deepseek_moe_16b", _cut("decode_32k"), False,
                        dataclasses.asdict(get_config(
                            "deepseek_moe_16b").smoke()))


@pytest.mark.parametrize("arch,shape,multi_pod", [
    ("mamba2_370m", "decode_32k", True), ("hymba_1_5b", "prefill_32k", False)])
def test_published_widths(arch, shape, multi_pod):
    rec = dryrun.run_cell(arch, shape, multi_pod)
    cfg, shp = get_config(arch), SHAPES[shape]
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert rec["status"] == "ok", rec
    assert rec["arch"] == arch
    _check_record(rec, cfg, shp, mesh)
    assert rec["memory"]["argument_bytes"] == _ref_argument_bytes(
        arch, shape, multi_pod)
    # the step fits one H100's 80 GB per device at these meshes
    assert rec["memory"]["total_bytes"] < 80e9


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_at_published_widths(arch):
    """Every cell of every mesh, from specs alone (no trace)."""
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        for shape in SHAPES:
            got = dryrun.argument_bytes(get_config(arch), SHAPES[shape], mesh)
            assert got == _ref_argument_bytes(arch, shape, multi_pod), (
                shape, multi_pod)


def test_probes_equal_the_direct_count():
    """The unpartitioned probes extrapolate to the direct global count
    (``run_cell_with_probes`` raises otherwise); the record keeps the
    partitioned probes' per-device counts, wire bytes included."""
    over = _smoke("hymba_1_5b", n_layers=4)
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        rec = dryrun.run_cell_with_probes("hymba_1_5b", _cut(shape), False,
                                          over)
        direct = dryrun.run_cell("hymba_1_5b", _cut(shape), False, over)
        assert rec["cost_global"] == direct["cost_global"]
        cc = rec["cost_corrected"]
        assert cc["flops"] == pytest.approx(rec["cost"]["flops"], rel=1e-9)
        assert cc["bytes_accessed"] == pytest.approx(
            rec["cost"]["bytes_accessed"], rel=1e-9)
        assert rec["cost"]["per_device"] == "partitioned"
        assert cc["per_layer_flops"] > 0 and cc["wire_bytes"] > 0
        assert rec["collectives"]["wire_bytes"] == cc["wire_bytes"]
        assert rec["roofline"]["collective_s"] > 0


def test_what_is_still_none_is_pinned():
    """What the port's records still leave None: ``compile_s`` in every
    record (nothing is compiled), and the wire bytes of a record without
    partitioned probes (``run_cell``, ``--no-probes``), which says why.
    An MoE cell's probed record is partitioned like any other: its wire
    bytes and collective term are numbers."""
    over = _smoke("deepseek_moe_16b", n_layers=2)
    moe = dryrun.run_cell_with_probes("deepseek_moe_16b", _cut("decode_32k"),
                                      False, over)
    plain = dryrun.run_cell("hymba_1_5b", _cut("decode_32k"), False,
                            _smoke("hymba_1_5b", n_layers=2))
    for rec in (moe, plain):
        assert rec["status"] == "ok" and rec["compile_s"] is None
    assert plain["collectives"]["wire_bytes"] is None
    assert plain["roofline"]["collective_s"] is None
    assert plain["cost"]["per_device"] == "even_split"
    assert plain["collectives"]["reason"] == dryrun.NO_COLLECTIVES
    assert moe["collectives"]["wire_bytes"] > 0
    assert moe["roofline"]["collective_s"] > 0
    assert moe["cost"]["per_device"] == "partitioned"
    assert not hasattr(dryrun, "NO_MOE_STRATEGY")


def _roofline_report():
    """The reference's renderer, loaded by path (read-only)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "roofline_report", os.path.join(ROOT, "benchmarks",
                                        "roofline_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reference_report_renders_a_partitioned_record():
    """``benchmarks/roofline_report.py``'s ``roofline_table`` renders a
    partitioned dense record, its collective term now a number; its
    ``dryrun_table`` still raises on the None ``compile_s``."""
    report = _roofline_report()
    rec = dryrun.run_cell_with_probes("mamba2_370m", _cut("decode_32k"),
                                      False, _smoke("mamba2_370m",
                                                    n_layers=2))
    rec.pop("overrides", None)
    table = report.roofline_table([rec])
    row = table.splitlines()[-1]
    assert row.startswith("| mamba2_370m | decode_32k | ")
    assert f"{rec['roofline']['collective_s']:.3f}" in row
    with pytest.raises(TypeError):
        report.dryrun_table([rec])


def test_jsonl_is_appended_and_read_back(tmp_path, capsys):
    out = str(tmp_path / "d" / "dry.jsonl")
    args = ["--arch", "mamba2_370m", "--shape", "decode_32k", "--mesh",
            "both", "--out", out, "--override", '{"n_layers": 2}']
    dryrun.main(args)
    dryrun.main(args)
    dryrun.main(["--arch", "yi_34b", "--shape", "long_500k", "--mesh",
                 "pod", "--out", out])
    recs = [json.loads(line) for line in open(out)]
    assert [(r["mesh"], r["status"]) for r in recs] == [
        ("16x16", "ok"), ("2x16x16", "ok")] * 2 + [("16x16", "skipped")]
    assert recs[0]["overrides"] == {"n_layers": 2}
    assert "cost_corrected" in recs[0] and "cost_corrected" not in recs[1]
    assert recs[0]["cost"] == recs[2]["cost"]
    assert recs[-1]["reason"].startswith("long_500k skipped")
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("[ok     ] mamba2_370m/decode_32k/16x16")


def _real_arguments(lm, shp):
    """Real CPU tensors of the step's arguments, and the step."""
    gen = torch.Generator().manual_seed(0)
    cfg = lm.cfg
    text = shp.seq_len - (cfg.frontend_len if cfg.frontend ==
                          "vision_patches" else 0)
    batch = {}
    if cfg.frontend != "none":
        fl = shp.seq_len if cfg.frontend == "audio_frames" else \
            cfg.frontend_len
        batch["embeds"] = torch.randn(shp.global_batch, fl, cfg.d_model,
                                      generator=gen).to(lm.dtype)
    if cfg.frontend != "audio_frames":
        batch["tokens"] = torch.randint(0, cfg.vocab, (shp.global_batch,
                                                       text), generator=gen,
                                        dtype=torch.int32)
    if shp.kind == "train":
        batch["labels"] = torch.randint(0, cfg.vocab, (shp.global_batch,
                                                       text), generator=gen,
                                        dtype=torch.int32)
        opt = adamw.init(dict(lm.named_parameters()))
        return [opt, batch], steps.make_train_step(lm), (opt, batch)
    if shp.kind == "prefill":
        return [batch], steps.make_prefill_step(lm), (batch,)
    window = min(shp.seq_len, cfg.attn_window) if cfg.attn_window \
        else shp.seq_len
    cache = lm.init_cache(shp.global_batch, window)
    tok = torch.randint(0, cfg.vocab, (shp.global_batch, 1), generator=gen,
                        dtype=torch.int32)
    t = torch.tensor(shp.seq_len, dtype=torch.int32)
    return [cache, tok, t], steps.make_decode_step(lm), (cache, tok,
                                                         int(t))


def _nbytes(tree):
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


@pytest.mark.parametrize("attn", ["blockwise", "flash"])
@pytest.mark.parametrize("arch", ["hymba_1_5b", "deepseek_moe_16b",
                                  "musicgen_large", "internvl2_76b"])
def test_meta_counts_equal_the_real_step_on_one_device(arch, attn):
    """On a 1x1 mesh: the meta FLOPs equal FlopCounterMode over the real
    step, and argument_bytes the bytes of the real params, state, batch
    and cache. With flash, the prefill goes through the operator's fake
    kernel on meta and its plain kernel on the CPU, counted by the same
    formula; the wrapper launches nothing."""
    cfg = get_config(arch).smoke().replace(attn_impl=attn)
    mesh = make_mesh((1, 1), ("data", "model"))
    for shp in (ShapeConfig("train", 32, 2, "train"),
                ShapeConfig("prefill", 48, 2, "prefill"),
                ShapeConfig("decode", 40, 2, "decode")):
        if attn == "flash" and shp.kind == "train":
            continue            # flash has no backward
        rec = dryrun.run_cell(arch, shp, False, dataclasses.asdict(cfg),
                              mesh=mesh)
        assert rec["status"] == "ok" and rec["mesh"] == "1x1"
        lm = LM(cfg, "cpu").init(torch.Generator().manual_seed(0))
        args, fn, fargs = _real_arguments(lm, shp)
        assert rec["memory"]["argument_bytes"] == _nbytes(
            dict(lm.named_parameters())) + _nbytes(args), shp.kind
        before = flash_attention.launches
        with FlopCounterMode(display=False) as fc:
            fn(*fargs)
        assert rec["cost_global"]["flops"] == fc.get_total_flops(), shp.kind
        assert rec["cost"]["flops"] == fc.get_total_flops()
        assert flash_attention.launches == before


def test_real_device_lm_with_tp_is_refused():
    with pytest.raises(ValueError):
        LM(get_config("hymba_1_5b").smoke(), "cpu", tp=16)


_REF_SCRIPT = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json
import jax
from jax.sharding import AxisType
from repro.launch import dryrun
# an Auto-axis mesh: jax 0.9's default Explicit axes break the reference
# LM's with_sharding_constraint (ROADMAP, queue C)
dryrun.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
    (2, 16, 16), ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)
rec = dryrun.run_cell("mamba2_370m", "decode_32k", True)
print("JSON:" + json.dumps(rec["memory"]))
"""


@pytest.mark.slow
def test_argument_bytes_equal_the_reference_compiled_cell():
    """mamba2_370m decode_32k on 2x16x16: the port's exact per-device
    argument bytes against the reference's XLA ``memory_analysis``
    (512 host devices, in a subprocess). They differ by 9220 bytes, for
    two reasons: the reference lowers dt_bias, A_log and D from its
    ``param_shapes`` in bf16, 2 bytes an element fewer (48 layers x 3
    leaves x 32 heads x 2 = 9216 bytes), where its ``init`` and the port
    hold them in f32; and jit drops the 0-d int32 position ``t``, which
    an attention-free model never reads (4 bytes), where the port counts
    every argument of the step."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("JSON:")]
    ref = json.loads(line[0][5:])
    cfg = get_config("mamba2_370m")
    mesh = make_production_mesh(multi_pod=True)
    got = dryrun.argument_bytes(cfg, SHAPES["decode_32k"], mesh)
    f32_extra = cfg.n_layers * 3 * cfg.ssm_heads * (4 - 2)
    assert f32_extra == 9216
    assert got == ref["argument_bytes"] + f32_extra + 4
