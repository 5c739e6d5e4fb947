"""The partitioned dry run (``repro_torch.launch.dryrun.trace_partitioned``
and ``run_cell_with_probes``) on the CPU: rank 0's local program of a
step on a DTensor mesh over torch's fake process group, on the meta
device. Nothing is compared by value under the fake backend (its
collectives compute nothing): only shapes, counts and bytes.

- The wire formula (``roofline.wire_bytes``) equals the reference's
  ``parse_collectives`` on one synthetic HLO line, for every kind, four
  group sizes and two dtypes.
- ``sharding.placements``: DTensor's own local shape of every parameter,
  optimizer and cache leaf of every arch's smoke config equals
  ``shard_shape`` and ``NamedSharding.shard_shape`` on 1x1, 2x2, 16x16
  and 2x16x16.
- On 1x1 the partitioned trace gives exactly the unpartitioned counts
  and no collective; a column-parallel product on 1x4 counts a quarter
  of its global FLOPs; the L=1/L=2 probes extrapolate exactly to an L=3
  trace on 2x2.
- A 4x1 (data-only) train step: the wire bytes equal the closed-form
  gradient all-reduce and the reference's ``parse_collectives`` of its
  compiled HLO for the same cell (a subprocess); under ZeRO-1 the
  gradients are reduce-scattered and the parameters all-gathered.
- A 2x2 tensor-parallel prefill of hymba's smoke config: the port's
  ``by_kind`` beside the reference's, held within a stated ratio.
- The MoE layer partitioned (expert parallelism over "model", each rank
  routing its rows' groups): on 1x1 the same counts as unpartitioned
  under both dispatches; a 4x1 train step's wire bytes in closed form,
  the all-reduce bytes equal to the reference's HLO; a 2x2 deepseek
  prefill beside the reference's; ``fsdp_experts`` all-gathering the
  expert weights over "data"; and, on four real gloo ranks on the CPU,
  the layer's output, aux loss, every gradient and the dispatch slots
  equal to one device's (a group spanning the data shards included).
- No process group is left up after any test.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec

import repro_torch
from repro.launch.roofline import parse_collectives
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import device_mesh, fake_world, make_mesh
from repro_torch.models.config import ShapeConfig
from repro_torch.models.model import LM, cache_specs, param_shapes, param_specs
from repro_torch.models.sharding import placements, shard_shape, tp_size
from repro_torch.optim import adamw

repro_torch.set_default_device("cpu")
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
HLO_DTYPES = {"bf16": 2, "f32": 4}
HLO_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")


@pytest.fixture(autouse=True)
def _no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def _widened(arch, **changes):
    """The smoke config with 16 routed experts and 16 SSM heads where it
    has them, so it splits 16 ways (as ``test_torch_dryrun`` widens it)."""
    cfg = get_config(arch).smoke()
    if cfg.n_experts:
        cfg = cfg.replace(n_experts=16)
    if cfg.has_ssm:
        cfg = cfg.replace(ssm_heads=16)
    return cfg.replace(**changes)


# ------------------------------------------------------------ wire bytes
@pytest.mark.parametrize("dtype", list(HLO_DTYPES))
@pytest.mark.parametrize("g", [2, 4, 16, 32])
@pytest.mark.parametrize("kind", HLO_KINDS)
def test_wire_formula_equals_parse_collectives(kind, g, dtype):
    """One HLO line in the reference's format (the op's result type
    first, its group as explicit replica groups or as an iota), parsed
    by the reference and costed by the port from the same output bytes
    and group size."""
    shape = (8, 2 * g, 16)
    ty = f"{dtype}[{','.join(map(str, shape))}]{{2,1,0}}"
    if kind == "collective-permute":
        groups = "source_target_pairs={{0,1},{1,0}}"
    elif g % 4:
        groups = "replica_groups={{" + ",".join(map(str, range(g))) + "}}"
    else:
        groups = f"replica_groups=[{64 // g},{g}]<=[64]"
    line = (f"  %c.1 = {ty} {kind}({ty} %p.0), channel_id=1, {groups}, "
            f"use_global_device_ids=true")
    ref = parse_collectives(line)
    out_bytes = math.prod(shape) * HLO_DTYPES[dtype]
    assert ref.count == 1 and list(ref.by_kind) == [kind]
    assert roofline.wire_bytes(kind, out_bytes, g) == ref.wire_bytes
    assert ref.wire_bytes > 0


def test_wire_formula_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="unknown collective kind"):
        roofline.wire_bytes("all-to-one", 8, 2)


# ------------------------------------------------------ world and meshes
def test_fake_world_starts_and_stops_once():
    with fake_world(4):
        assert dist.get_world_size() == 4 and dist.get_rank() == 0
        with fake_world(4):                 # nested: the same group
            assert dist.get_world_size() == 4
        assert dist.is_initialized()
        with pytest.raises(RuntimeError, match="cannot start"):
            with fake_world(8):
                pass
        dm = device_mesh(make_mesh((2, 2), ("data", "model")))
        assert dm.mesh_dim_names == ("data", "model")
        assert tuple(dm.shape) == (2, 2)
    assert not dist.is_initialized()


def _dtensor_local_shape(shape, sp, dm):
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    local, _ = compute_local_shape_and_global_offset(
        torch.Size(shape), dm, placements(sp, dm))
    return tuple(local)


# the MoE archs with ``fsdp_experts`` flipped: the expert leaves split
# over "model" only, and over "model" and the data axes
FLIPPED = {"deepseek_moe_16b-fsdp_experts": ("deepseek_moe_16b",
                                             {"fsdp_experts": True}),
           "llama4_maverick_400b_a17b-no_fsdp_experts": (
               "llama4_maverick_400b_a17b", {"fsdp_experts": False})}


@pytest.mark.parametrize("arch", ARCHS + list(FLIPPED))
def test_dtensor_local_shapes_equal_shard_shape(arch):
    """Every parameter, AdamW (ZeRO-1) and cache leaf of the widened
    smoke config: DTensor's local shape for ``placements(spec)`` equals
    ``shard_shape`` and jax's ``NamedSharding.shard_shape``, on four
    meshes; the MoE archs also with ``fsdp_experts`` flipped."""
    arch, over = FLIPPED.get(arch, (arch, {}))
    cfg = _widened(arch, **over)
    for name, (sizes, axes) in MESHES.items():
        mesh = make_mesh(sizes, axes)
        ref_mesh = AbstractMesh(sizes, axes)
        tp = tp_size(mesh)
        pshapes = param_shapes(cfg, tp)
        pspecs = param_specs(cfg, mesh)
        leaves = {f"param.{k}": (s, pspecs[k]) for k, (s, _) in
                  pshapes.items()}
        ospecs = adamw.state_specs(pspecs, pshapes, mesh, zero1=True)
        leaves.update({f"m.{k}": (s, ospecs["m"][k]) for k, (s, _) in
                       pshapes.items()})
        for batch in (4 * math.prod(sizes[:-1]), 1):
            lm = LM(cfg, "meta", tp=tp)
            cspecs = cache_specs(cfg, mesh, batch=batch)
            leaves.update({f"cache{batch}.{k}": (s, cspecs[k]) for k, (s, _)
                           in lm.cache_shapes(batch, 64).items()})
        with fake_world(mesh.size):
            dm = device_mesh(mesh)
            for key, (shape, sp) in leaves.items():
                want = shard_shape(tuple(shape), sp, mesh)
                assert _dtensor_local_shape(shape, sp, dm) == want, (name,
                                                                     key)
                assert NamedSharding(ref_mesh, PartitionSpec(*sp)) \
                    .shard_shape(tuple(shape)) == want, (name, key)
    if cfg.n_experts:
        # the routed experts: E over "model", and their input axis over
        # the data axes under fsdp_experts
        sp = param_specs(cfg, mesh)["blocks.moe.w_gate"]
        data = ("pod", "data") if "pod" in mesh.axis_names else "data"
        assert sp == (None, "model", data if cfg.fsdp_experts else None,
                      None)


def test_placements_of_a_tuple_entry():
    from torch.distributed.tensor import Replicate, Shard
    with fake_world(512):
        dm = device_mesh(make_mesh(*MESHES["2x16x16"]))
        assert placements((("pod", "data"), None, "model"), dm) == (
            Shard(0), Shard(0), Shard(2))
        assert placements((None, None), dm) == (Replicate(),) * 3
        with pytest.raises(ValueError, match="not on the mesh"):
            placements(("expert",), dm)


# ----------------------------------------------------------------- trace
def _shape(kind, batch=4, seq=64):
    return ShapeConfig(f"{kind}_{batch}x{seq}", seq, batch, kind)


@pytest.mark.parametrize("arch,kind,over", [
    ("yi_34b", "train", {}), ("yi_34b", "prefill", {}),
    ("yi_34b", "decode", {}),
    ("hymba_1_5b", "train", {}),
    ("hymba_1_5b", "prefill", {"attn_impl": "flash"}),
    ("hymba_1_5b", "decode", {}),
    ("mamba2_370m", "train", {}), ("mamba2_370m", "prefill", {}),
    ("mamba2_370m", "decode", {}),
    ("deepseek_moe_16b", "train", {}), ("deepseek_moe_16b", "prefill", {}),
    ("deepseek_moe_16b", "decode", {}),
    ("deepseek_moe_16b", "train", {"moe_impl": "sort"}),
    ("deepseek_moe_16b", "prefill", {"moe_impl": "sort"}),
    ("deepseek_moe_16b", "decode", {"moe_impl": "sort"})])
def test_partitioned_equals_unpartitioned_on_1x1(arch, kind, over):
    """On a 1x1 mesh rank 0's local program is the whole step: the same
    FLOPs, bytes, temp and output bytes as the unpartitioned trace, and
    no collective (the MoE layer under both dispatches too)."""
    cfg = get_config(arch).smoke().replace(**over)
    mesh = make_mesh((1, 1), ("data", "model"))
    shp = _shape(kind)
    part = dryrun.trace_partitioned(cfg, shp, mesh)
    rec = dryrun.run_cell(arch, shp, False, dataclasses.asdict(cfg),
                          mesh=mesh)
    assert part["flops"] == rec["cost_global"]["flops"] > 0
    assert part["bytes_accessed"] == rec["cost_global"]["bytes_accessed"]
    assert part["temp_bytes"] == rec["memory_global"]["temp_bytes"]
    assert part["output_bytes"] == rec["memory_global"]["output_bytes"]
    assert part["collectives"] == roofline.CollectiveStats()


def test_column_parallel_product_counts_a_quarter_per_device():
    """[B,S,D] @ [D,F] with the weight split over F on a 1x4 mesh: rank
    0 multiplies [B,S,D] by its [D,F/4], a quarter of the global FLOPs,
    with no collective; reading and writing its shards only."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    b, s, d, f = 8, 128, 256, 1024
    with fake_world(4):
        dm = device_mesh(make_mesh((1, 4), ("data", "model")))
        x = DTensor.from_local(torch.empty(b, s, d, device="meta"), dm,
                               [Replicate(), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(d, f // 4, device="meta"), dm,
                               [Replicate(), Shard(1)], run_check=False)
        got = dryrun.trace_local(lambda a, c: a @ c, x, w, known=(x, w))
    assert got["flops"] == 2 * b * s * d * f // 4
    assert got["collectives"].count == 0
    assert got["output_bytes"] == b * s * (f // 4) * 4


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_partitioned_probes_extrapolate_to_three_layers(kind):
    """hymba's smoke config on 2x2: v(1) + 2 (v(2) - v(1)) equals a
    partitioned L=3 trace exactly, for the FLOPs, bytes, wire bytes,
    count and every kind. Without ZeRO-1: ``zero1_spec`` splits a stacked
    leaf's layer axis over the data axes when the data degree divides it,
    so the moments of L=1 and L=2 are laid out otherwise than those of
    L=3 (the reference's probes share this)."""
    mesh = make_mesh((2, 2), ("data", "model"))
    shp = _shape(kind)
    got = {d: dryrun.trace_partitioned(
        _widened("hymba_1_5b", n_layers=d, scan_layers=False, zero1=False),
        shp, mesh) for d in (1, 2, 3)}
    for key in ("flops", "bytes_accessed"):
        assert dryrun._extrapolate(got[1][key], got[2][key], 3) == \
            got[3][key], key
    st = {d: got[d]["collectives"] for d in (1, 2, 3)}
    assert st[2].count > st[1].count > 0
    assert dryrun._extrapolate(st[1].wire_bytes, st[2].wire_bytes, 3) == \
        st[3].wire_bytes
    assert dryrun._extrapolate(st[1].count, st[2].count, 3) == st[3].count
    assert dryrun._extrapolate(st[1].by_kind, st[2].by_kind, 3) == \
        st[3].by_kind


# ------------------------------------------------- against the reference
_REF_CELLS = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json
import jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.launch import dryrun
from repro.models.config import SHAPES, ShapeConfig
for arch, shape, mesh, over in json.loads(sys.argv[1]):
    # an Auto-axis mesh: jax 0.9's default Explicit axes break the
    # reference LM's with_sharding_constraint (ROADMAP, queue C)
    dryrun.make_production_mesh = lambda multi_pod=False, m=mesh: \\
        jax.make_mesh(tuple(m), ("data", "model"),
                      axis_types=(AxisType.Auto,) * 2)
    SHAPES[shape[0]] = ShapeConfig(*shape)
    cfg = dataclasses.asdict(get_config(arch).smoke().replace(**over))
    rec = dryrun.run_cell(arch, shape[0], False, cfg)
    print("JSON:" + json.dumps(rec["collectives"]))
"""

# the reference's cells: unrolled layers (XLA counts a scanned body once)
_TRAIN_DP = ("yi_34b", ("train_4x64", 64, 4, "train"), (4, 1),
             {"zero1": False, "dtype": "float32", "scan_layers": False})
_PREFILL_TP = ("hymba_1_5b", ("prefill_4x64", 64, 4, "prefill"), (2, 2),
               {"scan_layers": False})
# the MoE smoke model (4 experts, top 2, 2 shared): 4 x 64 tokens in
# groups of 64, one a data rank; and a 2x2 prefill in groups of 64 and
# at the default group (512: the 256 tokens are one group that spans
# both data ranks)
_MOE_TRAIN_DP = ("deepseek_moe_16b", ("train_4x64", 64, 4, "train"), (4, 1),
                 {"zero1": False, "dtype": "float32", "scan_layers": False,
                  "moe_group": 64})
_MOE_PREFILL_TP = {
    group: ("deepseek_moe_16b", ("prefill_4x64", 64, 4, "prefill"), (2, 2),
            {"scan_layers": False, "moe_group": group})
    for group in (64, 512)}
_REF_NAMES = ("train_dp", "prefill_tp", "moe_train_dp", "moe_prefill_tp64",
              "moe_prefill_tp512")


@pytest.fixture(scope="module")
def reference_collectives():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _REF_CELLS,
         json.dumps([_TRAIN_DP, _PREFILL_TP, _MOE_TRAIN_DP,
                     _MOE_PREFILL_TP[64], _MOE_PREFILL_TP[512]])],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(ln[5:]) for ln in out.stdout.splitlines()
             if ln.startswith("JSON:")]
    return dict(zip(_REF_NAMES, lines))


def _port(cell):
    arch, shape, sizes, over = cell
    cfg = get_config(arch).smoke().replace(**over)
    return cfg, dryrun.trace_partitioned(
        cfg, ShapeConfig(*shape), make_mesh(sizes, ("data", "model")))


def test_data_parallel_train_wire_equals_closed_form_and_reference(
        reference_collectives):
    """yi_34b's smoke config in f32 on 4x1, no ZeRO-1: the only
    collectives are the all-reduce of every gradient, 2 (g-1)/g of its
    bytes, and of the loss's two sums over the batch (f32 scalars). The
    reference's compiled HLO for the same cell has the same wire bytes."""
    cfg, got = _port(_TRAIN_DP)
    g = 4
    grads = sum(math.prod(s) * dt.itemsize
                for s, dt in param_shapes(cfg, 1).values())
    closed = 2 * (g - 1) / g * (grads + 2 * 4)
    st = got["collectives"]
    assert set(st.by_kind) == {"all-reduce"}
    assert st.wire_bytes == closed
    assert st.wire_bytes == reference_collectives["train_dp"]["wire_bytes"]


def test_zero1_reduce_scatters_gradients():
    """The same cell under ZeRO-1 (the config's default): gradients are
    reduce-scattered onto the data-sharded moments and the parameters
    all-gathered after the update, as the reference constrains them; only
    scalars are all-reduced: the loss's two sums and the gradient norm's
    sum of squares, once (``adamw._sum_of_squares``)."""
    cfg = get_config("yi_34b").smoke().replace(dtype="float32",
                                               scan_layers=False)
    assert cfg.zero1
    got = dryrun.trace_partitioned(cfg, _shape("train"),
                                   make_mesh((4, 1), ("data", "model")))
    kinds = got["collectives"].by_kind
    assert kinds["reduce-scatter"] == kinds["all-gather"] > 0
    assert kinds["all-reduce"] == 2 * (4 - 1) / 4 * 4 * 3   # three scalars


# the port's wire bytes over the reference's on the 2x2 prefill (measured
# 0.123: the reference gathers each 512-key f32 block of its blockwise
# attention over the data axis, and permutes; see PERF.md)
PREFILL_TP_RATIO = (0.05, 0.5)


def test_tensor_parallel_prefill_by_kind_beside_the_reference(
        reference_collectives, capsys):
    _, got = _port(_PREFILL_TP)
    ref = reference_collectives["prefill_tp"]
    st = got["collectives"]
    with capsys.disabled():
        print(f"\nhymba smoke prefill 4x64 on 2x2: port {st.by_kind} "
              f"({st.count} ops), reference {ref['by_kind']} "
              f"({ref['count']} ops)")
    assert set(st.by_kind) == {"all-gather", "reduce-scatter", "all-to-all"}
    lo, hi = PREFILL_TP_RATIO
    assert lo < st.wire_bytes / ref["wire_bytes"] < hi


# ------------------------------------------------------------------- MoE
@pytest.mark.parametrize("impl", ["einsum", "sort"])
def test_moe_data_parallel_train_wire_equals_closed_form(
        impl, reference_collectives, capsys):
    """deepseek's smoke config in f32 on 4x1, no ZeRO-1, groups of 64
    tokens (one a data rank, so the dispatch moves nothing): the wire
    bytes are, in closed form, the all-reduce of every gradient, of the
    loss's two sums (f32 scalars) and of the aux loss's two sums over
    the tokens (router probabilities and assignments, [E] f32 each) a
    layer; their backward adds nothing (a replicated gradient of a
    partial sum is laid back out for free). The reference's compiled
    HLO all-reduces the same bytes to the byte; it also all-gathers one
    [groups, 64, E] f32 tensor a layer (the router's probabilities of
    every group), which the port keeps local: both printed by kind."""
    arch, shape, sizes, over = _MOE_TRAIN_DP
    cfg, got = _port((arch, shape, sizes, dict(over, moe_impl=impl)))
    g = 4
    grads = sum(math.prod(s) * dt.itemsize
                for s, dt in param_shapes(cfg, 1).values())
    aux = cfg.n_layers * 2 * cfg.n_experts * 4
    closed = 2 * (g - 1) / g * (grads + 2 * 4 + aux)
    st = got["collectives"]
    ref = reference_collectives["moe_train_dp"]
    with capsys.disabled():
        print(f"\ndeepseek smoke train 4x64 on 4x1 ({impl}): port "
              f"{st.by_kind} ({st.count} ops), reference (einsum) "
              f"{ref['by_kind']} ({ref['count']} ops)")
    assert set(st.by_kind) == {"all-reduce"}
    assert st.wire_bytes == closed
    assert st.by_kind["all-reduce"] == ref["by_kind"]["all-reduce"]
    assert set(ref["by_kind"]) == {"all-reduce", "all-gather"}
    assert ref["by_kind"]["all-gather"] == cfg.n_layers * (g - 1) / g * (
        4 * 64 * cfg.n_experts * 4)


# the port's wire bytes over the reference's on the 2x2 MoE prefill
# (measured 0.095 in groups of 64 and 0.132 at the default group: the
# reference gathers blockwise attention's f32 blocks as in the hymba
# cell and all-reduces its expert outputs in f32 over "model"; the port
# reduce-scatters the bf16 sum of each block's partial outputs; see
# PERF.md)
MOE_PREFILL_TP_RATIO = (0.05, 0.5)


@pytest.mark.parametrize("group", [64, 512])
def test_moe_tensor_parallel_prefill_by_kind_beside_the_reference(
        group, reference_collectives, capsys):
    """deepseek's smoke prefill of 4 x 64 tokens on 2x2: two experts a
    rank, the groups inside a data rank (64) or spanning both (512, the
    tokens all-gathered over "data" a layer)."""
    _, got = _port(_MOE_PREFILL_TP[group])
    ref = reference_collectives[f"moe_prefill_tp{group}"]
    st = got["collectives"]
    with capsys.disabled():
        print(f"\ndeepseek smoke prefill 4x64 on 2x2, groups of {group}: "
              f"port {st.by_kind} ({st.count} ops), reference "
              f"{ref['by_kind']} ({ref['count']} ops)")
    assert {"all-gather", "reduce-scatter"} <= set(st.by_kind)
    lo, hi = MOE_PREFILL_TP_RATIO
    assert lo < st.wire_bytes / ref["wire_bytes"] < hi


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_fsdp_experts_gathers_the_expert_weights_over_data(kind):
    """deepseek's smoke config on 2x2 (bf16, no ZeRO-1) with and without
    ``fsdp_experts``: the expert weights, split over "data" too, are
    all-gathered over it at use, three a layer, and in training their
    gradients reduce-scattered back a layer, where without it the train
    step all-reduces each stacked gradient leaf once; the gradient
    norm's sum of squares, now split over "data" too, adds one f32
    scalar's all-reduce. Nothing else changes."""
    mesh = make_mesh((2, 2), ("data", "model"))
    base = get_config("deepseek_moe_16b").smoke().replace(
        scan_layers=False, zero1=False, moe_group=64)
    got = {fsdp: dryrun.trace_partitioned(
        base.replace(fsdp_experts=fsdp), _shape(kind), mesh)["collectives"]
        for fsdp in (False, True)}
    g = 2
    leaf = base.n_experts // 2 * base.d_model * base.d_ff * 2   # bf16
    n = 3 * base.n_layers
    diff = {k: got[True].by_kind.get(k, 0) - got[False].by_kind.get(k, 0)
            for k in {**got[True].by_kind, **got[False].by_kind}}
    want = {"all-gather": n * (g - 1) / g * leaf, "reduce-scatter": 0,
            "all-reduce": 0, "all-to-all": 0}
    ops = n
    if kind == "train":
        # the gradient of a shard [E/2, d/2, f]: (g-1) x its bytes,
        # against 2 (g-1)/g x the unsplit leaf's
        want["reduce-scatter"] = n * (g - 1) * leaf / g
        want["all-reduce"] = -n * 2 * (g - 1) / g * leaf + 2 * (g - 1) / g * 4
        ops = 2 * n - 3 + 1
    assert diff == want
    assert got[True].count - got[False].count == ops


# four gloo ranks on the CPU, each running ``moe_layer`` on its shards
# of one set of seeded weights and tokens and on the whole of them: the
# partitioned output, aux loss and gradients against one device's, and
# every rank's dispatch slots (each slot's expert and whether it fits
# the expert's capacity, over all experts, as the dispatch computes them
# before it keeps its rank's experts); rank 0 writes the results
_GLOO_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
import repro_torch
repro_torch.set_default_device("cpu")
torch.set_num_threads(1)
from torch.distributed.tensor import distribute_tensor
from repro_torch.configs import get_config
from repro_torch.launch.mesh import device_mesh, make_mesh
from repro_torch.models import layers
from repro_torch.models.model import param_specs
from repro_torch.models.sharding import placements

rank, world, port, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=world, rank=rank)
rng = np.random.default_rng(0)
seen = []
local_experts = layers._local_experts
def spy(keep, idx, lo, el, e):
    seen.append([idx.tolist(), keep.tolist()])
    return local_experts(keep, idx, lo, el, e)
layers._local_experts = spy
results = []
for sizes, over in json.loads(sys.argv[5]):
    cfg = get_config("deepseek_moe_16b").smoke().replace(
        dtype="float32", capacity_factor=0.5, **over)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    fs = cfg.n_shared_experts * f
    shapes = {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
              "w_down": (e, f, d), "shared.w_gate": (d, fs),
              "shared.w_up": (d, fs), "shared.w_down": (fs, d)}
    whole = {k: torch.tensor(rng.normal(0, 0.3 if k == "router" else 0.05,
                                        s), dtype=torch.float32)
             for k, s in shapes.items()}
    x = torch.tensor(rng.normal(0, 1, (4, 64, d)), dtype=torch.float32)
    gout = torch.tensor(rng.normal(0, 1, (4, 64, d)), dtype=torch.float32)

    def tree(flat):
        p = {k: v for k, v in flat.items() if "." not in k}
        p["shared"] = {k[7:]: v for k, v in flat.items() if "." in k}
        return p

    seen.clear()
    one = {k: v.clone().requires_grad_() for k, v in whole.items()}
    x1 = x.clone().requires_grad_()
    o1, a1 = layers.moe_layer(cfg, tree(one), x1)
    ((o1 * gout).sum() + 0.37 * a1).backward()
    slots1 = list(seen)
    mesh = make_mesh(tuple(sizes), ("data", "model"))
    dm = device_mesh(mesh, "cpu")
    specs = param_specs(cfg, mesh)
    part = {k: distribute_tensor(
        v, dm, placements(specs["blocks.moe." + k][1:], dm),
        src_data_rank=None).detach().requires_grad_()
        for k, v in whole.items()}
    xp = distribute_tensor(x, dm, placements(("data", None, None), dm),
                           src_data_rank=None).detach().requires_grad_()
    seen.clear()
    op, ap = layers.moe_layer(cfg, tree(part), xp)
    mine = list(seen)
    out, aux = op.full_tensor(), ap.full_tensor()
    ((out * gout).sum() + 0.37 * aux).backward()
    res = {"out": float((out - o1).abs().max()),
           "aux": [float(aux), float(a1)],
           "grads": {k: float((part[k].grad.full_tensor()
                               - one[k].grad).abs().max())
                     for k in whole} | {
               "x": float((xp.grad.full_tensor() - x1.grad).abs().max())},
           "slots1": slots1}
    every = [None] * world
    dist.all_gather_object(every, mine)
    res["slots"] = every
    results.append(res)
if rank == 0:
    json.dump(results, open(out_path, "w"))
dist.destroy_process_group()
"""
# (mesh, overrides): data only, in groups of 64 (one a rank) and in one
# group of 256 that spans the four data ranks, under both dispatches;
# 2x2 with two experts a rank, in groups of 64, at the default group,
# and with fsdp_experts
GLOO_CASES = {
    "4x1-group64": ((4, 1), {"moe_group": 64}),
    "4x1-spanning": ((4, 1), {}),
    "4x1-spanning-sort": ((4, 1), {"moe_impl": "sort"}),
    "2x2-group64": ((2, 2), {"moe_group": 64}),
    "2x2-spanning-sort": ((2, 2), {"moe_impl": "sort"}),
    "2x2-group64-fsdp": ((2, 2), {"moe_group": 64, "fsdp_experts": True}),
}


@pytest.fixture(scope="module")
def gloo_moe(tmp_path_factory):
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out = str(tmp_path_factory.mktemp("gloo") / "moe.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    cases = json.dumps(list(GLOO_CASES.values()))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_WORKER, str(r), "4", str(port), out,
         cases], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), errs[0][-2000:]
    return dict(zip(GLOO_CASES, json.load(open(out))))


@pytest.mark.parametrize("case", list(GLOO_CASES))
def test_moe_layer_on_gloo_ranks_equals_one_device(case, gloo_moe):
    """Each rank routes whole groups (its own, or every group where one
    spans the data ranks), so the dispatch slots, hence the drops, are
    one device's bit for bit, and so is the aux loss; the output and
    every gradient (tokens, router, experts, shared experts) agree in
    f32 to 1e-5. A capacity factor of 0.5 makes the drops many."""
    (dp, tp), _ = GLOO_CASES[case]
    res = gloo_moe[case]
    (one,) = res["slots1"]
    keep = str(one[1])
    assert 0 < keep.count("False") and 0 < keep.count("True")
    spans = "spanning" in case
    for rank, mine in enumerate(res["slots"]):
        (got,) = mine
        want = one if spans else [
            part[len(part) // dp * (rank // tp):
                 len(part) // dp * (rank // tp + 1)] for part in one]
        assert got == want, rank
    assert res["aux"][0] == res["aux"][1]
    assert res["out"] < 1e-5
    assert max(res["grads"].values()) < 1e-5, res["grads"]


# ------------------------------------------------------------- records
def test_probe_record_is_partitioned():
    over = dataclasses.asdict(_widened("hymba_1_5b", n_layers=3))
    shp = _shape("prefill", batch=16)
    rec = dryrun.run_cell_with_probes("hymba_1_5b", shp, False, over)
    assert rec["status"] == "ok"
    assert rec["cost"]["per_device"] == "partitioned"
    assert rec["memory"]["per_device"] == {"argument_bytes": "exact",
                                           "output_bytes": "partitioned",
                                           "temp_bytes": "partitioned"}
    col, cc = rec["collectives"], rec["cost_corrected"]
    assert col["wire_bytes"] == cc["wire_bytes"] > 0
    assert set(col) == {"wire_bytes", "count", "by_kind", "top"}
    assert sum(col["by_kind"].values()) == pytest.approx(col["wire_bytes"])
    assert len(col["top"]) == 6
    assert rec["roofline"] == roofline.terms(cc["flops"],
                                             cc["bytes_accessed"],
                                             cc["wire_bytes"])
    assert rec["roofline"]["collective_s"] == cc["wire_bytes"] / \
        roofline.LINK_BW
    assert rec["cost"]["flops"] == cc["flops"]
    # a partitioned device does more than an even split of the global work
    assert cc["flops"] > rec["cost_global"]["flops"] / 256
    assert rec["memory"]["total_bytes"] == (rec["memory"]["argument_bytes"]
                                            + rec["memory"]["temp_bytes"])
    json.dumps(rec)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_moe_probe_record_is_partitioned(kind):
    """deepseek's widened smoke config (16 experts, one a rank) on
    16x16, cut to 2 layers: a partitioned record with numeric wire bytes
    and collective term. Prefill at batch 16 holds 2 groups of 512
    tokens, which span the 16 data ranks (the tokens are all-gathered
    over "data"); decode at batch 16 one group of 16."""
    over = dataclasses.asdict(_widened("deepseek_moe_16b", n_layers=2))
    rec = dryrun.run_cell_with_probes("deepseek_moe_16b",
                                      _shape(kind, batch=16), False, over)
    assert rec["status"] == "ok"
    assert rec["cost"]["per_device"] == "partitioned"
    assert rec["memory"]["per_device"] == {"argument_bytes": "exact",
                                           "output_bytes": "partitioned",
                                           "temp_bytes": "partitioned"}
    col, cc = rec["collectives"], rec["cost_corrected"]
    assert col["wire_bytes"] == cc["wire_bytes"] > 0
    assert set(col) == {"wire_bytes", "count", "by_kind", "top"}
    assert rec["roofline"]["collective_s"] == cc["wire_bytes"] / \
        roofline.LINK_BW
    # the layer's tokens all-gathered over the 16 data ranks: [16, s, 64]
    labels = [lab for lab, _ in col["top"]]
    assert any(lab.startswith("all-gather g=16 bfloat16[16, ")
               for lab in labels) or kind == "prefill", labels
    json.dumps(rec)


def test_cli_probes_the_multipod_cell(tmp_path):
    """``--multipod-probes``: the 2x16x16 cell's record is partitioned,
    with numeric wire bytes and collective term (mamba2_370m decode_32k
    at its published widths, cut to 2 layers)."""
    out = str(tmp_path / "dry.jsonl")
    dryrun.main(["--arch", "mamba2_370m", "--shape", "decode_32k",
                 "--mesh", "multipod", "--multipod-probes", "--out", out,
                 "--override", '{"n_layers": 2}'])
    (rec,) = [json.loads(line) for line in open(out)]
    assert rec["mesh"] == "2x16x16" and rec["status"] == "ok"
    assert rec["cost"]["per_device"] == "partitioned"
    assert rec["collectives"]["wire_bytes"] > 0
    assert rec["roofline"]["collective_s"] > 0


@pytest.mark.parametrize("arch", ["yi_34b", "hymba_1_5b", "mamba2_370m"])
def test_partitioned_prefill_with_cache_then_decode(arch):
    """The serving path on a 2x2 mesh: ``prefill_with_cache`` builds the
    ring and SSM state as DTensors laid out by ``cache_specs`` (each
    local shard ``shard_shape``'s), and a decode step reads and updates
    it; shapes only."""
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = get_config(arch).smoke()
    mesh = make_mesh((2, 2), ("data", "model"))
    with fake_world(4):
        lm, _, _, args = dryrun.partitioned_cell(cfg, _shape("prefill"), mesh)
        tokens = args["batch"]["tokens"]
        with implicit_replication():
            lg, cache = lm.prefill_with_cache(tokens)
            lg2, cache = lm.decode_step(cache, tokens[:, :1], 64)
        specs = cache_specs(cfg, mesh, batch=4)
        assert set(cache) == set(specs)
        for k, t in cache.items():
            assert tuple(t.to_local().shape) == shard_shape(
                tuple(t.shape), specs[k], mesh), k
        assert lg.shape == lg2.shape == (4, 1, lm.vocab_pad)
