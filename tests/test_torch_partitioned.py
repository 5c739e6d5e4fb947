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


@pytest.mark.parametrize("arch", ARCHS)
def test_dtensor_local_shapes_equal_shard_shape(arch):
    """Every parameter, AdamW (ZeRO-1) and cache leaf of the widened
    smoke config: DTensor's local shape for ``placements(spec)`` equals
    ``shard_shape`` and jax's ``NamedSharding.shard_shape``, on four
    meshes."""
    cfg = _widened(arch)
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
    ("mamba2_370m", "decode", {})])
def test_partitioned_equals_unpartitioned_on_1x1(arch, kind, over):
    """On a 1x1 mesh rank 0's local program is the whole step: the same
    FLOPs, bytes, temp and output bytes as the unpartitioned trace, and
    no collective."""
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


@pytest.fixture(scope="module")
def reference_collectives():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _REF_CELLS,
         json.dumps([_TRAIN_DP, _PREFILL_TP])],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(ln[5:]) for ln in out.stdout.splitlines()
             if ln.startswith("JSON:")]
    return dict(zip(("train_dp", "prefill_tp"), lines))


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
    scalars are all-reduced."""
    cfg = get_config("yi_34b").smoke().replace(dtype="float32",
                                               scan_layers=False)
    assert cfg.zero1
    got = dryrun.trace_partitioned(cfg, _shape("train"),
                                   make_mesh((4, 1), ("data", "model")))
    kinds = got["collectives"].by_kind
    assert kinds["reduce-scatter"] == kinds["all-gather"] > 0
    assert kinds["all-reduce"] == 2 * (4 - 1) / 4 * 4 * 4   # four scalars


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


def test_moe_probe_record_keeps_the_even_split():
    over = dataclasses.asdict(_widened("deepseek_moe_16b", n_layers=2))
    rec = dryrun.run_cell_with_probes("deepseek_moe_16b", _shape("decode"),
                                      False, over)
    assert rec["status"] == "ok"
    assert rec["cost"]["per_device"] == "even_split"
    assert rec["collectives"] == {"wire_bytes": None,
                                  "reason": dryrun.NO_MOE_STRATEGY}
    assert rec["cost_corrected"]["wire_bytes"] is None
    assert rec["roofline"]["collective_s"] is None


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
