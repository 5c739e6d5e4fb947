"""The port's meshes, sharding specs, padded plans and input specs against
the JAX package, exactly. The reference's ``LM`` is built on a
``jax.sharding.AbstractMesh`` (no devices needed) of each of four shapes:
1x1, 2x4, the 16x16 pod and the 2x16x16 multi-pod; the port's on the
matching ``LogicalMesh``. Every spec is compared as the tuple of a
``PartitionSpec``'s entries, and every shard shape against
``NamedSharding(mesh, spec).shard_shape``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

import repro_torch
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.launch import specs as ref_specs
from repro.models import sharding as ref_sharding
from repro.models.config import SHAPES as REF_SHAPES
from repro.models.model import LM as RefLM
from repro.optim import adamw as ref_adamw
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import specs
from repro_torch.launch.mesh import (LogicalMesh, make_host_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.models import sharding
from repro_torch.models.config import SHAPES
from repro_torch.models.model import LM, cache_specs, param_shapes, param_specs
from repro_torch.optim import adamw

repro_torch.set_default_device("cpu")

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# f32 whatever the model dtype in the port (and in the reference's init),
# where the reference's param_shapes writes the model dtype
F32_LEAVES = ("dt_bias", "A_log", "D")


def _meshes(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes), AbstractMesh(shape, axes)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _sp(p):
    assert isinstance(p, P), p
    return tuple(p)


def _dt(jdt):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "int32": torch.int32, "int8": torch.int8}[str(jnp.dtype(jdt))]


def test_arch_lists_agree():
    assert ARCHS == REF_ARCHS
    assert {k: (s.seq_len, s.global_batch, s.kind)
            for k, s in SHAPES.items()} == {
        k: (s.seq_len, s.global_batch, s.kind) for k, s in REF_SHAPES.items()}


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_helpers_and_spec_equal_the_reference(name):
    mesh, ref = _meshes(name)
    assert dict(mesh.shape) == dict(ref.shape)
    assert mesh.axis_names == tuple(ref.axis_names)
    assert mesh.size == ref.size and mesh.devices is None
    assert sharding.batch_axes(mesh) == ref_sharding.batch_axes(ref)
    assert sharding.tp_size(mesh) == ref_sharding.tp_size(ref)
    assert sharding.dp_size(mesh) == ref_sharding.dp_size(ref)
    logical = [("batch", None), ("batch", None, "model"), (None, "model"),
               ("model", None), ("vocab",), ("expert", "fsdp", None),
               ("fsdp",), (None,), ()]
    for axes in logical:
        for bs in (None, 1, 4, 128):
            assert sharding.spec(mesh, *axes, batch_size=bs) == _sp(
                ref_sharding.spec(ref, *axes, batch_size=bs)), (axes, bs)
    with pytest.raises(ValueError):
        sharding.spec(mesh, "heads")


def test_production_and_host_meshes():
    pod, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (pod.shape, pod.name, pod.size) == (
        {"data": 16, "model": 16}, "16x16", 256)
    assert (multi.shape, multi.axis_names, multi.name, multi.size) == (
        {"pod": 2, "data": 16, "model": 16}, ("pod", "data", "model"),
        "2x16x16", 512)
    host = make_host_mesh()
    assert host.shape == {"data": 1, "model": 1}
    assert host.devices == (torch.device("cpu"),)
    for bad in (((2, 2), ("data",)), ((2,), ("data",), (None,)),
                ((0, 1), ("data", "model")), ((2, 2), ("data", "data"))):
        with pytest.raises(ValueError):
            LogicalMesh(*bad)


@pytest.mark.parametrize("name", list(MESHES))
def test_shard_shape_equals_named_sharding(name):
    mesh, ref = _meshes(name)
    rng = np.random.RandomState(0)
    axes = mesh.axis_names
    entries = [None, *axes, tuple(axes[:2]), tuple(axes[-2:])]
    for _ in range(200):
        rank = rng.randint(1, 4)
        picked = [entries[i] for i in rng.randint(0, len(entries), rank)]
        names = [a for e in picked if e for a in ((e,) if isinstance(e, str)
                                                 else e)]
        if len(names) != len(set(names)):
            continue
        shape = tuple(int(n) for n in rng.choice([1, 2, 4, 8, 32, 48, 512],
                                                 rank))
        sp = P(*picked)
        try:
            want = NamedSharding(ref, sp).shard_shape(shape)
        except ValueError:
            with pytest.raises(ValueError):
                sharding.shard_shape(shape, tuple(sp), mesh)
            continue
        assert sharding.shard_shape(shape, tuple(sp), mesh) == tuple(want)


def _ref_lm(arch, ref_mesh):
    return RefLM(ref_get_config(arch), ref_mesh)


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_opt_cache_specs_and_shard_shapes(arch, name):
    """param_specs, cache_specs at batch 128 and 1, adamw.state_specs with
    zero1 on and off, and each leaf's shard shape, leaf by leaf."""
    mesh, ref = _meshes(name)
    cfg = get_config(arch)
    rlm = _ref_lm(arch, ref)
    tp = sharding.tp_size(mesh)
    rspecs = _flat(rlm.param_specs())
    rshapes = _flat(rlm.param_shapes())
    pspecs = param_specs(cfg, mesh)
    pshapes = param_shapes(cfg, tp)
    assert list(pspecs) == list(rspecs) == list(pshapes)
    for k, sp in pspecs.items():
        assert sp == _sp(rspecs[k]), k
        assert pshapes[k][0] == tuple(rshapes[k].shape), k
        assert sharding.shard_shape(pshapes[k][0], sp, mesh) == tuple(
            NamedSharding(ref, rspecs[k]).shard_shape(rshapes[k].shape)), k
    for zero1 in (True, False):
        want = ref_adamw.state_specs(rlm.param_specs(), rlm.param_shapes(),
                                     ref, zero1=zero1)
        got = adamw.state_specs(pspecs, pshapes, mesh, zero1=zero1)
        assert got["step"] == _sp(want["step"])
        for part in ("m", "v"):
            w = _flat(want[part])       # jax.tree.map sorts the keys
            assert sorted(got[part]) == sorted(w)
            for k, sp in got[part].items():
                assert sp == _sp(w[k]), (part, k, zero1)
                assert sharding.shard_shape(pshapes[k][0], sp, mesh) == \
                    tuple(NamedSharding(ref, w[k]).shard_shape(
                        rshapes[k].shape)), (part, k)
    lm = LM(cfg, "meta", tp=tp)
    for batch in (128, 1):
        want = rlm.cache_specs(batch=batch)
        got = cache_specs(cfg, mesh, batch=batch)
        assert list(got) == list(want)
        rcache = rlm.cache_shapes(batch, 64)
        cache = lm.cache_shapes(batch, 64)
        assert list(cache) == list(rcache)
        for k, sp in got.items():
            assert sp == _sp(want[k]), (k, batch)
            assert cache[k] == (tuple(rcache[k].shape), _dt(rcache[k].dtype))
            assert sharding.shard_shape(cache[k][0], sp, mesh) == tuple(
                NamedSharding(ref, want[k]).shard_shape(rcache[k].shape))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_at_tp16_equal_the_reference(arch):
    """The padded head plan (hymba's 25 q / 5 kv heads), vocab_pad (32001
    -> 32016) and the stacked shapes at TP 16; dtypes too, but for the
    f32 leaves that the reference's param_shapes lists in the model
    dtype."""
    cfg = get_config(arch)
    rlm = _ref_lm(arch, AbstractMesh((16, 16), ("data", "model")))
    want = _flat(rlm.param_shapes())
    got = param_shapes(cfg, 16)
    assert list(got) == list(want)
    for k, (shape, dt) in got.items():
        assert shape == tuple(want[k].shape), k
        if k.split(".")[-1] in F32_LEAVES:
            assert dt == torch.float32
        else:
            assert dt == _dt(want[k].dtype), k
    lm = LM(cfg, "meta", tp=16)
    assert lm.vocab_pad == rlm.vocab_pad
    assert (vars(lm.plan) if lm.plan else None) == (
        vars(rlm.plan) if rlm.plan else None)
    assert {k: (tuple(p.shape), p.dtype) for k, p in lm.state_dict().items()
            } == got


def test_hymba_plan_pads_at_tp16():
    lm = LM(get_config("hymba_1_5b"), "meta", tp=16)
    assert (lm.plan.n_heads, lm.plan.h_pad, lm.plan.kv_virtual) == (25, 48, 16)
    assert lm.vocab_pad == 32016
    assert LM(get_config("hymba_1_5b"), "meta").vocab_pad == 32001


def test_tp_above_one_needs_the_meta_device():
    with pytest.raises(ValueError, match="meta"):
        LM(get_config("hymba_1_5b").smoke(), "cpu", tp=2)
    # the reference's divisibility checks, as ValueError
    with pytest.raises(ValueError, match="d_ff"):
        param_shapes(get_config("minitron_8b").replace(d_ff=100), 16)
    with pytest.raises(ValueError, match="ssm"):
        param_shapes(get_config("mamba2_370m").replace(ssm_heads=3,
                                                       ssm_head_dim=10), 16)


def test_zero1_spec_cases():
    """The first unsharded divisible axis over the data axes; a tuple for
    two batch axes; a leaf already data-sharded (fsdp) is left alone; the
    identity on one data shard."""
    one, _ = _meshes("1x1")
    pod, ref_pod = _meshes("16x16")
    multi, ref_multi = _meshes("2x16x16")
    cases = [((None, "model"), (64, 32)), ((None, "model"), (48, 32)),
             ((None, None, "model"), (4, 7, 32)), ((), ()),
             (("model", ("pod", "data"), None), (16, 64, 32)),
             (("model", "data", None), (16, 64, 32)), ((None,), (3,))]
    for mesh, ref in ((pod, ref_pod), (multi, ref_multi)):
        for sp, shape in cases:
            names = {a for e in sp if e for a in ((e,) if isinstance(e, str)
                                                 else e)}
            if not names <= set(mesh.axis_names):
                continue
            assert adamw.zero1_spec(sp, shape, mesh) == _sp(
                ref_adamw.zero1_spec(P(*sp), shape, ref)), (sp, shape)
    assert adamw.zero1_spec((None, "model"), (64, 32), multi) == (
        ("pod", "data"), "model")
    assert adamw.zero1_spec((None, "model"), (64, 32), one) == (
        None, "model")


def test_state_shapes():
    shapes = param_shapes(get_config("hymba_1_5b").smoke())
    st = adamw.state_shapes(shapes)
    assert st["step"] == ((), torch.int32)
    for part in ("m", "v"):
        assert st[part] == {k: (s, torch.float32)
                            for k, (s, _) in shapes.items()}
    real = adamw.init(dict(LM(get_config("hymba_1_5b").smoke(),
                              "meta").named_parameters()))
    assert {k: (tuple(t.shape), t.dtype) for k, t in real["m"].items()
            } == st["m"]


def _sds(x):
    return (tuple(x.shape), _dt(x.dtype))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch, shape):
    """specs.train_batch_specs, prefill_inputs and decode_inputs: every
    shape, dtype and spec, on the pod mesh."""
    mesh, ref = _meshes("16x16")
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    shp, rshp = SHAPES[shape], REF_SHAPES[shape]
    for fn, rfn in ((specs.train_batch_specs, ref_specs.train_batch_specs),
                    (specs.prefill_inputs, ref_specs.prefill_inputs)):
        got_s, got_p = fn(cfg, shp, mesh)
        want_s, want_p = rfn(rcfg, rshp, ref)
        assert list(got_s) == list(want_s) == list(got_p)
        assert {k: _sds(v) for k, v in want_s.items()} == got_s
        assert {k: _sp(v) for k, v in want_p.items()} == got_p
    lm, rlm = LM(cfg, "meta", tp=16), RefLM(rcfg, ref)
    (cs, cp), (tok, tok_sp), (t, t_sp) = specs.decode_inputs(lm, shp, mesh)
    (rcs, rcp), (rtok, rtok_sp), (rt, rt_sp) = ref_specs.decode_inputs(
        rlm, rshp, ref)
    assert cs == {k: _sds(v) for k, v in rcs.items()}
    assert cp == {k: _sp(v) for k, v in rcp.items()}
    assert (tok, tok_sp, t, t_sp) == (_sds(rtok), _sp(rtok_sp), _sds(rt),
                                      _sp(rt_sp))
