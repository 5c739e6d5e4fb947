"""The port's torch.fx -> DFG frontend (``repro_torch.core.frontend``):
``map_cgra``'s four torch loop bodies give DFGs whose ``dfg_signature`` and
carry maps equal those of the JAX package's ``trace_loop_body`` on its JAX
bodies, and ``DFG.execute`` of each agrees with the torch function over 8
iterations; the JAX package's frontend tests, on torch bodies."""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:   # optional dep: fall back to the local shim
    from _propshim import given, settings, strategies as st

from repro.configs import get_config as ref_get_config
from repro.core.frontend import trace_loop_body as ref_trace
from repro.core.service import dfg_signature as ref_dfg_sig
from repro.launch import map_cgra as ref_map_cgra
import repro_torch
from repro_torch.configs import get_config
from repro_torch.core.cgra import CGRA
from repro_torch.core.frontend import trace_loop_body
from repro_torch.core.mapper import MapperConfig, map_loop
from repro_torch.core.service import dfg_signature
from repro_torch.launch import map_cgra

repro_torch.set_default_device("cpu")

# every loop of map_cgra.loops_for: (name, torch body, JAX body, carries,
# loads)
LOOPS = {name: (fn, getattr(ref_map_cgra, fn.__name__), n_carry, loads)
         for arch in ("deepseek_moe_16b", "hymba_1_5b")
         for name, fn, n_carry, loads in map_cgra.loops_for(
             get_config(arch))}


def test_loops_for_matches_the_reference():
    for arch in ("hymba_1_5b", "deepseek_moe_16b", "mamba2_370m", "yi_34b"):
        mine = [(n, c, ld) for n, _, c, ld in
                map_cgra.loops_for(get_config(arch))]
        ref = [(n, c, ld) for n, _, c, ld in
               ref_map_cgra.loops_for(ref_get_config(arch))]
        assert mine == ref, arch
    assert sorted(LOOPS) == ["rmsnorm_acc", "rope_rotation",
                             "router_argmax", "ssd_recurrence"]


@pytest.mark.parametrize("name", sorted(LOOPS))
def test_loop_dfg_signature_equals_the_jaxpr_frontend(name):
    fn, ref_fn, n_carry, loads = LOOPS[name]
    g, cm = trace_loop_body(fn, n_carry=n_carry, loads=loads, name=name)
    rg, rcm = ref_trace(ref_fn, n_carry=n_carry, loads=loads, name=name)
    assert dfg_signature(g) == ref_dfg_sig(rg)
    assert cm == rcm
    assert [n.name for n in g.nodes.values()] == \
        [n.name for n in rg.nodes.values()]


def _run(name, n_iters=8):
    """The loop's DFG (this package's and the reference's) executed for
    ``n_iters`` iterations, and the torch body run alike in int64, from
    seeded initial carries and loaded values (rope_rotation's pair starts
    at angle 0). Returns (DFG histories, reference DFG histories, torch
    carries after each iteration, carry map, the first iteration whose
    torch run shifts a negative value)."""
    fn, ref_fn, n_carry, loads = LOOPS[name]
    g, cm = trace_loop_body(fn, n_carry=n_carry, loads=loads, name=name)
    rg, _ = ref_trace(ref_fn, n_carry=n_carry, loads=loads, name=name)
    rng = np.random.default_rng(0)
    init = [240, 0] if name == "rope_rotation" else \
        [int(v) for v in rng.integers(50, 200, n_carry)]
    loaded = rng.integers(0, 100, (loads, n_iters))
    mem = {100 * (li + 1) + i: int(loaded[li, i])
           for li in range(loads) for i in range(n_iters)}
    seed = {cm[ci]: init[ci] for ci in range(n_carry)}
    hist, _ = g.execute(n_iters, mem=mem, init=seed)
    ref_hist, _ = rg.execute(n_iters, mem=mem, init=seed)
    shifted = []

    def rshift(a, b):
        shifted.append(int(a))
        return torch.bitwise_right_shift(a, b)

    carries = [torch.tensor(v, dtype=torch.int64) for v in init]
    seen, first_negative = [], n_iters
    for i in range(n_iters):
        shifted.clear()
        with mock.patch.object(torch.Tensor, "__rshift__", rshift):
            out = fn(torch.tensor(i, dtype=torch.int64), *carries,
                     *[torch.tensor(int(loaded[li, i]), dtype=torch.int64)
                       for li in range(loads)])
        if min(shifted, default=0) < 0:
            first_negative = min(first_negative, i)
        carries = list(out[:n_carry])
        seen.append([int(c) for c in carries])
    return hist, ref_hist, seen, cm, first_negative


@pytest.mark.parametrize("name", sorted(LOOPS))
def test_loop_dfg_executes_the_torch_body(name):
    """8 iterations of the DFG against the torch body, every carry every
    iteration. The DFG's ``shr`` is the JAX package's: a logical shift of
    the 64-bit value, where ``>>`` of a torch (or jnp) integer is
    arithmetic, so the two agree while no negative value is shifted. Three
    of the loops never shift one; rope_rotation turns its pair by ~28
    degrees an iteration and, from angle 0, shifts a negative value in its
    fourth: its first three iterations are held to the torch body, and all
    8 to the JAX package's DFG of its JAX body (the same semantics)."""
    hist, ref_hist, seen, cm, first_negative = _run(name)
    assert first_negative == (3 if name == "rope_rotation" else 8)
    for i in range(first_negative):
        assert [hist[i][cm[ci]] for ci in range(len(cm))] == seen[i], i
    assert hist == ref_hist


def test_trace_simple_body_semantics():
    def body(i, acc):
        x = i * 3 + acc
        y = x ^ (x >> 2)
        return (y & 0x7FFF,)

    g, cm = trace_loop_body(body, n_carry=1)
    hist, _ = g.execute(6)
    acc = 0
    for i in range(6):
        x = i * 3 + acc
        acc = (x ^ (x >> 2)) & 0x7FFF
        assert hist[i][cm[0]] == acc


def test_trace_select_and_compare():
    def body(i, acc):
        c = i > 3
        v = torch.where(c, acc + 1, acc - 1)
        return (v,)

    def ref_body(i, acc):
        c = i > 3
        return (jnp.where(c, acc + 1, acc - 1),)

    g, cm = trace_loop_body(body, n_carry=1)
    assert dfg_signature(g) == ref_dfg_sig(ref_trace(ref_body, n_carry=1)[0])
    hist, _ = g.execute(8)
    acc = 0
    for i in range(8):
        acc = acc + 1 if i > 3 else acc - 1
        assert hist[i][cm[0]] == acc


def test_trace_with_loads_and_store():
    def body(i, a):   # a is a per-iteration loaded value
        return a * 2 + i,   # single non-carry output -> store

    g, _ = trace_loop_body(body, n_carry=0, loads=1)
    ops = [n.op for n in g.nodes.values()]
    assert "load" in ops and "store" in ops
    mem = {100 + i: i + 5 for i in range(4)}   # load base is 100
    _, out_mem = g.execute(4, mem=mem)
    for i in range(4):
        assert out_mem[1000 + i] == (i + 5) * 2 + i


def test_pow_neg_not_and_pass_through_carry_match_the_jaxpr():
    def body(i, acc, keep):
        return (-(acc ** 3) + ~i, keep)

    def ref_body(i, acc, keep):
        return (-(acc ** 3) + ~i, keep)

    g, cm = trace_loop_body(body, n_carry=2)
    rg, rcm = ref_trace(ref_body, n_carry=2)
    assert dfg_signature(g) == ref_dfg_sig(rg) and cm == rcm
    assert g.nodes[cm[1]].op == "route"


def test_method_calls_and_torch_functions_trace_as_operators():
    def ops_body(i, acc):
        return (((acc + i) & 0xFF) > (i ^ 3),)

    def method_body(i, acc):
        return (acc.add(i).bitwise_and(0xFF).gt(torch.bitwise_xor(i, 3)),)

    g1, _ = trace_loop_body(ops_body, n_carry=1)
    g2, _ = trace_loop_body(method_body, n_carry=1)
    assert dfg_signature(g1) == dfg_signature(g2)
    assert dfg_signature(g1) == ref_dfg_sig(ref_trace(ops_body,
                                                      n_carry=1)[0])


def test_traced_body_maps_to_cgra():
    def body(i, acc):
        return ((acc + i) & 0xFF,)

    g, _ = trace_loop_body(body, n_carry=1)
    r = map_loop(g, CGRA(2, 2), MapperConfig(solver="auto", timeout_s=30))
    assert r.success


def test_unsupported_operation_raises():
    def body(i, acc):
        return (torch.sin(acc.float()).int(),)

    with pytest.raises(NotImplementedError):
        trace_loop_body(body, n_carry=1)


def test_wrong_arity_raises():
    with pytest.raises(ValueError, match="arguments"):
        trace_loop_body(lambda i, acc: (acc,), n_carry=2)


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 7), st.integers(0, 63), st.integers(1, 5))
def test_property_trace_matches_python_and_the_jaxpr(mul, mask, sh):
    def body(i, acc):
        x = i * mul + acc
        return ((x >> sh) & mask,)

    g, cm = trace_loop_body(body, n_carry=1)
    assert dfg_signature(g) == ref_dfg_sig(ref_trace(body, n_carry=1)[0])
    hist, _ = g.execute(5)
    acc = 0
    for i in range(5):
        acc = ((i * mul + acc) >> sh) & mask
        assert hist[i][cm[0]] == acc
