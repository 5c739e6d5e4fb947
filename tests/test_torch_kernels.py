"""The port's SAT kernels on the CPU: the plain torch versions against the
JAX package's Pallas kernels (interpret mode) and oracles, bit for bit,
plus the wrappers' contracts. The CUDA kernels themselves are held against
these plain versions on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                          # container has no hypothesis
    from _propshim import given, settings, strategies as st

import repro_torch
from repro.core import suite as ref_suite
from repro.core.cgra import CGRA as RefCGRA
from repro.core.encode import EncoderSession as RefEncoderSession
from repro.core.sat import walksat_jax
from repro.core.schedule import min_ii as ref_min_ii
from repro.kernels.clause_eval import (true_counts as jx_true_counts,
                                       true_counts_window as jx_window)
from repro.kernels.clause_eval.ref import (true_counts_ref as jx_tc_ref,
                                           true_counts_window_ref as jx_w_ref)
from repro.kernels.flip_update import flip_update as jx_flip
from repro.kernels.flip_update.ref import flip_update_ref as jx_flip_ref
from repro_torch.convert import assign_from_numpy, window_from_numpy
from repro_torch.core.sat.walksat_torch import HostPack, pack_cnf_window_np
from repro_torch.kernels.clause_eval import (true_counts, true_counts_ref,
                                             true_counts_window,
                                             true_counts_window_ref)
from repro_torch.kernels.flip_update import flip_update

repro_torch.set_default_device("cpu")
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _random_window(rng, k, c, l, v, b):
    """Random clause tables with 0-padding anywhere in a row (not only at
    the end, as the packer leaves it) and random assignments."""
    cvars = rng.randint(0, v + 1, (k, c, l)).astype(np.int32)
    csign = rng.rand(k, c, l) > 0.5
    assign = rng.rand(k, b, v + 1) > 0.5
    return cvars, csign, assign


# ------------------------------------------------------------ clause_eval
@settings(max_examples=10, deadline=None)
@given(st.integers(1, 4), st.integers(1, 40), st.integers(1, 6),
       st.integers(1, 40), st.integers(1, 9), st.integers(0, 10_000))
def test_clause_eval_window_plain_matches_jax_property(k, c, l, v, b, seed):
    cvars, csign, assign = _random_window(np.random.RandomState(seed),
                                          k, c, l, v, b)
    got = true_counts_window(_t(cvars), _t(csign), _t(assign)).numpy()
    assert got.dtype == np.int32 and got.shape == (k, b, c)
    want_k = np.asarray(jx_window(jnp.asarray(cvars), jnp.asarray(csign),
                                  jnp.asarray(assign), interpret=True))
    want_r = np.asarray(jx_w_ref(jnp.asarray(cvars), jnp.asarray(csign),
                                 jnp.asarray(assign)))
    np.testing.assert_array_equal(got, want_k)
    np.testing.assert_array_equal(got, want_r)


@pytest.mark.parametrize("c,l,v,b", [
    (17, 3, 33, 4), (333, 7, 97, 11), (1025, 2, 250, 1), (64, 12, 64, 16),
])
def test_clause_eval_single_plain_matches_jax(c, l, v, b):
    rng = np.random.RandomState(c + l)
    cvars = rng.randint(0, v + 1, (c, l)).astype(np.int32)
    csign = rng.rand(c, l) > 0.5
    assign = rng.rand(b, v + 1) > 0.5
    got = true_counts(_t(cvars), _t(csign), _t(assign)).numpy()
    args = (jnp.asarray(cvars), jnp.asarray(csign), jnp.asarray(assign))
    np.testing.assert_array_equal(
        got, np.asarray(jx_true_counts(*args, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jx_tc_ref(*args)))
    np.testing.assert_array_equal(
        got, true_counts_ref(_t(cvars), _t(csign), _t(assign)).numpy())


def test_clause_eval_plain_slices_big_windows(monkeypatch):
    """The plain version goes through the clauses in slices to bound its
    memory; the slicing must not change a count."""
    from repro_torch.kernels.clause_eval import ref
    cvars, csign, assign = _random_window(np.random.RandomState(5),
                                          3, 301, 5, 60, 7)
    whole = true_counts_window_ref(_t(cvars), _t(csign), _t(assign))
    monkeypatch.setattr(ref, "_GATHER_BUDGET", 3 * 7 * 5 * 13)
    sliced = true_counts_window_ref(_t(cvars), _t(csign), _t(assign))
    assert torch.equal(whole, sliced)


def _ref_window(name, size):
    """A real sweep window of the JAX package: its CNFs at II = MII..+2."""
    r, c = int(size[0]), int(size[2])
    g = ref_suite.get(name)
    cgra = RefCGRA(r, c)
    mii = max(ref_min_ii(g, cgra), 1)
    sess = RefEncoderSession(g, cgra)
    return [sess.encode(ii).cnf for ii in range(mii, mii + 3)]


@pytest.mark.parametrize("name", ["sha", "gsm"])
def test_clause_eval_plain_on_real_packed_windows(name):
    """The JAX package's own packed window (tautology rows and trailing
    0-padding included), carried into the port by ``convert``, against
    the interpret-mode kernel."""
    jp = walksat_jax.pack_cnf_window(_ref_window(name, "3x3"))
    packed = window_from_numpy(HostPack(*(np.asarray(x) for x in jp[:4]),
                                        jp.n_vars, jp.n_clauses), "cpu")
    rng = np.random.RandomState(1)
    assign = rng.rand(packed.cvars.shape[0], 3, packed.n_vars + 1) > 0.5
    got = true_counts_window(packed.cvars, packed.csign,
                             assign_from_numpy(assign, packed)).numpy()
    want = np.asarray(jx_window(jp.cvars, jp.csign, jnp.asarray(assign),
                                interpret=True))
    np.testing.assert_array_equal(got, want)
    assert (got[:, :, packed.n_clauses - 1] >= 1).all()   # a tautology row
    with pytest.raises(ValueError):
        assign_from_numpy(assign[:, :, 1:], packed)


# ------------------------------------------------------------ flip_update
def _random_flips(rng, k, b, v, c, o):
    assign = rng.rand(k, b, v + 1) > 0.5
    tc = rng.randint(0, 5, (k, b, c)).astype(np.int32)
    v_flip = rng.randint(0, v + 1, (k, b)).astype(np.int32)
    # repeated clause ids within a row must accumulate
    occ_c = rng.randint(-1, min(c, 4), (k, b, o)).astype(np.int32)
    occ_s = rng.rand(k, b, o) > 0.5
    new_val = rng.rand(k, b) > 0.5
    return assign, tc, v_flip, occ_c, occ_s, new_val


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 3), st.integers(1, 9), st.integers(1, 30),
       st.integers(1, 40), st.integers(1, 12), st.integers(0, 10_000))
def test_flip_update_plain_matches_jax_property(k, b, v, c, o, seed):
    args = _random_flips(np.random.RandomState(seed), k, b, v, c, o)
    a, t = flip_update(*[_t(x) for x in args])
    jargs = [jnp.asarray(x) for x in args]
    for ja, jt in (jx_flip(*jargs, interpret=True), jx_flip_ref(*jargs)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))


def test_flip_update_repeated_ids_accumulate():
    assign = torch.zeros((1, 1, 4), dtype=torch.bool)
    tc = torch.zeros((1, 1, 3), dtype=torch.int32)
    occ_c = torch.tensor([[[2, 2, 0, -1, 2]]], dtype=torch.int32)
    occ_s = torch.tensor([[[True, True, False, True, False]]])
    a, t = flip_update(assign, tc, torch.tensor([[3]], dtype=torch.int32),
                       occ_c, occ_s, torch.tensor([[True]]))
    assert t.tolist() == [[[-1, 0, 1]]]
    assert a.tolist() == [[[False, False, False, True]]]
    assert tc.tolist() == [[[0, 0, 0]]]       # the plain route is pure


def test_flip_update_chain_keeps_counts_exact():
    """50 chained flips on a real window: the carried true counts equal a
    fresh recount after every step, as the walk relies on."""
    pack = pack_cnf_window_np(_ref_window("sha", "3x3"))
    cvars, csign = _t(pack.cvars), _t(pack.csign)
    ovars, osign = _t(pack.ovars), _t(pack.osign)
    K = cvars.shape[0]
    rng = np.random.RandomState(3)
    assign = _t(rng.rand(K, 4, pack.n_vars + 1) > 0.5)
    tc = true_counts_window(cvars, csign, assign)
    kk = torch.arange(K)[:, None]
    for _ in range(50):
        v_flip = _t(rng.randint(0, pack.n_vars + 1, (K, 4)).astype(np.int32))
        new_val = ~torch.gather(assign, 2, v_flip.long()[..., None])[..., 0]
        vfl = v_flip.long()
        assign, tc = flip_update(assign, tc, v_flip, ovars[kk, vfl],
                                 osign[kk, vfl], new_val)
        assert torch.equal(tc, true_counts_window(cvars, csign, assign))


# --------------------------------------------------------------- contracts
def test_wrappers_take_plain_route_on_cpu_without_launching():
    cvars, csign, assign = _random_window(np.random.RandomState(0),
                                          2, 9, 3, 8, 3)
    before = (true_counts_window.launches, true_counts.launches,
              flip_update.launches)
    true_counts_window(_t(cvars), _t(csign), _t(assign))
    true_counts(_t(cvars[0]), _t(csign[0]), _t(assign[0]))
    flip_update(*[_t(x) for x in _random_flips(np.random.RandomState(0),
                                               2, 3, 8, 9, 4)])
    assert (true_counts_window.launches, true_counts.launches,
            flip_update.launches) == before


def test_wrappers_raise_on_what_no_kernel_takes():
    cvars, csign, assign = (_t(x) for x in _random_window(
        np.random.RandomState(0), 2, 9, 3, 8, 3))
    with pytest.raises(TypeError):
        true_counts_window(cvars.long(), csign, assign)
    with pytest.raises(ValueError):
        true_counts_window(cvars, csign[:1], assign)
    # a device with no kernel and no plain route raises, never falls back
    with pytest.raises(ValueError, match="no kernel"):
        true_counts_window(cvars.to("meta"), csign.to("meta"),
                           assign.to("meta"))
    args = [_t(x) for x in _random_flips(np.random.RandomState(0),
                                         2, 3, 8, 9, 4)]
    with pytest.raises(ValueError, match="leading"):
        flip_update(args[0], args[1], args[2][:1], *args[3:])
    with pytest.raises(TypeError):
        flip_update(args[0], args[1], args[2].long(), *args[3:])
    with pytest.raises(ValueError, match="no kernel"):
        flip_update(*[a.to("meta") for a in args])
