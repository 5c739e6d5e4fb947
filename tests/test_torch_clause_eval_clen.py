"""The clause rows' lengths (``clen``) on the CPU: the packer derives them
as one past each row's last non-zero slot, on every suite cell and for the
JAX package's packs carried across by ``convert``; the plain clause
evaluation with ``clen`` equals the evaluation without it and the JAX
package's interpret-mode kernel; the wrappers check ``clen``'s shape,
dtype and device; and the walk hands ``clen`` to every evaluation. The
CUDA kernel's clen route is held bit for bit against the plain version on
the card by ``chip_smoke.py``."""
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
from repro.kernels.clause_eval import (true_counts as jx_true_counts,
                                       true_counts_window as jx_window)
from repro_torch.convert import window_from_numpy
from repro_torch.core import suite
from repro_torch.core.cgra import CGRA
from repro_torch.core.encode import EncoderSession
from repro_torch.core.sat import walksat_torch
from repro_torch.core.sat.walksat_torch import (HostPack, pack_cnf_np,
                                                pack_cnf_window,
                                                pack_cnf_window_np,
                                                row_lengths,
                                                solve_walksat_window)
from repro_torch.core.schedule import min_ii
from repro_torch.kernels.clause_eval import (true_counts, true_counts_ref,
                                             true_counts_window,
                                             true_counts_window_ref)

repro_torch.set_default_device("cpu")
torch.set_num_threads(1)

CELLS = [(size, name) for size in ("2x2", "3x3", "4x4")
         for name in suite.names()]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _one_past_last(cvars):
    """One past the last non-zero slot of each row, by the slot numbers
    (a second derivation, independent of ``row_lengths``)."""
    cvars = np.asarray(cvars)
    slot = np.arange(1, cvars.shape[-1] + 1)
    return np.where(cvars != 0, slot, 0).max(-1).astype(np.int32)


def _cell_cnfs(size, name):
    r, c = int(size[0]), int(size[2])
    g = suite.get(name)
    cgra = CGRA(r, c)
    mii = max(min_ii(g, cgra), 1)
    sess = EncoderSession(g, cgra)
    return [sess.encode(ii).cnf for ii in (mii, mii + 1)]


def _ref_cell_cnfs(size, name):
    r, c = int(size[0]), int(size[2])
    g = ref_suite.get(name)
    from repro.core.schedule import min_ii as ref_min_ii
    cgra = RefCGRA(r, c)
    mii = max(ref_min_ii(g, cgra), 1)
    sess = RefEncoderSession(g, cgra)
    return [sess.encode(ii).cnf for ii in (mii, mii + 1)]


# ------------------------------------------------------------ derivation
def test_row_lengths_of_hand_made_rows():
    cvars = np.array([[3, 1, 0, 0], [0, 0, 0, 0], [2, 0, 5, 0],
                      [1, 2, 3, 4], [0, 0, 0, 7]], np.int32)
    assert row_lengths(cvars).tolist() == [2, 0, 3, 4, 4]
    assert row_lengths(cvars).dtype == np.int32
    assert row_lengths(cvars[None]).shape == (1, 5)


@pytest.mark.parametrize("size,name", CELLS)
def test_clen_is_one_past_the_last_literal_on_every_cell(size, name):
    cnfs = _cell_cnfs(size, name)
    for cnf in cnfs:
        p = pack_cnf_np(cnf)
        assert p.clen.dtype == np.int32 and p.clen.shape == (cnf.n_clauses,)
        np.testing.assert_array_equal(p.clen, _one_past_last(p.cvars))
        np.testing.assert_array_equal(
            p.clen, np.diff(cnf.arena.offs_view()).astype(np.int32))
    win = pack_cnf_window_np(cnfs)
    K, C, _ = win.cvars.shape
    assert win.clen.dtype == np.int32 and win.clen.shape == (K, C)
    np.testing.assert_array_equal(win.clen, _one_past_last(win.cvars))
    # the tautology rows (v1 or not v1) that pad short CNFs have length 2
    for k, cnf in enumerate(cnfs):
        assert (win.clen[k, cnf.n_clauses:] == 2).all()
    # a window pack of the JAX package, carried across, gets the same clen
    ref = walksat_jax.pack_cnf_window(_ref_cell_cnfs(size, name))
    packed = window_from_numpy(ref, "cpu")
    assert packed.clen.dtype == torch.int32
    np.testing.assert_array_equal(packed.clen.numpy(),
                                  _one_past_last(np.asarray(ref.cvars)))
    np.testing.assert_array_equal(packed.clen.numpy(), win.clen)


@pytest.mark.parametrize("name", ["sha", "gsm", "nw"])
def test_window_clen_same_with_and_without_cached_packs(name):
    cnfs = _cell_cnfs("3x3", name)
    cold = pack_cnf_window_np(cnfs)
    warm = pack_cnf_window_np(cnfs, [pack_cnf_np(c) for c in cnfs])
    # cached packs without clen (positional, six fields) and a mixed list
    bare = [HostPack(*pack_cnf_np(c)[:6]) for c in cnfs]
    assert all(p.clen is None for p in bare)
    no_clen = pack_cnf_window_np(cnfs, bare)
    mixed = pack_cnf_window_np(cnfs, [None] + bare[1:])
    for other in (warm, no_clen, mixed):
        np.testing.assert_array_equal(other.clen, cold.clen)
        np.testing.assert_array_equal(other.cvars, cold.cvars)
    torch_pack = pack_cnf_window(cnfs, device="cpu")
    np.testing.assert_array_equal(torch_pack.clen.numpy(), cold.clen)


# ---------------------------------------------------- plain evaluation
@pytest.mark.parametrize("name", ["sha", "gsm"])
def test_plain_counts_with_clen_equal_jax_on_real_windows(name):
    ref = walksat_jax.pack_cnf_window(_ref_cell_cnfs("3x3", name))
    packed = window_from_numpy(ref, "cpu")
    rng = np.random.RandomState(2)
    assign = rng.rand(packed.cvars.shape[0], 5, packed.n_vars + 1) > 0.5
    a = _t(assign)
    with_clen = true_counts_window(packed.cvars, packed.csign, a,
                                   packed.clen)
    without = true_counts_window(packed.cvars, packed.csign, a)
    assert torch.equal(with_clen, without)
    want = np.asarray(jx_window(ref.cvars, ref.csign, jnp.asarray(assign),
                                interpret=True))
    np.testing.assert_array_equal(with_clen.numpy(), want)
    # the K = 1 entry on the window's first formula
    one = true_counts(packed.cvars[0], packed.csign[0], a[0],
                      packed.clen[0])
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(jx_true_counts(
            ref.cvars[0], ref.csign[0], jnp.asarray(assign[0]),
            interpret=True)))


def _table_past_clen(rng, k, c, l, v, b, inner_zeros):
    """Random tables whose zeros all lie at or past a random clen (some
    clen past L, as the kernel clamps), with zeros inside too if asked."""
    clen = rng.randint(0, l + 3, (k, c)).astype(np.int32)
    cvars = rng.randint(1, v + 1, (k, c, l)).astype(np.int32)
    if inner_zeros:
        cvars[rng.rand(k, c, l) < 0.2] = 0
    cvars[np.arange(l)[None, None, :] >= clen[..., None]] = 0
    csign = rng.rand(k, c, l) > 0.5
    assign = rng.rand(k, b, v + 1) > 0.5
    return cvars, csign, assign, clen


@settings(max_examples=12, deadline=None)
@given(st.integers(1, 4), st.integers(1, 40), st.integers(1, 12),
       st.integers(1, 40), st.integers(1, 40), st.booleans(),
       st.integers(0, 10_000))
def test_plain_counts_with_clen_property(k, c, l, v, b, inner_zeros, seed):
    cvars, csign, assign, clen = _table_past_clen(
        np.random.RandomState(seed), k, c, l, v, b, inner_zeros)
    args = (_t(cvars), _t(csign), _t(assign))
    got = true_counts_window(*args, _t(clen))
    assert got.dtype == torch.int32 and got.shape == (k, b, c)
    assert torch.equal(got, true_counts_window(*args))
    assert torch.equal(got, true_counts_window_ref(*args, _t(clen)))
    want = np.asarray(jx_window(jnp.asarray(cvars), jnp.asarray(csign),
                                jnp.asarray(assign), interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    one = true_counts(args[0][0], args[1][0], args[2][0], _t(clen[0]))
    assert torch.equal(one, true_counts_ref(args[0][0], args[1][0],
                                            args[2][0]))


def test_tautology_and_repeated_variables_count_each_literal():
    # rows: the padding tautology, a repeated positive literal, a repeated
    # variable of both signs, and a row whose literals are all false
    cvars = _t(np.array([[[1, 1, 0], [2, 2, 0], [3, 3, 3], [2, 0, 0]]],
                        np.int32))
    csign = _t(np.array([[[True, False, False], [True, True, False],
                          [True, False, True], [False, False, False]]]))
    clen = _t(np.array([[2, 2, 3, 1]], np.int32))
    assign = _t(np.array([[[False, True, True, False],
                           [False, False, False, True]]]))
    got = true_counts_window(cvars, csign, assign, clen)
    assert got.tolist() == [[[1, 2, 1, 0], [1, 0, 2, 1]]]


# ------------------------------------------------------------ contracts
def _small():
    rng = np.random.RandomState(0)
    cvars, csign, assign, clen = _table_past_clen(rng, 2, 9, 3, 8, 3, False)
    return _t(cvars), _t(csign), _t(assign), _t(clen)


@pytest.mark.parametrize("bad,err", [
    (lambda cl: cl[..., :-1], ValueError),               # shape
    (lambda cl: cl[None], ValueError),                   # rank
    (lambda cl: cl.long(), TypeError),                   # dtype
    (lambda cl: cl.float(), TypeError),
    (lambda cl: cl.to("meta"), ValueError),              # device
])
def test_bad_clen_raises_without_launching(bad, err):
    cvars, csign, assign, clen = _small()
    before = (true_counts_window.launches, true_counts.launches)
    with pytest.raises(err, match="clen"):
        true_counts_window(cvars, csign, assign, bad(clen))
    with pytest.raises(err, match="clen"):
        true_counts(cvars[0], csign[0], assign[0], bad(clen[0]))
    true_counts_window(cvars, csign, assign, clen)
    true_counts(cvars[0], csign[0], assign[0], clen[0])
    assert (true_counts_window.launches, true_counts.launches) == before


def test_route_counts_reset_and_cpu_counts_none():
    from repro_torch.kernels.clause_eval import ROUTES, reset_counts
    true_counts_window.launches = 3
    true_counts.route_launches["clen"] = 2
    reset_counts()
    for f in (true_counts_window, true_counts):
        assert f.launches == 0 and f.route_launches == dict.fromkeys(ROUTES,
                                                                     0)
    cvars, csign, assign, clen = _small()
    for cl in (clen, None):
        true_counts_window(cvars, csign, assign, cl)
    assert true_counts_window.route_launches == dict.fromkeys(ROUTES, 0)


def test_clen_on_a_device_with_no_kernel_raises():
    cvars, csign, assign, clen = (x.to("meta") for x in _small())
    with pytest.raises(ValueError, match="no kernel"):
        true_counts_window(cvars, csign, assign, clen)


# ------------------------------------------------------------- the walk
@pytest.mark.parametrize("engine", ["host", "device"])
def test_walk_hands_clen_to_every_evaluation(engine, monkeypatch):
    """Both engines evaluate the window with its row lengths: the device
    engine once per walk, the host engine once per chunk."""
    seen = []
    real = walksat_torch.true_counts_window

    def spy(cvars, csign, assign, clen=None):
        seen.append(clen)
        return real(cvars, csign, assign, clen)
    monkeypatch.setattr(walksat_torch, "true_counts_window", spy)
    cnfs = _cell_cnfs("2x2", "srand")
    want = pack_cnf_window_np(cnfs).clen
    solve_walksat_window(cnfs, seed=1, steps=600, batch=4, engine=engine)
    assert seen and all(c is not None for c in seen)
    for c in seen:
        np.testing.assert_array_equal(c.numpy(), want)
