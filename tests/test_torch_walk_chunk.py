"""The walk chunk (``repro_torch.kernels.flip_update.walk_chunk``) on the
CPU: its Philox against the generator's known answers, its plain version
against turns of the JAX package's probSAT step fed the same noise as
numpy arrays, chunks that compose, solved chains, repeated clause ids, the
wrapper's contract and route, and the walk engines' one call per chunk.
The CUDA kernel itself is held bit for bit against ``walk_chunk_ref`` on
the card by ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import suite as ref_suite
from repro.core.cgra import CGRA as RefCGRA
from repro.core.encode import EncoderSession as RefEncoderSession
from repro.core.sat import walksat_jax
from repro.core.schedule import min_ii as ref_min_ii
from repro_torch.core import suite
from repro_torch.core.cgra import CGRA
from repro_torch.core.encode import EncoderSession
from repro_torch.core.sat import SAT, solve
from repro_torch.core.sat import walksat_torch as W
from repro_torch.core.schedule import min_ii
from repro_torch.convert import window_from_numpy
from repro_torch.kernels.clause_eval import true_counts_window_ref
from repro_torch.kernels.flip_update import (reset_counts, walk_chunk,
                                             walk_chunk_ref, walk_route)
from repro_torch.kernels.flip_update.ref import (philox4x32_10, walk_noise)

repro_torch.set_default_device("cpu")
torch.set_num_threads(1)

CB = 2.3
KEY = (0x1234ABCD, 0x9E3779B9)
# Random123's philox4x32_10 known answers: (counter, key) -> output
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def philox_np(ctr, key):
    """Philox4x32-10 in numpy uint64, written out apart from the port's."""
    c = [np.asarray(x, np.uint64) for x in ctr]
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    m = np.uint64(0xFFFFFFFF)
    for r in range(10):
        if r:
            k0 = (k0 + np.uint64(0x9E3779B9)) & m
            k1 = (k1 + np.uint64(0xBB67AE85)) & m
        p0 = c[0] * np.uint64(0xD2511F53)
        p1 = c[2] * np.uint64(0xCD9E8D57)
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & m,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & m]
    return c


def words_np(key, step, chain, i, stream):
    """word(step, chain, i, stream) of the walk, numpy int64."""
    i = np.asarray(i, np.int64)
    out = philox_np((i >> 2, chain, np.full_like(i, step), np.full_like(
        i, stream)), key)
    return np.choose(i & 3, [np.asarray(o, np.int64) for o in out])


def _port_window(size="3x3", name="sha", width=3):
    """The port's CNFs of ``name`` at IIs MII .. MII + width - 1 on a
    ``size`` fabric, and their window pack on the CPU."""
    dfg = suite.get(name)
    cgra = CGRA(int(size[0]), int(size[2]))
    mii = max(min_ii(dfg, cgra), 1)
    sess = EncoderSession(dfg, cgra)
    cnfs = [sess.encode(ii).cnf for ii in range(mii, mii + width)]
    return cnfs, window_from_numpy(W.pack_cnf_window_np(cnfs), "cpu")


def _a_model(cnfs):
    """(index, model) of the first CNF of ``cnfs`` that CDCL satisfies."""
    for k, cnf in enumerate(cnfs):
        status, model = solve(cnf, "cdcl")
        if status == SAT:
            return k, model
    raise AssertionError("no satisfiable CNF in the window")


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ Philox
@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    got = philox4x32_10(tuple(torch.tensor([c], dtype=torch.int64)
                              for c in ctr), key)
    assert tuple(int(w) for w in got) == want
    assert tuple(int(w) for w in philox_np(ctr, key)) == want


def test_philox_matches_numpy_over_many_counters():
    """The int64 products wrap; the high words must not care."""
    rng = np.random.RandomState(0)
    ctr = [rng.randint(0, 2 ** 32, 4096, dtype=np.uint64) for _ in range(4)]
    got = philox4x32_10(tuple(torch.from_numpy(c.astype(np.int64))
                              for c in ctr), KEY)
    for g, w in zip(got, philox_np(ctr, KEY)):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


def test_walk_noise_is_the_philox_words():
    rng = np.random.RandomState(1)
    K, B, C, L = 2, 3, 50, 9
    tc = _t((rng.rand(K, B, C) < 0.3) * rng.randint(1, 3, (K, B, C))
            ).to(torch.int32)
    g_clause, g_var = walk_noise(KEY, 77, tc, L)
    for k in range(K):
        for b in range(B):
            r = k * B + b
            unsat = np.nonzero(tc[k, b].numpy() == 0)[0]
            want = words_np(KEY, 77, r, unsat, 0) >> 8
            np.testing.assert_array_equal(g_clause[k, b, unsat].numpy(),
                                          want.astype(np.float32))
            u = (words_np(KEY, 77, r, np.arange(L), 1) >> 8).astype(
                np.float32) * np.float32(2.0 ** -24)
            u = torch.from_numpy(np.maximum(u, np.finfo(np.float32).tiny))
            np.testing.assert_array_equal(g_var[k, b].numpy(),
                                          (-torch.log(-torch.log(u))).numpy())


# ------------------------------------------------ the step against JAX's
def test_walk_chunk_ref_matches_jax_steps_given_the_same_noise(monkeypatch):
    """n steps of walk_chunk_ref on a real packed window equal n turns of
    the JAX package's ``_pick_flip_one`` + ``_apply_flip_one`` per CNF,
    whose two ``jax.random.categorical`` draws take the walk's noise
    (numpy words for the clauses, the Gumbel values for the literals)
    instead of their keys' own. Chain 0 of one CNF starts from a model, so
    solved chains are in it too."""
    cnfs, _ = _port_window()
    dfg, cgra = ref_suite.get("sha"), RefCGRA(3, 3)
    sess = RefEncoderSession(dfg, cgra)
    mii = max(ref_min_ii(dfg, cgra), 1)
    p = walksat_jax.pack_cnf_window([sess.encode(mii + i).cnf
                                     for i in range(3)])
    K, C, L = p.cvars.shape
    B, n = 6, 25
    rng = np.random.RandomState(0)
    assign = rng.rand(K, B, p.n_vars + 1) > 0.5
    solved_k, model = _a_model(cnfs)
    assign[solved_k, 0, 1:] = False
    assign[solved_k, 0, 1:len(model) + 1] = model
    tc = np.asarray(walksat_jax._window_tc(p.cvars, p.csign,
                                           jnp.asarray(assign), None))
    assert not (tc[solved_k, 0] == 0).any()
    step0 = 1000
    want_a, want_t = walk_chunk_ref(_t(p.cvars), _t(p.ovars), _t(p.osign),
                                    _t(assign), _t(tc), KEY, step0, n, CB)

    queue = []

    def categorical(key, logits, axis=-1):
        return jnp.argmax(logits + queue.pop(0), axis=axis)
    monkeypatch.setattr(jax.random, "categorical", categorical)
    a, t = jnp.asarray(assign), jnp.asarray(tc)
    flips = 0
    for s in range(step0, step0 + n):
        _, g_var = walk_noise(KEY, s, torch.from_numpy(np.array(t)), L)
        g_var = g_var.numpy()
        a_k, t_k = [], []
        for k in range(K):
            chains = k * B + np.arange(B)[:, None]
            g_clause = (words_np(KEY, s, chains, np.arange(C)[None], 0)
                        >> 8).astype(np.float32)
            queue[:] = [jnp.asarray(g_clause), jnp.asarray(g_var[k])]
            v, nv, _ = walksat_jax._pick_flip_one(
                p.cvars[k], p.ovars[k], p.osign[k], a[k], t[k],
                jax.random.PRNGKey(0), CB)
            assert not queue
            if k == solved_k:
                assert int(v[0]) == 0
            flips += int((v != 0).sum())
            ak, tk = walksat_jax._apply_flip_one(p.ovars[k], p.osign[k],
                                                 a[k], t[k], v, nv)
            a_k.append(ak)
            t_k.append(tk)
        a, t = jnp.stack(a_k), jnp.stack(t_k)
    assert flips > n * K * (B - 1) // 2
    np.testing.assert_array_equal(want_a.numpy(), np.asarray(a))
    np.testing.assert_array_equal(want_t.numpy(), np.asarray(t))


# ------------------------------------------------------------- the chunk
@pytest.mark.parametrize("n1,n2", [(1, 9), (5, 5), (8, 2)])
def test_two_chunks_equal_one(n1, n2):
    """The noise names the global step, so where a chunk ends changes
    nothing: one chunk of n1 + n2 steps equals n1 then n2."""
    _, pk = _port_window()
    gen = torch.Generator().manual_seed(n1)
    assign = torch.rand((pk.cvars.shape[0], 5, pk.n_vars + 1),
                        generator=gen) < 0.5
    tc = true_counts_window_ref(pk.cvars, pk.csign, assign)
    args = (pk.cvars, pk.ovars, pk.osign)
    one = walk_chunk_ref(*args, assign, tc, KEY, 40, n1 + n2, CB)
    a, t = walk_chunk_ref(*args, assign, tc, KEY, 40, n1, CB)
    two = walk_chunk_ref(*args, a, t, KEY, 40 + n1, n2, CB)
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    assert torch.equal(one[1], true_counts_window_ref(pk.cvars, pk.csign,
                                                      one[0]))
    other = walk_chunk_ref(*args, assign, tc, KEY, 41, n1 + n2, CB)
    assert not torch.equal(one[0], other[0])     # the step index matters


@pytest.mark.parametrize("n", [1, 4, 7])
def test_solved_chain_toggles_only_the_dummy(n):
    cnfs, _ = _port_window()
    k, model = _a_model(cnfs)
    pk = window_from_numpy(W.pack_cnf_window_np(cnfs[k:k + 1]), "cpu")
    assign = torch.zeros((1, 2, pk.n_vars + 1), dtype=torch.bool)
    assign[0, :, 1:len(model) + 1] = torch.tensor(model)
    assign[0, 1, 0] = True
    tc = true_counts_window_ref(pk.cvars, pk.csign, assign)
    assert not (tc == 0).any()
    a, t = walk_chunk_ref(pk.cvars, pk.ovars, pk.osign, assign, tc, KEY, 3,
                          n, CB)
    assert torch.equal(t, tc)
    want = assign.clone()
    want[0, :, 0] ^= bool(n % 2)
    assert torch.equal(a, want)


def _one_clause_window():
    """Three variables; clause 0 = (v1) is the only unsat clause, and v1's
    occurrence row names clause 1 twice and clause 2 once."""
    cvars = torch.tensor([[[1, 0], [1, 2], [1, 3]]], dtype=torch.int32)
    ovars = torch.tensor([[[-1, -1, -1, -1], [0, 1, 1, 2],
                           [1, -1, -1, -1], [2, -1, -1, -1]]],
                         dtype=torch.int32)
    osign = torch.tensor([[[0, 0, 0, 0], [1, 1, 1, 0], [1, 0, 0, 0],
                           [1, 0, 0, 0]]], dtype=torch.bool)
    assign = torch.tensor([[[0, 0, 1, 0]]], dtype=torch.bool)
    tc = torch.tensor([[[0, 1, 1]]], dtype=torch.int32)
    return cvars, ovars, osign, assign, tc


def test_repeated_clause_ids_accumulate():
    cvars, ovars, osign, assign, tc = _one_clause_window()
    a, t = walk_chunk(cvars, ovars, osign, assign, tc, KEY, 0, 1, CB)
    # v1 -> True: clause 0 +1, clause 1 +1 twice, clause 2 (~v1) -1
    assert a.tolist() == [[[False, True, True, False]]]
    assert t.tolist() == [[[1, 3, 0]]]


# ------------------------------------------------------------ the wrapper
def _bad_args():
    cvars, ovars, osign, assign, tc = _one_clause_window()
    good = dict(cvars=cvars, ovars=ovars, osign=osign, assign=assign, tc=tc,
                key=KEY, step0=0, n_steps=1, cb=CB)
    return good, [
        (TypeError, dict(cvars=cvars.long())),
        (TypeError, dict(osign=osign.to(torch.uint8))),
        (TypeError, dict(tc=tc.float())),
        (ValueError, dict(tc=tc[..., :2])),
        (ValueError, dict(assign=assign[..., :3])),
        (ValueError, dict(osign=osign[:, :3])),
        (ValueError, dict(cvars=cvars[0])),
        (ValueError, dict(key=(1 << 32, 0))),
        (ValueError, dict(key=(1,))),
        (ValueError, dict(step0=-1)),
        (ValueError, dict(n_steps=-2)),
        (ValueError, {n: t.to("meta") for n, t in (
            ("cvars", cvars), ("ovars", ovars), ("osign", osign),
            ("assign", assign), ("tc", tc))}),
    ]


@pytest.mark.parametrize("case", range(len(_bad_args()[1])))
def test_wrapper_rejects_bad_inputs(case):
    good, bad = _bad_args()
    exc, change = bad[case]
    with pytest.raises(exc):
        walk_chunk(**{**good, **change})


def test_wrapper_takes_the_plain_route_on_cpu_and_counts_nothing():
    reset_counts()
    _, pk = _port_window()
    assign = torch.rand((pk.cvars.shape[0], 4, pk.n_vars + 1),
                        generator=torch.Generator().manual_seed(2)) < 0.5
    tc = true_counts_window_ref(pk.cvars, pk.csign, assign)
    args = (pk.cvars, pk.ovars, pk.osign, assign, tc, KEY, 5, 6, CB)
    got = walk_chunk(*args)
    want = walk_chunk_ref(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert walk_chunk.launches == 0 and walk_chunk.steps == 0
    assert walk_chunk.route_launches == {"shared": 0, "global": 0}


@pytest.mark.parametrize("C,L,V1,route", [
    (11264, 128, 385, "shared"),      # the sha 4x4 window
    (160768, 512, 7425, "global"),    # the sha 8x8 window
    (57344, 8, 1000, "shared"),       # 4C just fits beside the slots
    (57856, 8, 1000, "global"),
])
def test_route_is_picked_by_shape(C, L, V1, route):
    assert walk_route(C, L, V1) == route


def test_route_refuses_slots_beyond_shared_memory():
    with pytest.raises(ValueError):
        walk_route(1024, 40000, 100)


# ------------------------------------------------------------ the engines
@pytest.mark.parametrize("engine", ["host", "device"])
def test_engines_call_walk_chunk_once_per_chunk(engine, monkeypatch):
    """Each planned chunk is one walk_chunk call, starting at the global
    step where the chunk before it ended; both engines plan alike."""
    cnfs, _ = _port_window("2x2", "srand", 2)
    calls = []

    def spy(cvars, ovars, osign, assign, tc, key, step0, n_steps, cb):
        calls.append((key, step0, n_steps))
        return walk_chunk(cvars, ovars, osign, assign, tc, key, step0,
                          n_steps, cb)
    monkeypatch.setattr(W, "walk_chunk", spy)
    W.solve_walksat_window(cnfs, seed=9, steps=700, batch=2,
                           engine=engine, should_skip=lambda i: False,
                           stop=lambda: False, on_sat=None)
    assert calls and all(key == W.walk_key(9) for key, _, _ in calls)
    ends = 0
    for _, step0, n in calls:
        assert step0 == ends
        ends += n
    cap, first = W._chunk_plan(700, W.pack_cnf_window_np(cnfs).n_clauses)
    assert calls[0][2] == first


def test_walk_key_takes_every_seed_bit():
    keys = {W.walk_key(s) for s in (0, 1, 1 << 31, 1 << 32, 1 << 63, -1)}
    assert len(keys) == 6
    assert all(0 <= k < 2 ** 32 for key in keys for k in key)
