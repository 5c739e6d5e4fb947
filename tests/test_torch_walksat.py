"""The port's probSAT walk (``repro_torch.core.sat.walksat_torch``) on the
CPU: packs byte-identical to the JAX package's, a step that picks what the
JAX step picks given the same Gumbel noise, the device engine equal to the
host engine, and the ported cases of the JAX package's device-sweep tests
(warm starts, near misses, chunk plan, the non-model guard). The last test
runs the port's structured errors under ``python -O``."""
import os
import subprocess
import sys

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
from repro_torch.core import suite
from repro_torch.core.cgra import CGRA
from repro_torch.core.cnf import CNF
from repro_torch.core.encode import EncoderSession
from repro_torch.core.sat import SAT, UNKNOWN
from repro_torch.core.sat.walksat_torch import (
    NonModelError, _chunk_plan, _next_chunk, _pick_flip, _validate_model,
    occ_tables, pack_cnf_np, pack_cnf_window, solve_walksat,
    solve_walksat_window)
from repro_torch.core.schedule import min_ii

repro_torch.set_default_device("cpu")
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = ["2x2", "3x3", "4x4"]


def _window_cnfs(name: str, cgra: CGRA, width: int = 3):
    g = suite.get(name)
    mii = max(min_ii(g, cgra), 1)
    sess = EncoderSession(g, cgra)
    iis = list(range(mii, mii + width))
    return iis, [sess.encode(ii).cnf for ii in iis]


def _tiny_cnf(n_vars: int = 6, seed: int = 0) -> CNF:
    """A small random satisfiable 3-CNF for unit-level checks."""
    rng = np.random.RandomState(seed)
    cnf = CNF()
    for _ in range(n_vars):
        cnf.new_var()
    model = rng.rand(n_vars) > 0.5
    for _ in range(3 * n_vars):
        vs = rng.choice(n_vars, 3, replace=False) + 1
        lits = [int(v) if rng.rand() > 0.5 else -int(v) for v in vs]
        v0 = int(vs[0])
        lits[0] = v0 if model[v0 - 1] else -v0
        cnf.add_clause(lits)
    return cnf


# ------------------------------------------------------------------ packs
@pytest.mark.parametrize("size", SIZES)
def test_packs_equal_reference_bytes_on_suite(size):
    """Each package encodes the suite with its own encoder and packs with
    its own packer: the single and stacked packs agree byte for byte."""
    r, c = int(size[0]), int(size[2])
    for name in suite.names():
        g, gr = suite.get(name), ref_suite.get(name)
        cgra, rcgra = CGRA(r, c), RefCGRA(r, c)
        mii = max(min_ii(g, cgra), 1)
        sess, rsess = EncoderSession(g, cgra), RefEncoderSession(gr, rcgra)
        cnfs = [sess.encode(ii).cnf for ii in (mii, mii + 1)]
        rcnfs = [rsess.encode(ii).cnf for ii in (mii, mii + 1)]
        for cnf, rcnf in zip(cnfs, rcnfs):
            for a, b in zip(pack_cnf_np(cnf), walksat_jax.pack_cnf_np(rcnf)):
                np.testing.assert_array_equal(a, b)
        mine = pack_cnf_window(cnfs, device="cpu")
        ref = walksat_jax.pack_cnf_window(rcnfs)
        for field in ("cvars", "csign", "ovars", "osign"):
            a = getattr(mine, field).numpy()
            b = np.asarray(getattr(ref, field))
            assert a.dtype == b.dtype and a.shape == b.shape, (name, field)
            assert a.tobytes() == b.tobytes(), (name, size, field)
        assert (mine.n_vars, mine.n_clauses) == (ref.n_vars, ref.n_clauses)


# ------------------------------------------------------------ step parity
def test_pick_flip_matches_jax_step_given_the_same_noise():
    """Feed the Gumbel draws of the JAX step's own split keys to the torch
    step: over 40 chained steps on a real window it flips exactly the
    variables the JAX step flips, solved chains (var 0) included."""
    rcnfs = [RefEncoderSession(ref_suite.get("sha"), RefCGRA(3, 3))
             .encode(7).cnf]
    p = walksat_jax.pack_cnf_window(rcnfs)
    cv, ov, os_ = p.cvars[0], p.ovars[0], p.osign[0]
    B, C, L = 8, cv.shape[0], cv.shape[1]
    rng = np.random.RandomState(0)
    assign = jnp.asarray(rng.rand(B, p.n_vars + 1) > 0.5)
    tc = jax.vmap(lambda a: walksat_jax.true_counts_ref(
        walksat_jax.PackedCNF(cv, p.csign[0], ov, os_, 0, 0), a))(assign)
    occ = occ_tables(torch.from_numpy(np.array(p.ovars)),
                     torch.from_numpy(np.array(p.osign)))
    cvt = torch.from_numpy(np.array(p.cvars))
    key = jax.random.PRNGKey(3)
    for step in range(40):
        if step == 20:      # chain 0 "solved": every clause satisfied
            tc = tc.at[0].set(1)
        want_v, want_nv, key2 = walksat_jax._pick_flip_one(
            cv, ov, os_, assign, tc, key, 2.3)
        _, k1, k2 = jax.random.split(key, 3)
        g1 = jax.random.gumbel(k1, (B, C))
        g2 = jax.random.gumbel(k2, (B, L))
        logits = jnp.where(tc == 0, 0.0, -1e30)
        assert (jax.random.categorical(k1, logits, axis=-1)
                == jnp.argmax(g1 + logits, -1)).all()   # the premise
        v, nv = _pick_flip(cvt, occ, torch.from_numpy(np.asarray(assign))[None],
                           torch.from_numpy(np.asarray(tc))[None],
                           torch.from_numpy(np.asarray(g1))[None],
                           torch.from_numpy(np.asarray(g2))[None], 2.3)
        np.testing.assert_array_equal(v[0].numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(nv[0].numpy(), np.asarray(want_nv))
        if step >= 20:
            assert int(v[0, 0]) == 0
        assign, tc = walksat_jax._apply_flip_one(ov, os_, assign, tc,
                                                 want_v, want_nv)
        key = key2


# -------------------------------------------------- engine bit-compatibility
@pytest.mark.parametrize("name", suite.names())
def test_device_engine_matches_host_engine_3x3(name):
    """Same seed, same statuses AND models AND near misses from the
    device-resident engine and the per-chunk host engine."""
    _, cnfs = _window_cnfs(name, CGRA(3, 3))
    nm_h, nm_d = {}, {}
    rh = solve_walksat_window(cnfs, seed=11, steps=600, batch=6,
                              engine="host", near_miss=nm_h)
    rd = solve_walksat_window(cnfs, seed=11, steps=600, batch=6,
                              engine="device", near_miss=nm_d)
    assert rh == rd
    assert nm_h == nm_d


def test_device_engine_is_deterministic():
    _, cnfs = _window_cnfs("sha", CGRA(3, 3))
    r1 = solve_walksat_window(cnfs, seed=4, steps=500, batch=6)
    r2 = solve_walksat_window(cnfs, seed=4, steps=500, batch=6)
    assert r1 == r2
    assert any(s == SAT for s, _ in r1)


def test_engine_env_override(monkeypatch):
    monkeypatch.setenv("REPRO_WALKSAT_ENGINE", "host")
    _, cnfs = _window_cnfs("srand", CGRA(3, 3))
    assert solve_walksat_window(cnfs, seed=1, steps=300, batch=4) == \
        solve_walksat_window(cnfs, seed=1, steps=300, batch=4,
                             engine="host")


def test_unknown_engine_rejected():
    with pytest.raises(ValueError):
        solve_walksat_window([_tiny_cnf()], engine="gpu-magic")


def test_solve_walksat_is_the_k1_window():
    cnf = _window_cnfs("gsm", CGRA(3, 3))[1][0]
    assert solve_walksat(cnf, seed=9, steps=400, batch=4) == \
        solve_walksat_window([cnf], seed=9, steps=400, batch=4)[0]


# ------------------------------------------------------- warm starts
def test_warm_start_longer_than_window_is_truncated():
    cnf = _tiny_cnf(8)
    status, model = solve_walksat(cnf, seed=0, steps=400, batch=4,
                                  init=[True] * 100000)
    assert status == SAT and cnf.check(model)


def test_warm_start_shrinking_window_across_iis():
    _, big = _window_cnfs("sha", CGRA(3, 3))
    nm: dict = {}
    solve_walksat_window([big[0]], seed=0, steps=300, batch=4, near_miss=nm)
    assert 0 in nm
    carried = nm[0][1]
    small = _tiny_cnf(5)
    assert len(carried) > small.n_vars
    res = solve_walksat_window([small], seed=0, steps=400, batch=4,
                               inits=[carried])
    assert res[0][0] == SAT and small.check(res[0][1])


def test_warm_start_chain0_is_the_padded_hint():
    """Chain 0 starts exactly from the hint (padded with False); the other
    chains flip a growing share of it."""
    from repro_torch.core.sat.walksat_torch import _init_assign
    gen = torch.Generator().manual_seed(0)
    a = _init_assign(gen, 16, 300, [True, False, True], "cpu")
    assert a.shape == (16, 301)
    assert a[0].tolist() == [False, True, False, True] + [False] * 297
    flips = a[1:, 4:].float().mean(1)
    assert flips[-1] > 0.3 and flips[0] < flips[-1]


# ------------------------------------------------------- near misses
@pytest.mark.parametrize("engine", ["host", "device"])
def test_near_miss_excludes_solved_and_skipped(engine):
    _, cnfs = _window_cnfs("sha", CGRA(3, 3))
    near: dict = {}
    res = solve_walksat_window(
        cnfs, seed=3, steps=800, batch=8, engine=engine,
        should_skip=lambda i: i == 2, near_miss=near)
    assert 2 not in near
    for i, (status, _) in enumerate(res):
        if status == SAT:
            assert i not in near
    for i, (nu, assign) in near.items():
        assert nu > 0 and res[i][0] == UNKNOWN
        n_unsat = sum(
            1 for cl in cnfs[i].clauses
            if not any((lit > 0) == assign[abs(lit) - 1] for lit in cl))
        assert n_unsat == nu


@pytest.mark.parametrize("engine", ["host", "device"])
def test_near_miss_streams_improvements(engine):
    _, cnfs = _window_cnfs("sha", CGRA(3, 3))
    seen: dict = {}
    final: dict = {}

    def on_nm(i, nu, assign):
        assert i not in seen or nu < seen[i]
        seen[i] = nu

    res = solve_walksat_window(cnfs[:1], seed=3, steps=800, batch=6,
                               engine=engine, near_miss=final,
                               on_near_miss=on_nm)
    assert res[0][0] == UNKNOWN
    assert 0 in seen and 0 in final
    assert seen[0] == final[0][0]


def test_stop_ends_the_walk_between_steps():
    _, cnfs = _window_cnfs("sha", CGRA(3, 3))
    calls = []

    def stop():
        calls.append(1)
        return len(calls) > 5

    res = solve_walksat_window(cnfs[:1], seed=0, steps=100000, batch=4,
                               stop=stop)
    assert res[0][0] == UNKNOWN and len(calls) < 20


# --------------------------------------------------------- chunk scheduling
def test_chunk_plan_honours_small_budgets():
    assert _chunk_plan(64, 100) == (64, 64)
    assert _chunk_plan(8192, 100) == (2048, 256)


def test_chunk_plan_bounds_by_formula_size():
    cap_small, _ = _chunk_plan(20000, 1000)
    cap_big, _ = _chunk_plan(20000, 20000)
    assert cap_big < cap_small
    assert cap_big == max(64, 2_000_000 // 20000)


@pytest.mark.parametrize("steps", [64, 100, 256, 1000, 4096, 20000])
def test_chunk_schedule_matches_reference_and_lands_on_budget(steps):
    cap, chunk = _chunk_plan(steps, 500)
    assert (cap, chunk) == walksat_jax._chunk_plan(steps, 500)
    done = 0
    while done < steps:
        done += chunk
        nxt = _next_chunk(chunk, cap, steps - done)
        assert nxt == walksat_jax._next_chunk(chunk, cap, steps - done)
        chunk = nxt
    assert done >= steps and done - steps < 256


def test_small_step_budget_is_respected_end_to_end():
    _, cnfs = _window_cnfs("sha", CGRA(3, 3))
    status, _ = solve_walksat(cnfs[0], seed=0, steps=1, batch=2)
    assert status == UNKNOWN


# ------------------------------------------------------- non-model guard
class _LyingCNF(CNF):
    """A CNF whose check() always fails — stands in for a miscompiled
    kernel making the device claim SAT on a non-model."""

    def check(self, assignment):
        return False


@pytest.mark.parametrize("engine", ["host", "device"])
def test_non_model_raises_structured_error(engine):
    lying = _LyingCNF()
    src = _tiny_cnf(6)
    for _ in range(src.n_vars):
        lying.new_var()
    for cl in src.clauses:
        lying.add_clause(list(cl))
    with pytest.raises(NonModelError):
        solve_walksat_window([lying], seed=0, steps=2000, batch=8,
                             engine=engine)


_OPT_SMOKE = r"""
import torch
import repro_torch
from repro_torch.core.cnf import CNF
from repro_torch.core.sat.walksat_torch import NonModelError, _validate_model
from repro_torch.device import DeviceUnavailable
from repro_torch.kernels._cuda import KernelError, check
from repro_torch.kernels.flip_update import flip_update

class Lying(CNF):
    def check(self, assignment):
        return False

class FakeLib:
    @staticmethod
    def repro_cuda_error_string(code):
        return b"invalid argument"

caught = []
for name, exc, fn in [
    ("NonModelError", NonModelError, lambda: _validate_model(Lying(), [], "x")),
    ("KernelError", KernelError, lambda: check(FakeLib, "k", 1)),
    ("ValueError", ValueError, lambda: flip_update(
        torch.zeros(1, 2, 3, dtype=torch.bool),
        torch.zeros(1, 2, 4, dtype=torch.int32),
        torch.zeros(1, 1, dtype=torch.int32),
        torch.zeros(1, 2, 5, dtype=torch.int32),
        torch.zeros(1, 2, 5, dtype=torch.bool),
        torch.zeros(1, 2, dtype=torch.bool))),
    ("DeviceUnavailable", DeviceUnavailable,
     lambda: repro_torch.set_default_device("meta")),
]:
    try:
        fn()
    except exc:
        caught.append(name)
if not torch.cuda.is_available():
    try:
        repro_torch.set_default_device("cuda")
    except DeviceUnavailable:
        caught.append("cuda")
    try:                      # the default is cuda: the walk refuses to start
        from repro_torch.core.sat.walksat_torch import solve_walksat
        cnf = CNF(); cnf.new_var(); cnf.add_clause([1])
        solve_walksat(cnf)
    except RuntimeError:
        caught.append("walk")
print(",".join(caught))
"""


def test_structured_errors_survive_python_O():
    # one torch thread for the CPU walk, as tests/test_torch_imports.py
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-O", "-c", _OPT_SMOKE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = out.stdout.strip().split(",")
    want = ["NonModelError", "KernelError", "ValueError", "DeviceUnavailable"]
    if not torch.cuda.is_available():
        want += ["cuda", "walk"]
    assert got == want
    with pytest.raises(NonModelError):   # and in this (non -O) process
        _validate_model(_LyingCNF(), [], "unit")
