"""The z3 backend, ``repro_torch.core.sat.z3_backend``, against the JAX
package's ``repro.core.sat.z3_backend``.

z3 is not installed where these tests run, so a fixture injects a stand-in
``z3`` module into ``sys.modules``. It implements exactly the surface the
two backends use (``Solver.add/set/check(*assumptions)/model/unsat_core/
statistics``, ``Bool``, ``Or``, ``Not``, ``is_true``, ``sat``/``unsat``/
``unknown`` and ``.eq``), decides each ``check`` with the JAX package's
CDCL under the same assumptions, and logs every call. Both backends run
through it on the same seeded CNFs and must agree on status, model, core
and call sequence; ``compile`` with ``solver="z3"`` must give the
reference's II; ``"auto"`` resolves to z3 with the stand-in and to CDCL
without it, in both packages."""
import os
import sys
import threading
import types

import numpy as np
import pytest
import torch

import repro.core.sat as ref_sat
import repro.core.sat.z3_backend as ref_z3
import repro_torch
import repro_torch.core.sat as port_sat
import repro_torch.core.sat.z3_backend as port_z3
from repro.core import MapRequest as RefMapRequest, compile as ref_compile
from repro.core import suite as ref_suite
from repro.core.cnf import CNF as RefCNF
from repro.core.mapper import MapperConfig as RefMapperConfig
from repro.core.sat.cdcl import CDCLSolver
from repro_torch import MapperConfig, MapRequest, compile
from repro_torch.core import suite
from repro_torch.core.cnf import CNF
from repro_torch.core.service import MappingService

repro_torch.set_default_device("cpu")
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ the stand-in
class _Expr:
    """A Boolean term. Like z3's, it has no truth value and no ``==``:
    terms are compared with ``.eq``."""

    def __init__(self, key):
        self.key = key

    def eq(self, other) -> bool:
        return isinstance(other, _Expr) and self.key == other.key

    def __eq__(self, other):
        raise TypeError("compare z3 terms with .eq()")

    __hash__ = None

    def __bool__(self):
        raise TypeError("Symbolic expressions cannot be cast to concrete "
                        "Boolean values.")


class _Result:
    def __init__(self, name):
        self.name = name

    def __repr__(self):
        return self.name


class _Value:
    def __init__(self, value: bool):
        self.value = value


class Z3Exception(Exception):
    pass


def _lit(e: _Expr) -> int:
    if e.key[0] == "not":
        return -_lit(_Expr(e.key[1]))
    assert e.key[0] == "bool" and e.key[1].startswith("x"), e.key
    return int(e.key[1][1:])


def _make_z3(unknown_slices: int = 0, core_fails: bool = False,
             stats_fail: bool = False) -> types.ModuleType:
    """A fresh stand-in module. ``unknown_slices``: the first so many
    ``check`` calls made under a timeout answer ``unknown`` (expired
    slices). ``core_fails``: ``unsat_core`` raises. ``stats_fail``:
    ``statistics`` raises."""
    z3 = types.ModuleType("z3")
    z3.sat, z3.unsat, z3.unknown = (_Result("sat"), _Result("unsat"),
                                    _Result("unknown"))
    z3.Z3Exception = Z3Exception
    z3.solvers = []
    lock = threading.Lock()
    state = {"unknown_slices": unknown_slices}

    class Context:
        pass

    z3.bools = []           # (name, context) of every Bool made

    def Bool(name, ctx=None):
        with lock:
            z3.bools.append((name, ctx))
        return _Expr(("bool", name))

    def Not(e):
        return _Expr(("not", e.key))

    def Or(*args):
        return _Expr(("or",) + tuple(a.key for a in args))

    def is_true(v):
        return isinstance(v, _Value) and v.value is True

    class Model:
        def __init__(self, values):
            self._values = values

        def __getitem__(self, e):
            # z3 leaves a variable that no assertion mentions out of the
            # model: ``m[x]`` is None for it
            return self._values.get(_lit(e))

    class Solver:
        def __init__(self, ctx=None):
            self.ctx = ctx
            self.log = [("Solver",)]
            self.clauses = []
            self.timeout = 0
            self.engine = CDCLSolver()
            self._pushed = 0
            self._last = None
            with lock:
                z3.solvers.append(self)

        def add(self, *exprs):
            for e in exprs:
                assert e.key[0] == "or", e.key
                self.clauses.append(tuple(_lit(_Expr(k))
                                          for k in e.key[1:]))
                self.log.append(("add", e.key))

        def set(self, key, value):
            self.log.append(("set", key, value))
            if key == "timeout":
                self.timeout = value

        def check(self, *assumptions):
            self.log.append(("check", tuple(a.key for a in assumptions),
                             self.timeout))
            with lock:
                expired = self.timeout > 0 and state["unknown_slices"] > 0
                if expired:
                    state["unknown_slices"] -= 1
            if expired:
                self._last = None
                return z3.unknown
            new = self.clauses[self._pushed:]
            lits = [_lit(a) for a in assumptions]
            self.engine.add_clauses(new, n_vars=max(
                [abs(l) for cl in new for l in cl] + [abs(l) for l in lits],
                default=0))
            self._pushed = len(self.clauses)
            status, model = self.engine.solve(assumptions=lits)
            self._last = (status, model, lits, list(assumptions))
            return z3.sat if status == "SAT" else z3.unsat

        def model(self):
            self.log.append(("model",))
            _, model, lits, _ = self._last
            seen = {abs(l) for cl in self.clauses for l in cl}
            seen |= {abs(l) for l in lits}
            return Model({v: _Value(bool(model[v - 1])) for v in seen})

        def unsat_core(self):
            self.log.append(("unsat_core",))
            if core_fails:
                raise Z3Exception("unsat core is not available")
            _, _, lits, exprs = self._last
            core = set(self.engine.last_core)
            return [e for l, e in zip(lits, exprs) if l in core]

        def statistics(self):
            self.log.append(("statistics",))
            if stats_fail:
                raise Z3Exception("no statistics")
            return [("conflicts", self.engine.conflicts_total),
                    ("checks", sum(1 for c in self.log
                                   if c[0] == "check"))]

    z3.Bool, z3.Not, z3.Or, z3.is_true = Bool, Not, Or, is_true
    z3.Solver, z3.Context = Solver, Context
    return z3


@pytest.fixture
def fake_z3(monkeypatch):
    """Install a stand-in ``z3`` for the test; returns a function that
    installs a fresh one (with the given options) and returns it."""
    def install(**kw):
        z3 = _make_z3(**kw)
        monkeypatch.setitem(sys.modules, "z3", z3)
        return z3
    install()
    return install


@pytest.fixture
def no_z3(monkeypatch):
    monkeypatch.setitem(sys.modules, "z3", None)


# --------------------------------------------------------------- the CNFs
def _random_cnf(rng, n_vars, n_clauses, k=3):
    clauses = []
    for _ in range(n_clauses):
        vs = rng.choice(n_vars, size=k, replace=False) + 1
        signs = rng.integers(0, 2, size=k) * 2 - 1
        clauses.append(tuple(int(v * s) for v, s in zip(vs, signs)))
    return clauses


def _cases(seed):
    """Seeded 3-SAT formulas around the threshold (some SAT, some UNSAT),
    each split into a base and a later layer, with assumption sets."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 30))
    clauses = _random_cnf(rng, n, int(rng.integers(2 * n, 6 * n)))
    cut = len(clauses) // 2
    assumption_sets = [[]]
    for _ in range(4):
        vs = rng.choice(n, size=int(rng.integers(1, 6)), replace=False) + 1
        signs = rng.integers(0, 2, size=len(vs)) * 2 - 1
        assumption_sets.append([int(v * s) for v, s in zip(vs, signs)])
    return n, clauses[:cut], clauses[cut:], assumption_sets


def _cnf(cls, n_vars):
    cnf = cls()
    cnf.new_vars(n_vars)
    return cnf


def _satisfies(clauses, assumptions, model):
    val = lambda l: model[abs(l) - 1] == (l > 0)  # noqa: E731
    return all(any(val(l) for l in cl) for cl in clauses) and \
        all(val(l) for l in assumptions)


def _run_incremental(mod, install, case, **kw):
    z3 = install(**kw)
    n, base, later, assumption_sets = case
    s = mod.Z3IncrementalSolver()
    s.add_clauses(base, n_vars=n)
    out = []
    for i, a in enumerate(assumption_sets):
        if i == 2:
            s.add_clauses(later)        # the layer arrives mid-sweep
        status, model = s.solve(assumptions=a)
        out.append((status, model, s.last_core))
    out.append(s.stats())
    return out, [sv.log for sv in z3.solvers]


# ------------------------------------------------------------- the tests
@pytest.mark.parametrize("seed", range(12))
def test_incremental_backends_agree(fake_z3, seed):
    case = _cases(seed)
    mine, mine_log = _run_incremental(port_z3, fake_z3, case)
    ref, ref_log = _run_incremental(ref_z3, fake_z3, case)
    assert mine == ref
    assert mine_log == ref_log
    n, base, later, assumption_sets = case
    for i, (status, model, core) in enumerate(mine[:-1]):
        clauses = base + (later if i >= 2 else [])
        if status == "SAT":
            assert core is None and len(model) == n
            assert _satisfies(clauses, assumption_sets[i], model)
        else:
            assert status == "UNSAT" and model is None
            assert set(core) <= set(assumption_sets[i])
            check = CDCLSolver()
            check.add_clauses(clauses, n_vars=n)
            assert check.solve(assumptions=core)[0] == "UNSAT"
    assert {r[0] for r in mine[:-1]} <= {"SAT", "UNSAT"}


def test_each_port_solver_owns_its_context(fake_z3):
    """The deliberate difference: the port's solvers (incremental and
    cold) each make their variables in a z3 context of their own, so that
    threads never share one; the reference's use z3's main context (none
    passed). Everything else of the call sequence is the same."""
    n, base, later, _ = _cases(2)
    made = {}
    for mod, cnf_cls in ((port_z3, CNF), (ref_z3, RefCNF)):
        z3 = fake_z3()
        for _ in range(2):
            s = mod.Z3IncrementalSolver()
            s.add_clauses(base + later, n_vars=n)
            s.solve()
        cnf = _cnf(cnf_cls, n)
        for cl in base:
            cnf.add_clause(cl)
        mod.solve_z3(cnf)
        made[mod] = ([sv.ctx for sv in z3.solvers], z3.bools)
    ctxs, bools = made[port_z3]
    assert len(ctxs) == 3 and None not in ctxs and len(set(map(id, ctxs))) == 3
    # each solver's variables in its own context, in creation order (the
    # cold solve makes x0 too)
    assert [c for _, c in bools] == [ctxs[0]] * n + [ctxs[1]] * n + \
        [ctxs[2]] * (n + 1)
    ref_ctxs, ref_bools = made[ref_z3]
    assert ref_ctxs == [None] * 3 and {c for _, c in ref_bools} == {None}
    assert [b for b, _ in bools] == [b for b, _ in ref_bools]


def test_the_seeded_cases_cover_sat_unsat_and_cores(fake_z3):
    seen = set()
    for seed in range(12):
        mine, _ = _run_incremental(port_z3, fake_z3, _cases(seed))
        for status, _, core in mine[:-1]:
            seen.add(status if status == "SAT" else
                     ("UNSAT", "global" if core == [] else "core"))
    assert seen == {"SAT", ("UNSAT", "global"), ("UNSAT", "core")}


@pytest.mark.parametrize("seed", range(6))
def test_cold_backends_agree(fake_z3, seed):
    n, base, later, _ = _cases(seed)
    results, logs = [], []
    for mod, cnf_cls in ((port_z3, CNF), (ref_z3, RefCNF)):
        z3 = fake_z3()
        cnf = _cnf(cnf_cls, n)
        for cl in base + later:
            cnf.add_clause(cl)
        results.append(mod.solve_z3(cnf))
        logs.append([sv.log for sv in z3.solvers])
    assert results[0] == results[1] and logs[0] == logs[1]
    status, model = results[0]
    if status == "SAT":
        assert _satisfies(base + later, [], model)


@pytest.mark.parametrize("mod", [port_z3, ref_z3], ids=["port", "ref"])
def test_empty_clause_latches_without_a_check(fake_z3, mod):
    z3 = fake_z3()
    s = mod.Z3IncrementalSolver()
    s.add_clauses([(1, 2), (), (-1,)], n_vars=2)
    assert s.unsat_latched and s.n_clauses == 2
    assert s.solve(assumptions=[2]) == ("UNSAT", None)
    assert s.last_core == []
    assert not any(c[0] == "check" for c in z3.solvers[0].log)


def test_the_empty_clause_agrees(fake_z3):
    outs = []
    for mod, cnf_cls in ((port_z3, CNF), (ref_z3, RefCNF)):
        z3 = fake_z3()
        s = mod.Z3IncrementalSolver()
        s.add_clauses([(1, -2), ()])
        cnf = _cnf(cnf_cls, 2)
        cnf.add_clause((1, -2))
        cnf.add_clause(())
        cnf.trivially_unsat = False     # reach the clause loop's own check
        outs.append((s.solve(), s.last_core, s.n_clauses, len(s.xs),
                     mod.solve_z3(cnf), [sv.log for sv in z3.solvers]))
    assert outs[0] == outs[1]
    assert outs[0][0] == ("UNSAT", None) and outs[0][4] == ("UNSAT", None)


@pytest.mark.parametrize("stop_after", [None, 0, 2])
def test_slices_poll_stop(fake_z3, stop_after):
    """500 ms slices while a ``stop`` is given: an expired slice polls it
    and solves on, or returns UNKNOWN; without ``stop`` no timeout is set."""
    n, base, later, _ = _cases(3)
    outs = []
    for mod in (port_z3, ref_z3):
        z3 = fake_z3(unknown_slices=3)
        polls = []

        def stop():
            polls.append(1)
            return stop_after is not None and len(polls) > stop_after

        s = mod.Z3IncrementalSolver()
        s.add_clauses(base + later, n_vars=n)
        first = s.solve(stop=stop)
        second = s.solve()
        outs.append((first, second, len(polls),
                     [sv.log for sv in z3.solvers]))
    assert outs[0] == outs[1]
    first, second, n_polls, (log,) = outs[0]
    checks = [c for c in log if c[0] == "check"]
    if stop_after == 0:
        assert first == ("UNKNOWN", None) and n_polls == 1 and not checks[:-1]
    elif stop_after == 2:
        assert first == ("UNKNOWN", None) and n_polls == 3
        assert [c[2] for c in checks[:2]] == [500, 500]
    else:
        assert first[0] in ("SAT", "UNSAT") and n_polls == 4
        assert [c[2] for c in checks[:4]] == [500] * 4
    assert ("set", "timeout", 0) in log     # the stop-free solve after it
    assert second[0] in ("SAT", "UNSAT")


@pytest.mark.parametrize("timeout_ms", [None, 40])
def test_cold_slices(fake_z3, timeout_ms):
    """``solve_z3``: a caller's timeout ends at the first expired slice;
    without one, 500 ms slices poll ``stop`` and solve on."""
    n, base, later, _ = _cases(5)
    outs = []
    for mod, cnf_cls in ((port_z3, CNF), (ref_z3, RefCNF)):
        z3 = fake_z3(unknown_slices=2)
        cnf = _cnf(cnf_cls, n)
        for cl in base + later:
            cnf.add_clause(cl)
        outs.append((mod.solve_z3(cnf, timeout_ms=timeout_ms,
                                  stop=lambda: False),
                     [sv.log for sv in z3.solvers]))
    assert outs[0] == outs[1]
    (status, _), (log,) = outs[0]
    checks = [c for c in log if c[0] == "check"]
    if timeout_ms:
        assert status == "UNKNOWN" and len(checks) == 1
        assert ("set", "timeout", 40) in log
    else:
        assert status in ("SAT", "UNSAT") and len(checks) == 3
        assert ("set", "timeout", 500) in log


def test_core_over_approximates_when_unsat_core_fails(fake_z3):
    clauses = [(1,), (-1, 2)]
    outs = []
    for mod in (port_z3, ref_z3):
        z3 = fake_z3(core_fails=True)
        s = mod.Z3IncrementalSolver()
        s.add_clauses(clauses, n_vars=4)
        outs.append((s.solve(assumptions=[3, -2, 4]), s.last_core,
                     [sv.log for sv in z3.solvers]))
    assert outs[0] == outs[1]
    assert outs[0][0] == ("UNSAT", None) and outs[0][1] == [3, -2, 4]
    assert ("unsat_core",) in outs[0][2][0]


def test_cores_map_back_by_position(fake_z3):
    """The core is the assumptions that ``unsat_core`` names, in the
    caller's order, a repeated literal kept at each place."""
    outs = []
    for mod in (port_z3, ref_z3):
        fake_z3()
        s = mod.Z3IncrementalSolver()
        s.add_clauses([(-1, -2), (3, 4)], n_vars=5)
        outs.append((s.solve(assumptions=[5, 2, 1, 2]), s.last_core))
    assert outs[0] == outs[1]
    assert outs[0][0] == ("UNSAT", None)
    assert outs[0][1] == [2, 1, 2]


@pytest.mark.parametrize("stats_fail", [False, True])
def test_stats(fake_z3, stats_fail):
    outs = []
    for mod in (port_z3, ref_z3):
        fake_z3(stats_fail=stats_fail)
        s = mod.Z3IncrementalSolver()
        s.add_clauses([(1, 2), (-1, 2), (1, -2)], n_vars=2)
        s.solve(assumptions=[-2])
        outs.append(s.stats())
    assert outs[0] == outs[1]
    assert outs[0] == ({} if stats_fail else {"conflicts": outs[0]
                                              ["conflicts"], "checks": 1})


@pytest.mark.parametrize("present", [True, False])
def test_auto_resolves_like_the_reference(monkeypatch, present):
    monkeypatch.setitem(sys.modules, "z3", _make_z3() if present else None)
    want = "z3" if present else "cdcl"
    assert port_sat.resolve_method("auto") == ref_sat.resolve_method(
        "auto") == want
    assert port_sat._has_z3() is ref_sat._has_z3() is present
    for m in ("z3", "cdcl", "walksat", "portfolio"):
        assert port_sat.resolve_method(m) == ref_sat.resolve_method(m) == m


def test_without_z3_the_backend_raises_like_the_reference(no_z3):
    """Without z3 both packages raise the same ``ModuleNotFoundError`` from
    the backend's ``import z3``; neither gives way to CDCL."""
    errors = []
    for sat, mod, cnf_cls in ((port_sat, port_z3, CNF),
                              (ref_sat, ref_z3, RefCNF)):
        cnf = _cnf(cnf_cls, 2)
        cnf.add_clause((1, 2))
        for call in (lambda: sat.solve(cnf, "z3"),
                     mod.Z3IncrementalSolver,
                     lambda: mod.solve_z3(cnf)):
            with pytest.raises(ModuleNotFoundError) as err:
                call()
            errors.append((str(err.value), err.traceback[-1].name))
    assert errors[:3] == errors[3:]
    assert [e[1] for e in errors[:3]] == ["solve_z3", "__init__",
                                          "solve_z3"]


def test_solve_dispatches_z3(fake_z3):
    n, base, later, _ = _cases(7)
    outs = []
    for sat, cnf_cls in ((port_sat, CNF), (ref_sat, RefCNF)):
        z3 = fake_z3()
        cnf = _cnf(cnf_cls, n)
        for cl in base + later:
            cnf.add_clause(cl)
        outs.append((sat.solve(cnf, "z3"), sat.solve(cnf, "auto"),
                     len(z3.solvers)))
    assert outs[0] == outs[1] and outs[0][2] == 2


def _attempts(res):
    return [(a.ii, a.status, a.via) for a in res.attempts]


@pytest.mark.parametrize("name,width,incremental", [
    ("nw", 1, True), ("gsm", 1, True), ("sha", 1, False),
    ("nw", 4, True), ("backprop", 4, False)])
def test_compile_with_z3_equals_reference(fake_z3, name, width,
                                          incremental):
    """Through ``compile``: the session's ``Z3IncrementalSolver``
    (incremental), the cold ``solve_z3`` (sequential) and its thread pool
    (a cold sweep window) give the reference's II and attempts."""
    mine = compile(MapRequest(
        dfg=suite.get(name), arch="2x2", sweep_width=width,
        config=MapperConfig(solver="z3", incremental=incremental)))
    n_mine = len(sys.modules["z3"].solvers)
    fake_z3()
    ref = ref_compile(RefMapRequest(
        dfg=ref_suite.get(name), arch="2x2", sweep_width=width,
        config=RefMapperConfig(solver="z3", incremental=incremental)))
    assert (mine.success, mine.ii, mine.mii) == (ref.success, ref.ii,
                                                 ref.mii)
    assert _attempts(mine) == _attempts(ref)
    assert mine.success and n_mine > 0
    if incremental:
        assert "z3" in {a.via for a in mine.attempts}
    cdcl = ref_compile(RefMapRequest(dfg=ref_suite.get(name), arch="2x2",
                                     solver="cdcl"))
    assert mine.ii == cdcl.ii


def test_auto_compiles_on_z3_through_the_service(fake_z3):
    res = compile(MapRequest(dfg=suite.get("nw"), arch="2x2",
                             service=MappingService()))
    assert res.success and sys.modules["z3"].solvers
    assert {a.via for a in res.attempts} == {"z3"}


def test_the_mapper_warm_start_stays_cdcl_only(fake_z3):
    """A z3 session takes no phase hint (``mapper.map_loop``'s warm start
    is for CDCL alone, as in the reference)."""
    from repro_torch.core.sat import portfolio
    seen = []
    orig = portfolio.SolverSession.solve_ii

    def spy(self, ii, stop=None, phase_hint=None):
        seen.append((self.complete_method, phase_hint))
        return orig(self, ii, stop=stop, phase_hint=phase_hint)

    mp = pytest.MonkeyPatch()
    mp.setattr(portfolio.SolverSession, "solve_ii", spy)
    try:
        res = compile(MapRequest(dfg=suite.get("gsm"), arch="2x2",
                                 solver="z3"))
    finally:
        mp.undo()
    assert res.success and len(seen) > 1
    assert all(m == "z3" and hint is None for m, hint in seen)


def test_every_reference_module_has_a_port():
    """The port's module list is complete: each module of ``repro`` has a
    module of the same path in ``repro_torch``, but for the two that are
    ported under another name."""
    renamed = {"core/sat/walksat_jax.py": "core/sat/walksat_torch.py",
               "analysis/rules/pallas_constraints.py":
                   "analysis/rules/cuda_wrapper.py"}

    def modules(pkg):
        root = os.path.join(REPO, "src", pkg)
        return {os.path.relpath(os.path.join(d, f), root)
                for d, _, fs in os.walk(root) for f in fs
                if f.endswith(".py")}

    port = modules("repro_torch")
    for rel in sorted(modules("repro")):
        assert renamed.get(rel, rel) in port, rel
