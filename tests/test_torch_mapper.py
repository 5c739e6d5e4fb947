"""``repro_torch.compile`` against ``repro.core.api.compile``: the same
success, II, MII and per-attempt statuses with the walk racer forced on,
walk models that are models, the timeout probe, the refusals of what is
not ported yet, and the racer's failures surfacing instead of vanishing."""
import ast
import functools
import os
import sys

import pytest
import torch

import repro.core.sweep as ref_sweep
import repro_torch
import repro_torch.core.sweep as port_sweep
from repro.core import MapRequest as RefMapRequest, compile as ref_compile
from repro.core import suite as ref_suite
from repro.core.sat import portfolio as ref_portfolio
from repro_torch import MapperConfig, MapRequest, compile
from repro_torch.core import suite
from repro_torch.core.cgra import CGRA
from repro_torch.core.encode import EncoderSession
from repro_torch.core.sat import SAT, portfolio, walksat_torch
from repro_torch.core.schedule import min_ii
from repro_torch.core.service import MappingService
from repro_torch.core.simulator import verify_mapping
from repro_torch.kernels._cuda import KernelError

repro_torch.set_default_device("cpu")
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def racer_on(monkeypatch):
    """Start the walk racer with the complete leg (walksat_delay=0) in
    both packages' sweeps, so the walk runs on every window."""
    monkeypatch.setattr(ref_sweep, "solve_window", functools.partial(
        ref_portfolio.solve_window, walksat_delay=0.0))
    monkeypatch.setattr(port_sweep, "solve_window", functools.partial(
        portfolio.solve_window, walksat_delay=0.0))


def _compare(name, size, width):
    mine = compile(MapRequest(dfg=suite.get(name), arch=size,
                              sweep_width=width))
    ref = ref_compile(RefMapRequest(dfg=ref_suite.get(name), arch=size,
                                    sweep_width=width))
    assert (mine.success, mine.ii, mine.mii) == \
        (ref.success, ref.ii, ref.mii), (name, size, width)
    assert [a.status for a in mine.attempts] == \
        [a.status for a in ref.attempts], (name, size, width)
    assert not mine.timed_out


@pytest.mark.parametrize("width", [1, 4])
@pytest.mark.parametrize("size", ["2x2", "3x3"])
@pytest.mark.parametrize("name", ["sha", "gsm", "backprop", "nw"])
def test_compile_equals_reference(racer_on, name, size, width):
    before = portfolio.racer_failures()
    _compare(name, size, width)
    assert portfolio.racer_failures() == before


@pytest.mark.slow
@pytest.mark.parametrize("width", [1, 4])
@pytest.mark.parametrize("size", ["2x2", "3x3", "4x4"])
@pytest.mark.parametrize("name", suite.names())
def test_compile_equals_reference_all_cells(racer_on, name, size, width):
    """The whole suite grid: slow because it maps all 33 cells at two
    widths in both packages."""
    _compare(name, size, width)


def test_late_racer_never_sees_a_half_built_layer(racer_on):
    """A racer packs its window on its own thread, possibly after the
    window closed, while the sweep encodes the next window's layers into
    the same session. patricia's windows are SAT at 2x2 but each CDCL
    model fails register allocation, so the sweep slides through many
    windows quickly; with a short switch interval the racer and the
    encoder interleave. No racer may fail and no request may time out.
    A walk model can pass register allocation where the CDCL's do not
    (more often on a loaded CPU), so a success is accepted only when its
    placement passes the simulator again here."""
    before = portfolio.racer_failures()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for arch in ("2x2", "3x3", "4x4") * 3:
            res = compile(MapRequest(dfg=suite.get("patricia"), arch=arch,
                                     sweep_width=4))
            assert not res.timed_out
            if res.success:
                chk = verify_mapping(res.dfg, res.cgra, res.placement,
                                     res.ii, n_iters=MapperConfig().verify_iters)
                assert chk.ok, (arch, res.ii, chk.errors[:3])
    finally:
        sys.setswitchinterval(old)
    assert portfolio.racer_failures() == before


def test_walk_models_are_models():
    """The incomplete-only window: every model the walk delivers passes
    the model check the walk itself applies (``_validate_model``)."""
    g, cgra = suite.get("sha"), CGRA(3, 3)
    mii = min_ii(g, cgra)
    sess = EncoderSession(g, cgra)
    cnfs = [sess.encode(ii).cnf for ii in range(mii, mii + 3)]
    res = portfolio.solve_window(cnfs, method="walksat", seed=0,
                                 walksat_steps=600, walksat_batch=8)
    sat = [i for i, r in enumerate(res) if r.status == SAT]
    assert sat
    for i in sat:
        assert res[i].via == "walksat"
        walksat_torch._validate_model(cnfs[i], res[i].model, "test")


def test_walksat_solver_maps():
    res = compile(MapRequest(dfg=suite.get("srand"), arch="2x2",
                             sweep_width=4, solver="walksat"))
    assert res.success and res.ii == 3
    assert any(a.via == "walksat" for a in res.attempts)


def test_timeout_gives_no_ii():
    res = compile(MapRequest(dfg=suite.get("sha"), arch="4x4",
                             config=MapperConfig(timeout_s=0.001)))
    assert res.timed_out and res.ii is None


def test_unported_surfaces_refuse():
    g = suite.get("nw")
    with pytest.raises(NotImplementedError):
        compile(MapRequest(dfg=g, arch="2x2", solver="z3"))
    # the z3 backend refuses through the service too
    with pytest.raises(NotImplementedError):
        compile(MapRequest(dfg=g, arch="2x2", solver="z3",
                           service=MappingService()))


def test_racer_kernel_failure_is_reraised(monkeypatch):
    def broken(*a, **kw):
        raise KernelError("flip_update launch failed: CUDA error 1")

    monkeypatch.setattr(walksat_torch, "solve_walksat_window", broken)
    g, cgra = suite.get("sha"), CGRA(3, 3)
    mii = min_ii(g, cgra)
    sess = EncoderSession(g, cgra)
    cnfs = [sess.encode(ii).cnf for ii in range(mii, mii + 2)]
    before = portfolio.racer_failures()
    with pytest.raises(KernelError):
        # raised when the window closes, or by the next window if the
        # racer thread failed only after the first one closed
        for _ in range(2):
            portfolio.solve_window(cnfs, walksat_delay=0.0)
    assert portfolio.racer_failures() >= before + 1


def _expected_ii_table():
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                node.targets[0].id == "EXPECTED_II_4X4":
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py has no EXPECTED_II_4X4")


def test_chip_smoke_expected_iis_are_the_references():
    """The card-side check of ``chip_smoke.py`` holds the port to this
    table; it must be what the reference maps at 4x4, sweep width 4."""
    table = _expected_ii_table()
    assert sorted(table) == sorted(ref_suite.names())
    for name in ref_suite.names():
        res = ref_compile(RefMapRequest(dfg=ref_suite.get(name), arch="4x4",
                                        sweep_width=4))
        assert table[name] == (res.ii if res.success else None), name
