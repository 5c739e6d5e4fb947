"""On the card: each cell's control comes out as not correct.

At each cell's own sizes, one seed: the program's readings pass the
cell's limits, and the reference computed in float8 in the program's
place fails at least one of them (``perfbench/control.py`` reads the
same numbers over many seeds to set the limits). Run on the machine with
the card:

    PYTHONPATH=src python -m pytest -q perfbench/tests -m chip
"""
from __future__ import annotations

import time

import pytest

from perfbench.harness import registry, result

CELLS = [w["name"] for w in registry.load_benchmark()["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_is_refused_on_the_card(cuda, name):
    import torch
    torch.cuda.set_device(cuda)
    cell = registry.cell(name)
    ctx = registry.Context(cell, 2 ** 32 + 7, 0.0, False, cuda,
                           time.perf_counter())
    got = registry.kind_module(cell.kind).readings(ctx, control=True)
    limits = result.limits(name)
    assert all(got[k] <= v for k, v in limits.items()), (got, limits)
    assert any(got["control_" + k] > v for k, v in limits.items()), \
        (got, limits)
