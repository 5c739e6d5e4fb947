"""What a run of a cell hands back, and the result line it prints."""
from __future__ import annotations

import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

from . import registry

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Check:
    """One number compared with the reference, and its limit (the number
    passes at or under the limit)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Outcome:
    """A kind's report of one run: requests or steps attempted and failed,
    the end-to-end values, what the per-layer readers read
    (``observed``), the comparisons (answers that never came among them),
    and the device's numbers."""
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    observed: Any
    checks: List[Check]
    memory_peak_bytes: int
    trace: Any = None

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(
            c.ok for c in self.checks)


def limits(cell_name: str, root: Path = registry.ROOT) -> Dict[str, float]:
    """The limits of the cell's compared numbers,
    ``perfbench/limits/<cell>.json`` (each entry's ``limit``)."""
    path = Path(root) / "perfbench" / "limits" / f"{cell_name}.json"
    with open(path) as f:
        return {k: float(v["limit"]) for k, v in json.load(f).items()}


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark's process may
    not hold (JAX and the JAX package), compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def line(cell: registry.Cell, out: Outcome, trace: bool,
         device: Dict[str, Any]) -> Dict[str, Any]:
    """The result object: the cell's end-to-end metrics (``trace`` False)
    or the per-layer metrics its readers found (``trace`` True)."""
    metrics: Dict[str, Dict[str, Any]] = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] not in out.end_to_end:
                raise KeyError(f"cell {cell.name} reports no {m['name']}")
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = registry.metric_reader(m["name"], cell.root).read(
                out.observed)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    obj: Dict[str, Any] = {"correct": out.correct,
                           "attempted": out.attempted,
                           "failed": out.failed, "metrics": metrics,
                           "device": device}
    if trace and out.trace is not None:
        obj["breakdown"] = {"device_ops": out.trace.top_ops(10),
                            "idle_gaps": out.trace.idle_gaps(10)}
    obj["compared"] = {c.name: {"value": c.value, "limit": c.limit}
                       for c in out.checks}
    return obj
