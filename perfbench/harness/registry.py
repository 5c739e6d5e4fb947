"""Cells, configurations, traffic mixes and metrics, found by name.

``BENCHMARK.json`` (at the checkout's root) names each cell's
configuration and traffic mix and lists the metrics. A configuration is
the file its ``configs`` entry names; a traffic mix is
``perfbench/traffic/<traffic>.json``, whose ``kind`` names the module
``perfbench/kinds/<kind>.py`` that drives it; a per-layer metric is
``perfbench/metrics/<metric>.py``, which holds its reader. Adding a cell,
a configuration, a mix or a metric adds files and entries and edits no
file that is there.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parents[2]


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, read."""
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]] = field(default_factory=list)
    per_layer: List[Dict[str, Any]] = field(default_factory=list)
    root: Path = ROOT

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def applies(metric: Dict[str, Any], cell_name: str) -> bool:
    """Whether a metric of ``BENCHMARK.json`` is reported in a cell: every
    cell without a ``workloads`` key, else the cells it lists."""
    return "workloads" not in metric or cell_name in metric["workloads"]


def traffic_path(name: str, root: Path = ROOT) -> Path:
    return Path(root) / "perfbench" / "traffic" / f"{name}.json"


def metric_path(name: str, root: Path = ROOT) -> Path:
    return Path(root) / "perfbench" / "metrics" / f"{name}.py"


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; ``KeyError`` for a name it
    does not list."""
    bench = load_benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]]
    if not conf:
        raise KeyError(f"workload {name!r} names configuration "
                       f"{w['config']!r}, which BENCHMARK.json lacks")
    with open(Path(root) / conf[0]["file"]) as f:
        config = json.load(f)
    with open(traffic_path(w["traffic"], root)) as f:
        traffic = json.load(f)
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if applies(m, name)],
                root=Path(root))


def kind_module(kind: str) -> ModuleType:
    """The module that drives traffic of ``kind`` (``perfbench.kinds``)."""
    return importlib.import_module(f"perfbench.kinds.{kind}")


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """The module of per-layer metric ``name``: ``read(observed)`` gives
    its value or None, ``LAYER`` and ``MOVES`` say where it sits."""
    path = metric_path(name, root)
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    if spec is None or spec.loader is None:
        raise KeyError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def model_config(cell_: Cell, **overrides: Any):
    """The port's ``ModelConfig`` of the cell's configuration file (its
    ``model`` object), with ``overrides``."""
    from repro_torch.models.config import ModelConfig
    fields = dict(cell_.config["model"])
    fields.update(overrides)
    return ModelConfig(**fields)


@dataclass
class Context:
    """What a traffic kind is handed: the cell, the run's seed, window
    length and tracing, the device, and the process's start on the host
    clock (``time.perf_counter``)."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t0: float
