"""Dry run of every (arch x shape x mesh) cell on the meta device (the
port's counterpart of the JAX package's ``launch/dryrun.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_34b \
        --shape train_4k --mesh pod --out results/dryrun.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # every cell

Each cell is one JSON record with the reference's keys (memory, cost,
collectives, roofline, model FLOPs), appended to the JSONL. The dry run
needs no GPU and touches no device memory on any machine: the LM, its
optimizer state and the step's inputs are meta tensors (``LM(cfg, "meta",
tp=...)``), and the step functions are ``launch/steps.py``'s, run eagerly
on them. Where the reference lowers and compiles for 512 forced host
devices, the port reads the mesh's shape only
(``repro_torch.launch.mesh.LogicalMesh``).

What a record holds, and how it differs from the reference's:

- ``memory.argument_bytes`` is exact per device: each argument leaf (the
  parameters; for training the AdamW state, m and v in f32 and the step;
  the batch; for decode the cache, the tokens and the position) counted
  at its shard shape on the mesh (``models.sharding.shard_shape`` of the
  leaf's spec) times its item size. No tracing is needed for it
  (:func:`cell_arguments`).
- The step is traced once at global shapes with the config as given.
  ``cost.flops`` comes from ``torch.utils.flop_counter.FlopCounterMode``,
  which counts matrix products (and ``flash_attention``, by its
  registered formula) only, where XLA's ``cost_analysis`` counts
  elementwise work too: ``useful_flop_ratio`` is not comparable with the
  reference's. ``cost.bytes_accessed`` sums each aten op's tensor inputs
  and outputs (a view or an alias counts 0, and an ``empty`` allocation
  writes nothing): the traffic of the eager, unfused program the port runs,
  not of a fused XLA program. ``memory.temp_bytes`` is the peak of the
  bytes of storages made during the step and alive at once: the live
  bytes above the arguments. ``memory.output_bytes`` is the bytes of the
  step's results made during the step.
- The port has no SPMD partitioner, so the per-device cost, temp and
  output bytes are the global counts divided by the mesh size
  (``"per_device": "even_split"``); on a 1x1 mesh they are exact. The
  global counts are kept under ``cost_global`` and ``memory_global``.
- There is no HLO and so no ``parse_collectives``: ``collectives`` is
  ``{"wire_bytes": None, "reason": ...}`` and the roofline's collective
  term is None (``roofline.terms``).
- ``lower_s`` is the seconds to build the meta LM and inputs, ``trace_s``
  the traced step's; nothing is compiled (``compile_s`` is None).

The default ``attn_impl`` is ``"blockwise"``, as in the reference, so no
kernel of the port is on the default path; ``--override
'{"attn_impl":"flash"}'`` traces the served prefill through
``flash_attention``'s operator (its fake kernel on meta).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, get_config
from ..models.config import SHAPES, ModelConfig, ShapeConfig, shape_applicable
from ..models.model import LM, param_shapes, param_specs
from ..models.sharding import shard_shape, tp_size
from ..optim import adamw
from . import roofline, specs as specs_mod, steps
from .mesh import LogicalMesh, make_production_mesh

NO_COLLECTIVES = ("the port has no compiled HLO to read collectives from "
                  "and no SPMD partitioner to insert them; counted in a "
                  "multi-GPU round")


# ------------------------------------------------------------ arguments
def _tree_bytes(shapes: Any, specs: Any, mesh: Any) -> int:
    """Per-device bytes of a tree of (shape, dtype) leaves laid out by the
    matching tree of specs."""
    if isinstance(shapes, dict):
        return sum(_tree_bytes(shapes[k], specs[k], mesh) for k in shapes)
    shape, dtype = shapes
    return math.prod(shard_shape(tuple(shape), specs, mesh)) * dtype.itemsize


def _meta(shapes: Any) -> Any:
    if isinstance(shapes, dict):
        return {k: _meta(v) for k, v in shapes.items()}
    shape, dtype = shapes
    return torch.empty(shape, dtype=dtype, device="meta")


def cell_arguments(cfg: ModelConfig, shape: ShapeConfig, mesh: Any
                   ) -> Dict[str, Tuple[Any, Any]]:
    """The step's argument groups as ``{name: (shapes, specs)}``: params,
    and opt + batch (train), batch (prefill), or cache + tokens + t
    (decode). Shapes are (shape, dtype) pairs, specs the mesh's."""
    tp = tp_size(mesh)
    pshapes = param_shapes(cfg, tp)
    pspecs = param_specs(cfg, mesh)
    out = {"params": (pshapes, pspecs)}
    if shape.kind == "train":
        out["opt"] = (adamw.state_shapes(pshapes),
                      adamw.state_specs(pspecs, pshapes, mesh,
                                        zero1=cfg.zero1))
        out["batch"] = specs_mod.train_batch_specs(cfg, shape, mesh)
    elif shape.kind == "prefill":
        out["batch"] = specs_mod.prefill_inputs(cfg, shape, mesh)
    else:
        lm = LM(cfg, "meta", tp=tp)
        cache, tok, t = specs_mod.decode_inputs(lm, shape, mesh)
        out.update(cache=cache, tokens=tok, t=t)
    return out


def argument_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh: Any) -> int:
    """Exact per-device bytes of the step's arguments, from specs alone."""
    return sum(_tree_bytes(s, sp, mesh)
               for s, sp in cell_arguments(cfg, shape, mesh).values())


# ---------------------------------------------------------------- trace
def _tensors(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)
        elif isinstance(x, dict):
            yield from _tensors(x.values())


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _moves_bytes(func) -> Tuple[bool, bool]:
    """(reads its inputs, writes its outputs) for an aten op: a view (every
    returned tensor aliases an input and none is written, as ``view``,
    ``detach``, ``alias``) moves nothing; ``empty*`` writes nothing."""
    rets = func._schema.returns
    view = bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)
    return not view, not view and not func.__name__.startswith("empty")


class _Traffic(TorchDispatchMode):
    """Bytes each aten op reads and writes, and the live bytes of storages
    made while the mode is on.

    ``bytes`` sums each op's tensor inputs and outputs (numel x item
    size); views count 0, and an ``empty`` allocation counts 0 for its
    output. ``live`` is the bytes of storages made under the mode and
    still alive (a storage's bytes are added when an op first returns it
    and removed when it is freed); ``peak`` its maximum. Storages alive
    before the mode (the arguments) are not counted."""

    def __init__(self, known: Any = ()):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._moves: Dict[Any, Tuple[bool, bool]] = {}
        self._seen = {t.untyped_storage()._cdata for t in _tensors([known])}

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        moves = self._moves.get(func)
        if moves is None:
            moves = self._moves[func] = _moves_bytes(func)
        outs = list(_tensors([out]))
        if moves[0]:
            self.bytes += _nbytes(_tensors(args)) + _nbytes(
                _tensors(kwargs.values()))
        if moves[1]:
            self.bytes += _nbytes(outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            self._seen.add(key)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n).atexit = False
        return out


def trace_step(fn, *args, known: Any = ()) -> Dict[str, Any]:
    """Run ``fn(*args)`` under ``FlopCounterMode`` and :class:`_Traffic`
    and return its global counts: flops, bytes accessed, the peak live
    bytes made during the call (``temp_bytes``), the bytes of the results
    made during the call (``output_bytes``) and the seconds.
    ``known`` holds tensors that exist before the call (the arguments)."""
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, _Traffic((args, known)) as tr:
        out = fn(*args)
    secs = time.perf_counter() - t0
    before = {t.untyped_storage()._cdata for t in _tensors([args, known])}
    outputs = {}
    for t in _tensors([out]):
        st = t.untyped_storage()
        if st._cdata not in before:
            outputs[st._cdata] = st.nbytes()
    return {"flops": int(fc.get_total_flops()), "bytes_accessed": tr.bytes,
            "temp_bytes": tr.peak, "output_bytes": sum(outputs.values()),
            "seconds": secs}


def _step(lm: LM, shape: ShapeConfig, args: Dict[str, Any]):
    """The step of ``shape.kind`` and its arguments, from meta tensors."""
    if shape.kind == "train":
        return steps.make_train_step(lm), (args["opt"], args["batch"])
    if shape.kind == "prefill":
        return steps.make_prefill_step(lm), (args["batch"],)
    # decode at position seq_len: the cache holds seq_len context
    return steps.make_decode_step(lm), (args["cache"], args["tokens"],
                                        shape.seq_len)


# ----------------------------------------------------------------- cells
def _resolve(arch: str, shape: Union[str, ShapeConfig],
             overrides: Optional[Dict[str, Any]]
             ) -> Tuple[ModelConfig, ShapeConfig]:
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg, shape if isinstance(shape, ShapeConfig) else SHAPES[shape]


def run_cell(arch: str, shape: Union[str, ShapeConfig], multi_pod: bool,
             overrides: Optional[Dict[str, Any]] = None, *,
             mesh: Optional[LogicalMesh] = None) -> Dict[str, Any]:
    """One cell's record. ``shape`` is a name of ``SHAPES`` or a
    ``ShapeConfig`` (a cell cut to size); ``overrides`` are
    ``ModelConfig`` fields; ``mesh`` replaces the production mesh that
    ``multi_pod`` picks."""
    cfg, shp = _resolve(arch, shape, overrides)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    rec: Dict[str, Any] = {"arch": arch, "shape": shp.name,
                           "mesh": mesh.name, "kind": shp.kind}
    ok, why = shape_applicable(cfg, shp)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec
    n_chips = mesh.size
    t0 = time.perf_counter()
    groups = cell_arguments(cfg, shp, mesh)
    arg_bytes = sum(_tree_bytes(s, sp, mesh) for s, sp in groups.values())
    lm = LM(cfg, "meta", tp=tp_size(mesh))
    args = {k: _meta(s) for k, (s, _) in groups.items() if k != "params"}
    if shp.kind == "train":
        args["opt"] = adamw.init(dict(lm.named_parameters()))
    fn, fargs = _step(lm, shp, args)
    rec["lower_s"] = time.perf_counter() - t0
    counts = trace_step(fn, *fargs, known=(lm.state_dict(), args))
    rec["trace_s"] = counts["seconds"]
    rec["compile_s"] = None
    flops = counts["flops"] / n_chips
    bytes_ = counts["bytes_accessed"] / n_chips
    rec["memory"] = {
        "argument_bytes": arg_bytes,
        "output_bytes": counts["output_bytes"] / n_chips,
        "temp_bytes": counts["temp_bytes"] / n_chips,
        "code_bytes": 0,
        "per_device": {"argument_bytes": "exact",
                       "output_bytes": "even_split",
                       "temp_bytes": "even_split"},
    }
    rec["memory"]["total_bytes"] = (rec["memory"]["argument_bytes"]
                                    + rec["memory"]["temp_bytes"])
    rec["memory_global"] = {"temp_bytes": counts["temp_bytes"],
                            "output_bytes": counts["output_bytes"]}
    rec["cost"] = {"flops": flops, "bytes_accessed": bytes_,
                   "per_device": "even_split"}
    rec["cost_global"] = {"flops": counts["flops"],
                          "bytes_accessed": counts["bytes_accessed"]}
    rec["collectives"] = {"wire_bytes": None, "reason": NO_COLLECTIVES}
    tokens = shp.global_batch * (shp.seq_len if shp.kind != "decode" else 1)
    mf = roofline.model_flops(cfg, shp.kind, tokens)
    rec["roofline"] = roofline.terms(flops, bytes_, None)
    rec["model_flops_global"] = mf
    rec["model_flops_per_chip"] = mf / n_chips
    if flops:
        rec["useful_flop_ratio"] = (mf / n_chips) / flops
    rec["status"] = "ok"
    return rec


def run_cell_with_probes(arch: str, shape: Union[str, ShapeConfig],
                         multi_pod: bool,
                         overrides: Optional[Dict[str, Any]] = None, *,
                         mesh: Optional[LogicalMesh] = None,
                         ) -> Dict[str, Any]:
    """The full-depth cell plus two shallow probes (L=1, L=2), as the
    reference runs them: ``cost_corrected = probe(1) + (L-1) * (probe(2) -
    probe(1))``. The reference needs the correction because XLA counts a
    scanned layer once; the port's eager trace counts every layer, so
    here the correction must equal the direct count (to 1e-9 relative):
    a self-check of the count's linearity in depth. A mismatch raises
    ``ValueError``."""
    rec = run_cell(arch, shape, multi_pod, overrides, mesh=mesh)
    if rec.get("status") != "ok":
        return rec
    cfg, _ = _resolve(arch, shape, overrides)
    L = cfg.n_layers
    probes = {}
    for depth in (1, 2):
        po = dict(overrides or {})
        po.update(n_layers=depth, scan_layers=False)
        probes[depth] = run_cell(arch, shape, multi_pod, po, mesh=mesh)

    def corrected(get):
        v1, v2 = get(probes[1]), get(probes[2])
        return v1 + (L - 1) * (v2 - v1)

    flops = corrected(lambda r: r["cost"]["flops"])
    bytes_ = corrected(lambda r: r["cost"]["bytes_accessed"])
    rec["cost_corrected"] = {
        "flops": flops, "bytes_accessed": bytes_, "wire_bytes": None,
        "per_layer_flops": (probes[2]["cost"]["flops"]
                            - probes[1]["cost"]["flops"]),
    }
    for key, got in (("flops", flops), ("bytes_accessed", bytes_)):
        want = rec["cost"][key]
        if abs(got - want) > 1e-9 * max(abs(want), 1.0):
            raise ValueError(f"{rec['arch']}/{rec['shape']}/{rec['mesh']}: "
                             f"probe-corrected {key} {got} differs from the "
                             f"direct count {want}")
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--override", default=None,
                    help="JSON dict of ModelConfig overrides (perf exps)")
    ap.add_argument("--no-probes", action="store_true",
                    help="skip the L=1/L=2 probes (a self-check here)")
    args = ap.parse_args(argv)

    archs = ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    overrides = json.loads(args.override) if args.override else None

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh = make_production_mesh(multi_pod=mp)
                key = f"{arch}/{shape}/{mesh.name}"
                t0 = time.perf_counter()
                try:
                    # probes only on the single-pod mesh, as the reference
                    if mp or args.no_probes:
                        rec = run_cell(arch, shape, mp, overrides)
                    else:
                        rec = run_cell_with_probes(arch, shape, mp,
                                                   overrides)
                except Exception as e:  # one cell's failure is its record
                    rec = {"arch": arch, "shape": shape, "mesh": mesh.name,
                           "status": "error", "error": str(e)[:500],
                           "trace": traceback.format_exc()[-2000:]}
                rec["wall_s"] = round(time.perf_counter() - t0, 1)
                if overrides:
                    rec["overrides"] = overrides
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                print(f"[{rec.get('status'):7s}] {key} "
                      f"({rec['wall_s']}s)", flush=True)


if __name__ == "__main__":
    main()
