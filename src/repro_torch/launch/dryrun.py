"""Dry run of every (arch x shape x mesh) cell on the meta device (the
port's counterpart of the JAX package's ``launch/dryrun.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_34b \
        --shape train_4k --mesh pod --out results/dryrun.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # every cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2_370m \
        --shape decode_32k --mesh multipod --multipod-probes

Each cell is one JSON record with the reference's keys (memory, cost,
collectives, roofline, model FLOPs), appended to the JSONL. The dry run
needs no GPU and touches no device memory on any machine: the LM, its
optimizer state and the step's inputs are meta tensors (``LM(cfg, "meta",
tp=...)``), and the step functions are ``launch/steps.py``'s, run eagerly
on them. Where the reference lowers and compiles for 512 forced host
devices, the port reads the mesh's shape (``launch.mesh.LogicalMesh``)
for the global trace, and runs the step as a sharded program for the
per-device one: DTensors laid out by the reference's specs on a
``DeviceMesh`` over torch's fake process group (``launch.mesh.fake_world``
and ``device_mesh``), one process holding rank 0 of 256 or 512.

What a record holds, and how it differs from the reference's:

- ``memory.argument_bytes`` is exact per device: each argument leaf (the
  parameters; for training the AdamW state, m and v in f32 and the step;
  the batch; for decode the cache, the tokens and the position) counted
  at its shard shape on the mesh (``models.sharding.shard_shape`` of the
  leaf's spec) times its item size. No tracing is needed for it
  (:func:`cell_arguments`).
- The step is traced once at global shapes with the config as given.
  ``cost.flops`` comes from ``torch.utils.flop_counter.FlopCounterMode``,
  which counts matrix products (and ``flash_attention`` and ``ssd_scan``,
  by their registered formulas) only, where XLA's ``cost_analysis`` counts
  elementwise work too: ``useful_flop_ratio`` is not comparable with the
  reference's. ``cost.bytes_accessed`` sums each aten op's tensor inputs
  and outputs (a view or an alias counts 0, and an ``empty`` allocation
  writes nothing): the traffic of the eager, unfused program the port runs,
  not of a fused XLA program. ``memory.temp_bytes`` is the peak of the
  bytes of storages made during the step and alive at once: the live
  bytes above the arguments. ``memory.output_bytes`` is the bytes of the
  step's results made during the step.
- Per device: :func:`run_cell_with_probes` (the CLI's default on the pod
  mesh) traces the L=1 and L=2 probes partitioned (:func:`trace_partitioned`:
  rank 0's local program, counted by dispatch modes that see the local
  ops under DTensor and the ``_c10d_functional`` collectives it issues,
  :class:`CollectiveCounter`) and extrapolates them to the full depth, as
  the reference corrects its compiled probes: cost, temp and output
  bytes ``"partitioned"``, and ``collectives`` with the reference's keys
  (``wire_bytes``, ``count``, ``by_kind``, ``top``) feeding the roofline's
  collective term. :func:`run_cell` alone (and ``--no-probes``) keeps the
  global counts divided by the mesh size (``"per_device":
  "even_split"``, exact on 1x1) and no collectives
  (``NO_COLLECTIVES``), for every cell. The MoE cells are partitioned
  as the others are: expert parallelism over "model", each rank routing
  its rows' groups (``models.layers._moe_sharded``). The global counts
  are kept under ``cost_global`` and ``memory_global``.
- ``lower_s`` is the seconds to build the meta LM and inputs, ``trace_s``
  the traced step's; nothing is compiled (``compile_s`` is None).

The default ``attn_impl`` is ``"blockwise"``, as in the reference, so the
attention kernel is off the default path; ``--override
'{"attn_impl":"flash"}'`` traces the served prefill through
``flash_attention``'s operator (its fake kernel on meta). An SSM's prefill
SSD takes the route it takes on the card (``models.layers.ssd_route``):
``ssd_scan``'s operator where the step records no autograd graph on plain
tensors, ``ssd_chunked`` in training and on the partitioned (DTensor)
trace.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import time
import traceback
import weakref
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, _FlopCounterMode

from ..configs import ARCHS, get_config
from ..models.config import SHAPES, ModelConfig, ShapeConfig, shape_applicable
from ..models.model import LM, param_shapes, param_specs
from ..models.sharding import shard_shape, tp_size
from ..optim import adamw
from . import roofline, specs as specs_mod, steps
from .mesh import (LogicalMesh, device_mesh, fake_world,
                   make_production_mesh)

NO_COLLECTIVES = ("an even split of the global trace: collectives are "
                  "counted by the partitioned probes "
                  "(run_cell_with_probes) only")


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
                      steps.opt_state_specs(cfg, mesh))
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


# ---------------------------------------------------- partitioned trace
# the collectives DTensor issues on each rank's local tensors, by the
# reference's kind names (a broadcast sends its output once, as a permute)
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}


def _collective_kind(func) -> Optional[str]:
    if func.namespace not in ("_c10d_functional", "_dtensor"):
        return None
    return _COLLECTIVES.get(func._schema.name.split("::")[-1])


def _group_size(args) -> int:
    """The group size of a functional collective: from its group (a name
    or a ``ProcessGroup``), the last argument of every one of them."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    group = args[-1]
    if isinstance(group, str):
        group = _resolve_process_group(group)
    return group.size()


def _propagating() -> bool:
    """Whether DTensor's sharding propagation is running an op on fake
    tensors (global shapes): a fake mode is on the stack."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def _on(device_type: str, args, kwargs) -> bool:
    """Whether an op touches the program's device: a tensor argument
    there, or a ``device`` keyword naming it."""
    dev = kwargs.get("device")
    if dev is not None and torch.device(dev).type == device_type:
        return True
    return any(t.device.type == device_type
               for t in _tensors([args, list(kwargs.values())]))


class _LocalOnly:
    """A dispatch mode that sees each rank's local program only, on the
    device ``device_type``: a call on DTensors is passed on to DTensor
    (``NotImplemented``), whose local ops then reach the mode. Ops that
    are not the program's run uncounted: those on fake tensors or that
    DTensor's sharding propagation runs on them, and DTensor's own shard
    arithmetic on small host tensors (off ``device_type``)."""
    device_type = "meta"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if types or _propagating() or not _on(self.device_type, args,
                                              kwargs):
            return func(*args, **kwargs)
        return self._local(func, types, args, kwargs)

    def _local(self, func, types, args, kwargs):
        return super().__torch_dispatch__(func, types, args, kwargs)


class _LocalTraffic(_LocalOnly, _Traffic):
    """:class:`_Traffic` over each rank's local program."""


class _LocalFlopMode(_LocalOnly, _FlopCounterMode):
    pass


class _LocalFlops(FlopCounterMode):
    """``FlopCounterMode`` over each rank's local program on
    ``device_type``."""

    def __init__(self, device_type: str):
        super().__init__(display=False)
        self.device_type = device_type

    def __enter__(self):
        self.flop_counts.clear()
        self.mod_tracker.__enter__()
        self.mode = _LocalFlopMode(self)
        self.mode.device_type = self.device_type
        self.mode.__enter__()
        return self


class CollectiveCounter(_LocalOnly, TorchDispatchMode):
    """The collectives of each rank's local program, as DTensor issues
    them (``_c10d_functional`` ops, and ``_dtensor.shard_dim_alltoall``):
    each op's kind, group size (from its group) and output bytes, costed
    by ``roofline.wire_bytes``. ``stats()`` gives the reference's
    ``CollectiveStats``, with the six largest ops in ``top``."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def _local(self, func, types, args, kwargs):
        out = func(*args, **kwargs)
        kind = _collective_kind(func)
        if kind is None:
            return out
        g = _group_size(args)
        size = _nbytes(_tensors([out]))
        shape = next(iter(_tensors([out])))
        label = (f"{kind} g={g} {str(shape.dtype).replace('torch.', '')}"
                 f"{list(shape.shape)}")
        self.ops.append((label, kind, roofline.wire_bytes(kind, size, g)))
        return out

    def stats(self) -> roofline.CollectiveStats:
        st = roofline.CollectiveStats()
        for _, kind, wire in self.ops:
            st.wire_bytes += wire
            st.by_kind[kind] = st.by_kind.get(kind, 0.0) + wire
            st.count += 1
        st.top = sorted(((lab, w) for lab, _, w in self.ops),
                        key=lambda t: -t[1])[:6]
        return st


_PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the DTensor modules whose frames name who asked for a collective: an
# op's own sharding propagation (``_dispatch``), or the explicit API
_PROPAGATION = os.path.join("distributed", "tensor", "_dispatch.py")
_ENGINE = os.path.join("autograd", "graph.py")
_EXPLICIT = {os.path.join("distributed", "tensor", "_api.py"): "redistribute",
             os.path.join("distributed", "tensor", "experimental",
                          "_func_map.py"): "local_map"}


def _port_site(lines, depth: int = 2) -> Optional[str]:
    """The innermost ``depth`` frames under the port's package (this
    module's own aside) among traceback entries
    (``traceback.FrameSummary``), innermost first, as ``file:line``
    relative to the package's parent (``repro_torch/...``) joined by
    ``" < "``."""
    out = []
    for fr in reversed(lines):
        if fr.filename.startswith(_PORT + os.sep) and \
                fr.filename != os.path.abspath(__file__):
            rel = os.path.relpath(fr.filename, os.path.dirname(_PORT))
            out.append(f"{rel}:{fr.lineno}")
            if len(out) == depth:
                break
    return " < ".join(out) or None


class CollectiveRecorder(CollectiveCounter):
    """:class:`CollectiveCounter` that also records, with each op, who
    issued it: ``site``, the two innermost frames in the port (file:line;
    for an op of DTensor's own backward, which runs no frame of the port,
    the forward frames of the autograd node being run, which needs
    ``torch.autograd.set_detect_anomaly``, as :func:`record_collectives`
    sets), ``phase`` (``"forward"`` or the backward node's name: a
    remat recomputation runs under the node that unpacks its result) and
    ``by``: ``"propagation"`` where DTensor's sharding propagation relaid
    an op's input out, ``"redistribute"`` or ``"local_map"`` where the
    port's explicit call did, ``"autograd"`` where the backward of such a
    call did. ``records`` holds (label, kind, wire bytes, site, phase,
    by) per op."""

    def __init__(self):
        super().__init__()
        self.records = []

    def _local(self, func, types, args, kwargs):
        n = len(self.ops)
        out = super()._local(func, types, args, kwargs)
        if len(self.ops) > n:
            self.records.append(self.ops[-1] + self._who())
        return out

    @staticmethod
    def _who() -> Tuple[Optional[str], str, str]:
        stack = traceback.extract_stack()
        by = "autograd"
        for fr in reversed(stack):
            if fr.filename.endswith(_PROPAGATION):
                by = "propagation"
                break
            hit = next((v for k, v in _EXPLICIT.items()
                        if fr.filename.endswith(k)), None)
            if hit is not None:
                by = hit
                break
        node = torch._C._current_autograd_node()
        if node is None:
            return _port_site(stack), "forward", by
        # the frames the autograd engine runs (a backward of the port's, a
        # remat recomputation), not the one that called backward()
        engine = max((i for i, fr in enumerate(stack)
                      if fr.filename.endswith(_ENGINE)), default=-1)
        site = _port_site(stack[engine + 1:])
        if site is None:
            # DTensor's own backward (of a redistribute, a local map, an
            # op): where the port ran the node's forward
            site = _port_site(_parse_traceback(
                node.metadata.get("traceback_") or []))
        return site, node.name(), by


def _parse_traceback(tb) -> list:
    """Frames (filename, lineno) from the formatted forward traceback that
    anomaly mode keeps on an autograd node."""
    frames = []
    for chunk in tb:
        for m in re.finditer(r'File "([^"]+)", line (\d+)', chunk):
            frames.append(traceback.FrameSummary(m.group(1),
                                                 int(m.group(2)), ""))
    return frames


def local_shards(xs):
    """A tree with every DTensor replaced by its local shard."""
    from torch.distributed.tensor import DTensor
    if isinstance(xs, DTensor):
        return xs._local_tensor
    if isinstance(xs, dict):
        return {k: local_shards(v) for k, v in xs.items()}
    if isinstance(xs, (list, tuple)):
        return [local_shards(v) for v in xs]
    return xs


def trace_local(fn, *args, known: Any = (), device_type: str = "meta",
                counter: Optional[CollectiveCounter] = None
                ) -> Dict[str, Any]:
    """:func:`trace_step` over each rank's local program of a DTensor
    step whose local shards live on ``device_type``: flops (and by
    operator, ``"flops_by_op"``), bytes accessed, temp and output bytes
    of rank 0's shards, and its collectives (``"collectives"``, a
    ``CollectiveStats``). Values computed over the fake process group
    mean nothing; these counts depend on shapes only."""
    from torch.distributed.tensor.experimental import implicit_replication
    known_local = local_shards((args, known))
    fc = _LocalFlops(device_type)
    tr, cc = _LocalTraffic(known_local), counter or CollectiveCounter()
    tr.device_type = cc.device_type = device_type
    t0 = time.perf_counter()
    with implicit_replication(), fc, tr, cc:
        out = fn(*args)
    secs = time.perf_counter() - t0
    before = {t.untyped_storage()._cdata for t in _tensors([known_local])}
    outputs = {}
    for t in _tensors([local_shards(out)]):
        st = t.untyped_storage()
        if st._cdata not in before:
            outputs[st._cdata] = st.nbytes()
    by_op = {str(op): int(n) for op, n in
             fc.get_flop_counts().get("Global", {}).items()}
    return {"flops": int(fc.get_total_flops()), "bytes_accessed": tr.bytes,
            "temp_bytes": tr.peak, "output_bytes": sum(outputs.values()),
            "collectives": cc.stats(), "flops_by_op": by_op,
            "seconds": secs}


def partitioned_cell(cfg: ModelConfig, shape: ShapeConfig,
                     mesh: LogicalMesh, device: Any = "meta",
                     init: Optional[torch.Generator] = None,
                     ) -> Tuple[Any, Any, Any, Dict[str, Any]]:
    """The partitioned step of a cell, ready to run inside
    ``fake_world(mesh.size)``: ``(lm, fn, fargs, args)``, the LM built on
    a ``DeviceMesh`` of ``mesh`` with its local shards on ``device`` and
    the step's arguments as DTensors laid out by the reference's specs.
    The mesh's device type is cuda for the meta device (DTensor then
    issues the collectives NCCL would, all-to-all included, where a cpu
    mesh swaps an all-to-all for an all-gather) and the device's own
    otherwise. ``init`` (a generator on ``device``) draws the parameters'
    local shards as ``LM.init`` draws them; otherwise they stay
    uninitialised."""
    dev = torch.device(device)
    dm = device_mesh(mesh, "cuda" if dev.type == "meta" else dev.type)
    lm = LM(cfg, device, mesh=dm)
    if init is not None:
        lm.init(init)
    groups = cell_arguments(cfg, shape, mesh)
    # zeros, so integer inputs index in range on a real device; the ring
    # positions 2**30, the cache's never-written mark
    args = {k: lm.sharded_zeros(s, sp) for k, (s, sp) in groups.items()
            if k not in ("params", "t")}
    if "cache" in args and "pos" in args["cache"]:
        args["cache"]["pos"]._local_tensor.fill_(2 ** 30)
    fn, fargs = _step(lm, shape, args)
    return lm, fn, fargs, args


def trace_partitioned(cfg: ModelConfig, shape: ShapeConfig,
                      mesh: LogicalMesh) -> Dict[str, Any]:
    """Rank 0's local program of the cell's step on ``mesh``, on the meta
    device, over a fake world of ``mesh.size`` ranks: per-device flops,
    bytes accessed, temp and output bytes, and the collectives
    (:func:`trace_local`)."""
    with fake_world(mesh.size):
        lm, fn, fargs, args = partitioned_cell(cfg, shape, mesh)
        return trace_local(fn, *fargs, known=(dict(lm.named_parameters()),
                                              args))


def record_collectives(cfg: ModelConfig, shape: ShapeConfig,
                       mesh: LogicalMesh) -> CollectiveRecorder:
    """:func:`trace_partitioned`'s collectives with who issued each
    (:class:`CollectiveRecorder`), under anomaly mode so that an op of the
    backward names its forward site."""
    rec = CollectiveRecorder()
    with fake_world(mesh.size), torch.autograd.set_detect_anomaly(
            True, check_nan=False):
        lm, fn, fargs, args = partitioned_cell(cfg, shape, mesh)
        trace_local(fn, *fargs, known=(dict(lm.named_parameters()), args),
                    counter=rec)
    return rec


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


def _extrapolate(v1: Any, v2: Any, L: int) -> Any:
    """``v1 + (L-1) * (v2 - v1)``, per key for dicts."""
    if isinstance(v1, dict):
        return {k: _extrapolate(v1.get(k, 0), v2.get(k, 0), L)
                for k in {**v1, **v2}}
    return v1 + (L - 1) * (v2 - v1)


def run_cell_with_probes(arch: str, shape: Union[str, ShapeConfig],
                         multi_pod: bool,
                         overrides: Optional[Dict[str, Any]] = None, *,
                         mesh: Optional[LogicalMesh] = None,
                         ) -> Dict[str, Any]:
    """The full-depth cell plus shallow probes (L=1, L=2), as the
    reference runs them: ``v(L) = probe(1) + (L-1) * (probe(2) -
    probe(1))``.

    - The full-depth trace (:func:`run_cell`) gives the global counts
      (``cost_global``, ``memory_global``). Unpartitioned probes check
      them: the port's eager trace counts every layer (XLA counts a
      scanned layer once, hence the reference's correction), so the
      extrapolated global FLOPs and bytes must equal the direct count to
      1e-9 relative, or ``ValueError`` is raised.
    - The probes that the record keeps run partitioned
      (:func:`trace_partitioned`, rank 0's local program on ``mesh``), as
      the reference's compile partitioned ones: ``cost_corrected`` holds
      the extrapolated per-device ``flops``, ``bytes_accessed`` and
      ``wire_bytes``, and ``cost``, ``memory``'s temp and output bytes,
      ``collectives`` (count and ``by_kind`` extrapolated; ``top`` the
      L=2 probe's) and ``roofline`` take them, marked ``"partitioned"``,
      for every cell, the MoE cells included."""
    rec = run_cell(arch, shape, multi_pod, overrides, mesh=mesh)
    if rec.get("status") != "ok":
        return rec
    cfg, shp = _resolve(arch, shape, overrides)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    L = cfg.n_layers
    probes = {}
    for depth in (1, 2):
        po = dict(overrides or {})
        po.update(n_layers=depth, scan_layers=False)
        probes[depth] = run_cell(arch, shape, multi_pod, po, mesh=mesh)
    for key in ("flops", "bytes_accessed"):
        got = _extrapolate(probes[1]["cost_global"][key],
                           probes[2]["cost_global"][key], L)
        want = rec["cost_global"][key]
        if abs(got - want) > 1e-9 * max(abs(want), 1.0):
            raise ValueError(f"{rec['arch']}/{rec['shape']}/{rec['mesh']}: "
                             f"probe-corrected {key} {got} differs from the "
                             f"direct count {want}")
    part = _partitioned_probes(cfg, shp, mesh)
    ext = {k: _extrapolate(part[1][k], part[2][k], L)
           for k in ("flops", "bytes_accessed", "temp_bytes",
                     "output_bytes")}
    st = {d: part[d]["collectives"] for d in (1, 2)}
    wire = _extrapolate(st[1].wire_bytes, st[2].wire_bytes, L)
    rec["trace_s"] += sum(part[d]["seconds"] for d in (1, 2))
    rec["cost"] = {"flops": ext["flops"],
                   "bytes_accessed": ext["bytes_accessed"],
                   "per_device": "partitioned"}
    mem = rec["memory"]
    mem["temp_bytes"] = ext["temp_bytes"]
    mem["output_bytes"] = ext["output_bytes"]
    mem["total_bytes"] = mem["argument_bytes"] + mem["temp_bytes"]
    mem["per_device"] = {"argument_bytes": "exact",
                         "output_bytes": "partitioned",
                         "temp_bytes": "partitioned"}
    rec["collectives"] = dict(_probed_collectives(part, L),
                              top=st[2].top[:6])
    rec["cost_corrected"] = {
        "flops": ext["flops"], "bytes_accessed": ext["bytes_accessed"],
        "wire_bytes": wire,
        "per_layer_flops": part[2]["flops"] - part[1]["flops"]}
    rec["roofline"] = roofline.terms(ext["flops"], ext["bytes_accessed"],
                                     wire)
    if ext["flops"]:
        rec["useful_flop_ratio"] = rec["model_flops_per_chip"] / ext["flops"]
    return rec


def _write_sites(arch: str, shape: str, mesh: LogicalMesh,
                 overrides: Optional[Dict[str, Any]], out: str) -> None:
    """``--sites``: one JSONL record per probe depth (L=1, L=2) of a cell,
    its collectives by call site (:func:`record_collectives`), with the
    torch version that partitioned it."""
    cfg, shp = _resolve(arch, shape, overrides)
    ok, why = shape_applicable(cfg, shp)
    for depth in (1, 2) if ok else ():
        t0 = time.perf_counter()
        rec = record_collectives(cfg.replace(n_layers=depth,
                                             scan_layers=False), shp, mesh)
        row = {"arch": arch, "shape": shape, "mesh": mesh.name,
               "n_layers": depth, "torch": torch.__version__,
               "wire_bytes": sum(r[2] for r in rec.records),
               "count": len(rec.records),
               "ops": [dict(zip(("label", "kind", "wire_bytes", "site",
                                 "phase", "by"), r)) for r in rec.records]}
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(f"[sites] {arch}/{shape}/{mesh.name} L={depth}: "
              f"{row['count']} ops, {row['wire_bytes']:.0f} wire bytes, "
              f"{sum(r[5] == 'propagation' for r in rec.records)} by "
              f"propagation ({time.perf_counter() - t0:.1f}s)", flush=True)


def _partitioned_probes(cfg: ModelConfig, shp: ShapeConfig,
                        mesh: LogicalMesh) -> Dict[int, Dict[str, Any]]:
    """:func:`trace_partitioned` of the L=1 and L=2 probes."""
    return {d: trace_partitioned(cfg.replace(n_layers=d, scan_layers=False),
                                 shp, mesh) for d in (1, 2)}


def _probed_collectives(part: Dict[int, Dict[str, Any]], L: int
                        ) -> Dict[str, Any]:
    """The probes' collectives extrapolated to depth ``L``: wire bytes,
    op count and wire bytes by kind."""
    st = {d: part[d]["collectives"] for d in (1, 2)}
    return {"wire_bytes": _extrapolate(st[1].wire_bytes, st[2].wire_bytes,
                                       L),
            "count": _extrapolate(st[1].count, st[2].count, L),
            "by_kind": _extrapolate(st[1].by_kind, st[2].by_kind, L)}


# the multi-pod cells probed besides every pod cell: the reference's own
# slow cell
PROBED_MULTIPOD = (("mamba2_370m", "decode_32k"),)
# the processes that share ``--counts``'s cells (each traces on the meta
# device: little memory, one core)
COUNTS_WORKERS = min(6, os.cpu_count() or 1)
COUNTS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "collective_counts.json")


def probed_cells() -> list:
    """(arch, shape, multi_pod) of every probed cell that applies: each
    pod cell, and the multi-pod cells of ``PROBED_MULTIPOD``."""
    cells = [(a, s, False) for a in ARCHS for s in SHAPES]
    cells += [(a, s, True) for a, s in PROBED_MULTIPOD]
    return [c for c in cells
            if shape_applicable(get_config(c[0]), SHAPES[c[1]])[0]]


def cell_key(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}/{shape}/{make_production_mesh(multi_pod=multi_pod).name}"


def collective_counts(arch: str, shape: str, multi_pod: bool
                      ) -> Dict[str, Any]:
    """The collectives of a probed cell as :func:`run_cell_with_probes`
    records them (wire bytes, count, by kind), from the partitioned
    probes alone."""
    cfg, shp = _resolve(arch, shape, None)
    mesh = make_production_mesh(multi_pod=multi_pod)
    return _probed_collectives(_partitioned_probes(cfg, shp, mesh),
                               cfg.n_layers)


def _counts_of(cell) -> Tuple[str, Dict[str, Any]]:
    return cell_key(*cell), collective_counts(*cell)


def write_counts(path: str) -> Dict[str, Any]:
    """``--counts``: every probed cell's collectives (:func:`probed_cells`,
    :func:`collective_counts`) in one JSON file, with the torch version
    that partitioned them. ``COUNTS_WORKERS`` spawned processes share the
    cells."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(COUNTS_WORKERS, mp_context=multiprocessing
                             .get_context("spawn")) as ex:
        rows = list(ex.map(_counts_of, probed_cells()))
    out = {"torch": torch.__version__,
           "command": "PYTHONPATH=src python -m repro_torch.launch.dryrun "
                      "--counts " + os.path.relpath(path),
           "cells": dict(sorted(rows))}
    with open(path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    return out


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
                    help="skip the L=1/L=2 probes (even split, no "
                         "collectives)")
    ap.add_argument("--multipod-probes", action="store_true",
                    help="probe the 2x16x16 cells too (the reference "
                         "probes the pod mesh only)")
    ap.add_argument("--counts", default=None, metavar="PATH",
                    help="write every probed cell's collectives (wire "
                         "bytes, count, by kind) to PATH as JSON and exit "
                         "(the committed file is " + os.path.relpath(
                             COUNTS_FILE) + ")")
    ap.add_argument("--sites", action="store_true",
                    help="record each collective of the L=1/L=2 probes "
                         "with its call site and issuer "
                         "(record_collectives), one JSON record a probe")
    args = ap.parse_args(argv)
    if args.counts:
        out = write_counts(args.counts)
        print(f"[counts] {len(out['cells'])} cells -> {args.counts}")
        return

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
                if args.sites:
                    _write_sites(arch, shape, mesh, overrides, args.out)
                    continue
                try:
                    # probes on the single-pod mesh, as the reference
                    if args.no_probes or (mp and not args.multipod_probes):
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
