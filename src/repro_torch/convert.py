"""Carry state between the JAX package and the port, by plain data only.

What crosses over for the mapper is the input DFG and the walk's packed
clause tensors; for the LM it is the parameter tree and the AdamW
state, as numpy arrays, in both directions. The
functions here are duck-typed — they read plain attributes and arrays and
never import ``repro`` — so the parity tests can feed the two packages
identical inputs, and a later slice can carry a corpus of DFGs across.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.dfg import DFG
from .core.sat.walksat_torch import PackedCNF, row_lengths
from .models.config import ModelConfig
from .models.model import param_shapes


def dfg_from_arrays(name: str, ops: Sequence[str], imms: Sequence[int],
                    edges: Sequence[Tuple[int, int, int, int]],
                    node_names: Optional[Sequence[str]] = None) -> DFG:
    """A port :class:`DFG` with nodes ``0..n-1`` (``ops[i]``, ``imms[i]``)
    and ``edges`` as ``(src, dst, slot, distance)``: input ``slot`` of node
    ``dst`` reads ``src`` from ``distance`` iterations earlier. Inputs are
    set once every node exists, so back-edges may point forward; the
    result passes ``DFG.validate``."""
    n = len(ops)
    if len(imms) != n or (node_names is not None and len(node_names) != n):
        raise ValueError("dfg_from_arrays: ops, imms and node_names differ "
                         "in length")
    ins = [dict() for _ in range(n)]
    for src, dst, slot, dist in edges:
        if not (0 <= src < n and 0 <= dst < n) or slot in ins[dst]:
            raise ValueError(f"dfg_from_arrays: bad edge {(src, dst, slot)}")
        ins[dst][slot] = (int(src), int(dist))
    g = DFG(name)
    for i in range(n):
        g.add(str(ops[i]), (), int(imms[i]),
              str(node_names[i]) if node_names is not None else "")
    for i in range(n):
        slots = sorted(ins[i])
        if slots != list(range(len(slots))):
            raise ValueError(f"dfg_from_arrays: node {i} has input slots "
                             f"{slots}, expected 0..{len(slots) - 1}")
        if any(d < 0 for _, d in ins[i].values()):
            raise ValueError(f"dfg_from_arrays: negative distance into {i}")
        g.nodes[i].ins = tuple(ins[i][s] for s in slots)
    g.touch()
    g.validate()
    return g


def dfg_from_graph(src) -> DFG:
    """Copy any DFG-shaped object (``.name`` and ``.nodes``, a dict of
    nodes with ``.id``, ``.op``, ``.ins``, ``.imm``, ``.name``) into a port
    :class:`DFG` through :func:`dfg_from_arrays`."""
    nodes = [src.nodes[i] for i in sorted(src.nodes)]
    if [nd.id for nd in nodes] != list(range(len(nodes))):
        raise ValueError("dfg_from_graph: node ids must be 0..n-1")
    edges = [(s, nd.id, slot, d) for nd in nodes
             for slot, (s, d) in enumerate(nd.ins)]
    return dfg_from_arrays(src.name, [nd.op for nd in nodes],
                           [nd.imm for nd in nodes], edges,
                           [nd.name for nd in nodes])


def window_from_numpy(pack, device) -> PackedCNF:
    """The port's :class:`PackedCNF` on ``device`` from a stacked numpy
    window pack (anything with ``cvars``/``csign`` [K,C,L], ``ovars``/
    ``osign`` [K,V+1,O], ``n_vars`` and ``n_clauses``, and optionally the
    row lengths ``clen`` [K,C], derived from ``cvars`` where missing)."""
    cvars = np.asarray(pack.cvars)
    ovars = np.asarray(pack.ovars)
    if cvars.ndim != 3 or ovars.ndim != 3 \
            or ovars.shape[1] != int(pack.n_vars) + 1 \
            or cvars.shape[1] != int(pack.n_clauses):
        raise ValueError(f"window_from_numpy: shapes cvars {cvars.shape}, "
                         f"ovars {ovars.shape} do not fit n_vars="
                         f"{pack.n_vars}, n_clauses={pack.n_clauses}")

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(device)

    # the row lengths; a pack of the JAX package has none, so derive them
    clen = getattr(pack, "clen", None)
    if clen is None:
        clen = row_lengths(cvars)
    return PackedCNF(t(cvars, np.int32), t(pack.csign, bool),
                     t(ovars, np.int32), t(pack.osign, bool),
                     int(pack.n_vars), int(pack.n_clauses),
                     t(clen, np.int32))


def assign_from_numpy(assign, packed: PackedCNF) -> torch.Tensor:
    """Chain assignments [K,B,V+1] bool on ``packed``'s device."""
    a = np.asarray(assign)
    if a.ndim != 3 or a.shape[0] != packed.cvars.shape[0] \
            or a.shape[2] != packed.n_vars + 1:
        raise ValueError(f"assign_from_numpy: shape {a.shape} does not fit "
                         f"a window of {packed.cvars.shape[0]} CNFs over "
                         f"{packed.n_vars} vars")
    return torch.from_numpy(np.array(a, bool)).to(
        packed.cvars.device)


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16, as JAX hands it
        return torch.from_numpy(np.array(a).view(np.uint16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def lm_params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig
                         ) -> Dict[str, torch.Tensor]:
    """The port's ``LM`` state dict from the JAX parameter tree of the
    same config, with every leaf a numpy array
    (``jax.tree.map(np.asarray, params)``), so that both packages compute
    the same function.

    The port keeps the JAX layout as it is: ``blocks.*`` stacked on a
    leading layer axis, ``embed`` [Vp, D], ``final_norm`` [D] and
    ``lm_head`` [D, Vp], every matrix [in, out] and the routed experts
    [E, in, out] (no transposes); the keys are the tree's paths joined by
    dots (``blocks.attn.wq``, ``blocks.moe.shared.w_gate``). Each leaf is
    cast to the port's dtype for it (the model dtype; f32 for ``dt_bias``,
    ``A_log`` and ``D``). Raises ``ValueError`` on a missing, extra or
    misshaped leaf. The tensors are on the CPU; ``LM.load_state_dict``
    copies them to the model's device."""
    want = param_shapes(cfg)
    got = _flatten(tree)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"lm_params_from_numpy: {cfg.name}: missing leaves "
                         f"{missing}, extra leaves {extra}")
    out = {}
    for name, (shape, dt) in want.items():
        t = _tensor(got[name])
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"lm_params_from_numpy: {cfg.name}: leaf {name} "
                             f"has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        out[name] = t.to(dt)
    return out


def _nested(flat: Mapping[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, val in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = val
    return tree


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 (which numpy lacks) widened exactly to f32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def lm_params_to_numpy(lm) -> Dict[str, Any]:
    """The JAX-shaped parameter tree of the port's ``LM`` (nested dicts of
    numpy arrays, the inverse of :func:`lm_params_from_numpy`). bf16 leaves
    come back as f32 holding the same values: numpy has no bf16 without
    ``ml_dtypes``, which the port does not import."""
    return _nested({k: _numpy(v) for k, v in lm.state_dict().items()})


def opt_state_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig
                         ) -> Dict[str, Any]:
    """The port's AdamW state (``{"m", "v", "step"}``, f32 moments keyed as
    the parameters are, int32 0-d step) from the JAX package's
    ``adamw.init``/``update`` state with numpy leaves, on the CPU. Raises
    ``ValueError`` on a missing, extra or misshaped leaf."""
    want = param_shapes(cfg)
    out: Dict[str, Any] = {"step": torch.tensor(int(np.asarray(tree["step"])),
                                                dtype=torch.int32)}
    for part in ("m", "v"):
        got = _flatten(tree[part])
        if set(got) != set(want):
            raise ValueError(f"opt_state_from_numpy: {cfg.name}: {part} "
                             f"leaves differ from the parameters' by "
                             f"{sorted(set(got) ^ set(want))}")
        out[part] = {}
        for name, (shape, _) in want.items():
            t = _tensor(got[name]).to(torch.float32)
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"opt_state_from_numpy: {cfg.name}: "
                                 f"{part}/{name} has shape "
                                 f"{tuple(t.shape)}, expected {tuple(shape)}")
            out[part][name] = t
    return out


def opt_state_to_numpy(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX-shaped AdamW state (nested ``m``/``v`` trees, an int32 0-d
    ``step``) of the port's state, as numpy arrays."""
    return {"m": _nested({k: _numpy(v) for k, v in state["m"].items()}),
            "v": _nested({k: _numpy(v) for k, v in state["v"].items()}),
            "step": np.asarray(int(state["step"]), np.int32)}
