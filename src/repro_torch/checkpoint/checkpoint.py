"""Atomic checkpoints in the JAX package's on-disk format (a copy of
``repro.checkpoint.checkpoint``).

Layout on disk (one directory per step):

    ckpt_00000040/
      manifest.json     step, leaf index, extra (data cursor, seed, ...)
      <leaf>.<i>.npy    chunk i of the leaf (chunked on axis 0)

A leaf's path is its keys in the tree joined by "/" (``params/blocks/
attn/wq``, ``opt/m/...``, ``opt/step``), its file name the path with "."
for "/". bfloat16 is stored as its ``uint16`` view with the logical dtype
"bfloat16"; 0-d leaves are stored as they are. Properties kept from the
reference:

  * atomic publish: written to ``<dir>.tmp`` and renamed only when
    complete, so a killed writer never leaves a half checkpoint visible;
  * resumability: the manifest carries the data cursor; ``latest_step``
    finds the newest complete checkpoint;
  * retention: ``keep_last`` trims old steps after a successful publish.

Leaves may be torch tensors, numpy arrays or DTensors; ``restore``
returns torch tensors (bf16 rebuilt in torch from the ``uint16`` view,
without ``ml_dtypes``).

The elastic path, as the reference's: ``save`` of a tree that holds
DTensors (the partitioned LM's state on a host world) is collective.
Every rank calls it with the same tree; each DTensor is gathered
(``full_tensor()``) in the tree's sorted order, rank 0 writes and the
others wait for the publish. ``restore(..., mesh=, specs=)`` places each
leaf on a ``DeviceMesh`` by its spec, every rank slicing its shard from
the same global array, whatever mesh wrote the checkpoint: one written
on 4x1 resumes on 2x2 or on one device, and either package reads the
other's. ``restore(..., device=)`` without a mesh puts the leaves on one
device.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Any:
    tree: Dict[str, Any] = {}
    for path, val in flat.items():
        ks = path.split("/")
        d = tree
        for k in ks[:-1]:
            d = d.setdefault(k, {})
        d[ks[-1]] = val
    return tree


def _is_dtensor(val: Any) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(val, mod.DTensor)


def _to_numpy(val: Any) -> Tuple[np.ndarray, str]:
    """(array as written, logical dtype name)."""
    if isinstance(val, torch.Tensor):
        t = val.detach().cpu()
        if t.dtype == torch.bfloat16:     # npy-portable: store as u16 view
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(val)
        if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16 (a JAX tree)
            return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def save(root: str, step: int, tree: Any, *, extra: Optional[Dict] = None,
         chunks: int = 1, keep_last: int = 3) -> str:
    """Write a checkpoint atomically. Returns the final directory. A tree
    that holds DTensors is saved by every rank of their world together:
    each DTensor is gathered in sorted path order (a collective), rank 0
    writes each leaf as it comes, one leaf at a time in host memory, and
    every rank returns once rank 0 has published."""
    final = os.path.join(root, f"ckpt_{step:08d}")
    flat = _flatten(tree)
    sharded = any(_is_dtensor(v) for v in flat.values())
    if sharded:
        import torch.distributed as dist
    writes = not sharded or dist.get_rank() == 0
    tmp = final + ".tmp"
    if writes:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
    index: Dict[str, Dict] = {}
    for path, val in flat.items():
        if _is_dtensor(val):
            val = val.full_tensor()
        if not writes:
            continue
        arr, logical = _to_numpy(val)
        del val
        safe = path.replace("/", ".")
        n = max(1, min(chunks, arr.shape[0] if arr.ndim else 1))
        parts = np.array_split(arr, n, axis=0) if arr.ndim else [arr]
        for i, part in enumerate(parts):
            np.save(os.path.join(tmp, f"{safe}.{i}.npy"), part)
        index[path] = {"dtype": logical, "shape": list(arr.shape),
                       "chunks": len(parts)}
    if writes:
        manifest = {"step": step, "index": index, "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                  # atomic publish
        _trim(root, keep_last)
    if sharded:
        dist.barrier()              # the others wait for rank 0's publish
    return final


def _trim(root: str, keep_last: int) -> None:
    steps = sorted(all_steps(root))
    for s in steps[:-keep_last] if keep_last else []:
        shutil.rmtree(os.path.join(root, f"ckpt_{s:08d}"), ignore_errors=True)


def all_steps(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith("ckpt_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(root, name, "manifest.json")):
                out.append(int(name[5:]))
    return sorted(out)


def latest_step(root: str) -> Optional[int]:
    steps = all_steps(root)
    return steps[-1] if steps else None


def restore(root: str, step: Optional[int] = None, *,
            device: Any = None, mesh: Any = None,
            specs: Any = None) -> Tuple[Any, Dict]:
    """Load a checkpoint (the newest complete one when ``step`` is None) as
    a tree of torch tensors and its manifest. Without ``mesh`` the leaves
    go to ``device`` (the CPU when None). With ``mesh`` (a ``DeviceMesh``)
    each leaf becomes a DTensor laid out by its spec in ``specs`` (a tree
    of the checkpoint's structure; a leaf it does not name is replicated),
    its shard on ``device`` (the mesh's current device when None), sliced
    on every rank from the same global array, one leaf at a time: the
    elastic-rescale path, where the mesh need not match the one the
    checkpoint was written from."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = os.path.join(root, f"ckpt_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat_specs = _flatten(specs) if specs is not None else {}
    flat: Dict[str, Any] = {}
    for path, info in manifest["index"].items():
        safe = path.replace("/", ".")
        parts = [np.load(os.path.join(d, f"{safe}.{i}.npy"))
                 for i in range(info["chunks"])]
        arr = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
        if info["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if list(t.shape) != list(info["shape"]):
            raise ValueError(f"checkpoint {d}: leaf {path} has shape "
                             f"{list(t.shape)}, the manifest says "
                             f"{info['shape']}")
        if mesh is not None:
            flat[path] = _placed(t, mesh, flat_specs.get(path, ()), device)
        else:
            flat[path] = t if device is None else t.to(device)
    return _unflatten(flat), manifest


def _placed(t: torch.Tensor, mesh: Any, sp: Any, device: Any) -> Any:
    """The global leaf ``t`` (on the CPU) as a DTensor on ``mesh`` laid out
    by the spec ``sp``: this rank's shard, sliced on the CPU and then
    moved to ``device`` (the mesh's current device when None); no
    collective, and no leaf-sized temporary on the device."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from ..models.sharding import placements
    pl = placements(tuple(sp), mesh)
    shape, offset = compute_local_shape_and_global_offset(t.shape, mesh, pl)
    local = t[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    if device is None:
        device = ("cpu" if mesh.device_type == "cpu" else torch.device(
            mesh.device_type, torch.cuda.current_device()))
    local = torch.empty(shape, dtype=t.dtype, device=device).copy_(local)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())
