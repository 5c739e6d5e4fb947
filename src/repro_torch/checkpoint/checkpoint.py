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

Leaves may be torch tensors or numpy arrays; ``restore`` returns torch
tensors (bf16 rebuilt in torch from the ``uint16`` view, without
``ml_dtypes``). Deliberate difference: ``restore(..., device=)`` puts the
leaves on one device where the reference places them on a mesh with
partition specs (one card has no mesh to rescale to).
"""
from __future__ import annotations

import json
import os
import shutil
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
    """Write a checkpoint atomically. Returns the final directory."""
    final = os.path.join(root, f"ckpt_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    index: Dict[str, Dict] = {}
    for path, val in _flatten(tree).items():
        arr, logical = _to_numpy(val)
        safe = path.replace("/", ".")
        n = max(1, min(chunks, arr.shape[0] if arr.ndim else 1))
        parts = np.array_split(arr, n, axis=0) if arr.ndim else [arr]
        for i, part in enumerate(parts):
            np.save(os.path.join(tmp, f"{safe}.{i}.npy"), part)
        index[path] = {"dtype": logical, "shape": list(arr.shape),
                       "chunks": len(parts)}
    manifest = {"step": step, "index": index, "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    _trim(root, keep_last)
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
            device: Any = None) -> Tuple[Any, Dict]:
    """Load a checkpoint (the newest complete one when ``step`` is None) as
    a tree of torch tensors on ``device`` (the CPU when None) and its
    manifest."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = os.path.join(root, f"ckpt_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
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
        flat[path] = t if device is None else t.to(device)
    return _unflatten(flat), manifest
