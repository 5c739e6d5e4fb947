"""The benchmark's inputs, made from ``--seed``: the weights and the token
ids. Both the program and the reference take them from here.

The weights follow the port's parameter tree at one device (block leaves
stacked on a leading layer axis, [in, out] matrices, routed experts
[E, in, out]), which is the layout the configuration's widths give
(:func:`leaves`). Each leaf is drawn on the device by one call from one
generator, in the order of its name: matrices N(0, 0.02), the output
projections N(0, 0.02 / sqrt(2 L)), norms, ``mix`` and ``D`` one,
``dt_bias`` and ``A_log`` zero. The same seed gives the same values on
the same card, so the reference draws them again after the program has
freed its own (:func:`make`).
"""
from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, Mapping, Tuple

F32_LEAVES = ("dt_bias", "A_log", "D")
ONES = ("ln1", "ln2", "norm", "mix", "D", "final_norm")
ZEROS = ("dt_bias", "A_log")
OUT_PROJECTIONS = ("wo", "w_down", "w_out")


def stream(seed: int, *words: Any) -> int:
    """A 63-bit generator seed for the stream ``words`` of ``seed``."""
    h = hashlib.sha256(repr((int(seed),) + words).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def leaves(m: Dict[str, Any]) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Leaf name -> (shape, dtype name) of the model of ``m`` (a
    configuration file's ``model`` object) on one device."""
    L, d = m["n_layers"], m["d_model"]
    dt = m.get("dtype", "bfloat16")
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {}

    def blk(name, *shape):
        base = name.split(".")[-1]
        out["blocks." + name] = ((L, *shape),
                                 "float32" if base in F32_LEAVES else dt)

    blk("ln1", d)
    if m["n_heads"]:
        hd = m.get("head_dim", 128)
        q, kv = m["n_heads"] * hd, m["n_kv_heads"] * hd
        blk("attn.wq", d, q)
        blk("attn.wk", d, kv)
        blk("attn.wv", d, kv)
        blk("attn.wo", q, d)
        if m.get("qkv_bias"):
            blk("attn.bq", q)
            blk("attn.bk", kv)
            blk("attn.bv", kv)
    if m.get("ssm_state"):
        h, n = m["ssm_heads"], m["ssm_state"]
        di, k = h * m.get("ssm_head_dim", 64), m.get("d_conv", 4)
        for name, shape in (("w_z", (d, di)), ("w_x", (d, di)),
                            ("w_B", (d, n)), ("w_C", (d, n)),
                            ("w_dt", (d, h)), ("conv_x", (k, di)),
                            ("conv_B", (k, n)), ("conv_C", (k, n)),
                            ("dt_bias", (h,)), ("A_log", (h,)), ("D", (h,)),
                            ("norm", (di,)), ("w_out", (di, d))):
            blk("ssm." + name, *shape)
    if m["family"] == "hybrid":
        blk("mix", 2)
    if m.get("n_experts"):
        e, f = m["n_experts"], m["d_ff"]
        blk("ln2", d)
        blk("moe.router", d, e)
        blk("moe.w_gate", e, d, f)
        blk("moe.w_up", e, d, f)
        blk("moe.w_down", e, f, d)
        if m.get("n_shared_experts"):
            fs = m["n_shared_experts"] * f
            blk("moe.shared.w_gate", d, fs)
            blk("moe.shared.w_up", d, fs)
            blk("moe.shared.w_down", fs, d)
    elif m["d_ff"]:
        blk("ln2", d)
        blk("mlp.w_gate", d, m["d_ff"])
        blk("mlp.w_up", d, m["d_ff"])
        blk("mlp.w_down", m["d_ff"], d)
        if m.get("mlp_bias"):
            blk("mlp.b_gate", m["d_ff"])
            blk("mlp.b_up", m["d_ff"])
            blk("mlp.b_down", d)
    out["embed"] = ((m["vocab"], d), dt)
    out["final_norm"] = ((d,), dt)
    if not m.get("tie_embeddings"):
        out["lm_head"] = ((d, m["vocab"]), dt)
    return out


def fill(tensors: Mapping[str, Any], m: Dict[str, Any], seed: int) -> None:
    """Draw every leaf of ``tensors`` (name -> tensor on one device, the
    names of :func:`leaves`) in place from ``seed``."""
    import torch
    dev = next(iter(tensors.values())).device
    gen = torch.Generator(device=dev).manual_seed(stream(seed, "weights"))
    std_out = 0.02 / math.sqrt(2 * m["n_layers"])
    with torch.no_grad():
        for name in sorted(tensors):
            t, base = tensors[name], name.split(".")[-1]
            if base in ONES:
                t.fill_(1)
            elif base in ZEROS or (name.startswith("blocks.")
                                   and base.startswith("b")):
                t.zero_()
            else:
                t.normal_(0.0, std_out if base in OUT_PROJECTIONS else 0.02,
                          generator=gen)


def make(m: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """New tensors of :func:`leaves` on ``device``, drawn by :func:`fill`."""
    import torch
    out = {name: torch.empty(shape, dtype=getattr(torch, dt), device=device)
           for name, (shape, dt) in leaves(m).items()}
    fill(out, m, seed)
    return out


def tokens(seed: int, batch: int, rows: int, length: int, vocab: int,
           device):
    """Batch ``batch``'s token ids [rows, length], uniform over the
    vocabulary, drawn on ``device`` from its own stream of ``seed``."""
    import torch
    gen = torch.Generator(device=device).manual_seed(
        stream(seed, "tokens", batch))
    return torch.randint(0, vocab, (rows, length), generator=gen,
                         device=device)
