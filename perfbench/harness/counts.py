"""The yardstick's arithmetic, frozen here so that no change to the program
moves it: the chip's published peaks and the operations and bytes that a
piece of work needs, computed from the configuration's widths and the
traffic's shapes alone.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit): 989.4
TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM.

Model FLOPs count the work the model needs, not what an implementation
does: 2 FLOPs per multiply-add of every weight matrix a token passes
through (the routed experts it picks, the shared experts, the router and
the head; no embedding lookup), 4·D FLOPs per visible (query, key) pair
per query head for attention (Q·K and P·V), and 4·P·N per SSM head per
token for the state update and its read-out. A backward pass is twice a
forward; remat's recompute is not counted.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

PEAK_BF16_FLOPS = 989.4e12
HBM_BYTES_PER_S = 3.35e12


def visible_pairs(s: int, window: int = 0) -> int:
    """Causal (query, key) pairs of one sequence of ``s`` positions, each
    query seeing at most ``window`` keys (itself included) when given."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_bound_s(b: int, hq: int, hkv: int, s: int, d: int, window: int,
                  itemsize: int) -> Tuple[float, str]:
    """Least time of one prefill attention call and what bounds it: q, k,
    v read once and o written once, against 4·D FLOPs for every visible
    (q, k) pair of every query head, at the bf16 peak."""
    flops = visible_pairs(s, window) * 4 * d * b * hq
    nbytes = (2 * b * hq * s * d + 2 * b * hkv * s * d) * itemsize
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def matrix_params_per_token(m: Dict[str, Any]) -> int:
    """Weights of the block matrices one token passes through, summed over
    the layers (the routed experts it picks, not all of them)."""
    d = m["d_model"]
    per = 0
    if m["n_heads"]:
        hd = m.get("head_dim", 128)
        q, kv = m["n_heads"] * hd, m["n_kv_heads"] * hd
        per += 2 * d * q + 2 * d * kv
    if m.get("ssm_state"):
        h, n = m["ssm_heads"], m["ssm_state"]
        di = h * m.get("ssm_head_dim", 64)
        per += 3 * d * di + 2 * d * n + d * h
    if m.get("n_experts"):
        f = m["d_ff"]
        per += d * m["n_experts"] + 3 * d * f * (
            m["top_k"] + m.get("n_shared_experts", 0))
    elif m["d_ff"]:
        per += 3 * d * m["d_ff"]
    return per * m["n_layers"]


def mixer_flops(m: Dict[str, Any], rows: int, s: int) -> int:
    """Forward FLOPs of attention over visible pairs and of the SSM's scan,
    for ``rows`` sequences of ``s`` positions, over every layer."""
    out = 0
    if m["n_heads"]:
        out += (visible_pairs(s, m.get("attn_window", 0)) * 4
                * m.get("head_dim", 128) * m["n_heads"] * rows)
    if m.get("ssm_state"):
        out += (4 * m["ssm_heads"] * m.get("ssm_head_dim", 64)
                * m["ssm_state"] * rows * s)
    return out * m["n_layers"]


def prefill_flops(m: Dict[str, Any], rows: int, s: int) -> int:
    """Model FLOPs of prefilling ``rows`` prompts of ``s`` tokens: every
    token through the blocks, attention and the scan, and the head at the
    last position of each prompt (the first served token)."""
    head = 2 * m["d_model"] * m["vocab"] * rows
    return 2 * matrix_params_per_token(m) * rows * s \
        + mixer_flops(m, rows, s) + head


def train_flops(m: Dict[str, Any], rows: int, s: int) -> int:
    """Model FLOPs of one training step on ``rows`` sequences of ``s``
    tokens: forward and backward (3x the forward) of the blocks, attention,
    the scan and the head at every position; no recompute."""
    head = 2 * m["d_model"] * m["vocab"] * rows * s
    return 3 * (2 * matrix_params_per_token(m) * rows * s
                + mixer_flops(m, rows, s) + head)
