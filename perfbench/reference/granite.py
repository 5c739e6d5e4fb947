"""Granite-4.0-H-Small's language model in plain PyTorch: a stack of Mamba2
and attention layers, each followed by a routed MoE with a shared MLP.

Written from the published config (ibm-granite/granite-4.0-h-small,
``config.json``: ``layer_types``, ``position_embedding_type`` "nope",
``attention_multiplier``, ``embedding_multiplier``,
``residual_multiplier``, ``logits_scaling``, ``mamba_*``,
``shared_intermediate_size``), every product and every elementwise step
in float32 (TF32 off). It reads the weights in the benchmark's layout
for such a stack (``perfbench.kinds.serve_patterned.leaves``: the
attention leaves stacked over the attention layers, the Mamba leaves over
the Mamba layers, the norms and the MoE over every layer) and upcasts
one layer at a time.

- Embedding: ``x0 = embedding_multiplier * embed[tokens]``.
- Layer i of kind k: ``x += residual_multiplier * mixer_k(rmsnorm(x))``,
  then ``x += residual_multiplier * (moe(h2) + shared(h2))`` with
  ``h2 = rmsnorm(x)``.
- Attention: q, k, v projections without bias and without rotary
  positions; scores ``q . k * attention_multiplier``, causal over every
  position, 4 query heads to a key head; output projection. Computed in
  blocks of queries over the keys they see.
- Mamba2 (one group): z, x, B, C and dt projected from the input; x, B
  and C each through SiLU of a depthwise causal convolution of width
  ``d_conv`` plus its bias; dt = softplus(dt + dt_bias), A = -exp(A_log);
  per head ``S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T`` and
  ``y_t = S_t C_t + D x_t``, computed in blocks of ``SCAN_BLOCK``
  positions: within a block its quadratic form, across blocks the state;
  gated by SiLU(z), RMS-normed over the inner width, projected out.
- MoE (``reference.lm.moe``): float32 router logits over 72 experts, the
  10 largest, gates a softmax over those 10 (the renormalised top-10 of a
  softmax over all 72 is the same number), SwiGLU experts, plus the
  shared SwiGLU on every token.
- Logits: ``rmsnorm(x) @ embed^T / logits_scaling`` (tied embeddings).

Departures from the published model, as the configuration file states:
the capacity dispatch of ``reference.lm`` (each call's tokens in groups
of 512, capacity 1.25, later slots dropped), which the published model
does not have; the program routes so too, one call for the prefill and
one a decode step, and the reference routes the same calls.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .lm import FP32, Precision, moe, rmsnorm

QUERY_BLOCK = 256
SCAN_BLOCK = 128


def slots(kinds: Sequence[str]) -> List[int]:
    """Each layer's index among the layers of its kind: where its mixer's
    leaves hold its slice."""
    seen: Dict[str, int] = {}
    out = []
    for k in kinds:
        out.append(seen.get(k, 0))
        seen[k] = out[-1] + 1
    return out


def layer_weights(m: Dict[str, Any], weights: Dict[str, torch.Tensor],
                  i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s leaves in float32, named without ``blocks.``: its
    own kind's mixer and every layer's norms and MoE."""
    kind = m["layer_kinds"][i]
    j = slots(m["layer_kinds"])[i]
    mine = "attn." if kind == "attention" else "ssm."
    out = {}
    for name, t in weights.items():
        if not name.startswith("blocks."):
            continue
        short = name[len("blocks."):]
        if short.startswith(("attn.", "ssm.")):
            if short.startswith(mine):
                out[short] = t[j].float()
        else:
            out[short] = t[i].float()
    return out


def attention(m: Dict[str, Any], w: Dict[str, torch.Tensor],
              h: torch.Tensor, prec: Precision) -> torch.Tensor:
    r, t, _ = h.shape
    nh, nkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = prec.mm(h, w["attn.wq"]).view(r, t, nh, hd)
    k = prec.mm(h, w["attn.wk"]).view(r, t, nkv, hd)
    v = prec.mm(h, w["attn.wv"]).view(r, t, nkv, hd)
    k = k.repeat_interleave(nh // nkv, dim=2)
    v = v.repeat_interleave(nh // nkv, dim=2)
    pos = torch.arange(t, device=h.device)
    outs = []
    for q0 in range(0, t, QUERY_BLOCK):
        q1 = min(t, q0 + QUERY_BLOCK)
        s = prec.einsum("rqhd,rkhd->rhqk", q[:, q0:q1], k[:, :q1])
        s = s * m["attn_scale"]
        vis = pos[None, :q1] <= pos[q0:q1, None]
        p = torch.softmax(s.masked_fill(~vis, float("-inf")), dim=-1)
        outs.append(prec.einsum("rhqk,rkhd->rqhd", p, v[:, :q1]))
    o = torch.cat(outs, dim=1).reshape(r, t, nh * hd)
    return prec.mm(o, w["attn.wo"])


def causal_conv(x: torch.Tensor, wc: torch.Tensor, bias: torch.Tensor
                ) -> torch.Tensor:
    """SiLU of the depthwise causal convolution of x [R, T, F] by wc [K, F]
    (the last tap on the current position) plus ``bias`` [F]."""
    k, t = wc.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return F.silu(sum(xp[:, i:i + t] * wc[i] for i in range(k)) + bias)


def mamba(m: Dict[str, Any], w: Dict[str, torch.Tensor], h: torch.Tensor,
          prec: Precision) -> torch.Tensor:
    r, t, _ = h.shape
    nh, p, n = m["ssm_heads"], m["ssm_head_dim"], m["ssm_state"]
    z = prec.mm(h, w["ssm.w_z"])
    x = causal_conv(prec.mm(h, w["ssm.w_x"]), w["ssm.conv_x"],
                    w["ssm.conv_x_bias"])
    b = causal_conv(prec.mm(h, w["ssm.w_B"]), w["ssm.conv_B"],
                    w["ssm.conv_B_bias"])
    c = causal_conv(prec.mm(h, w["ssm.w_C"]), w["ssm.conv_C"],
                    w["ssm.conv_C_bias"])
    dt = F.softplus(prec.mm(h, w["ssm.w_dt"]) + w["ssm.dt_bias"])  # [R,T,H]
    a = -torch.exp(w["ssm.A_log"])
    xh = x.view(r, t, nh, p)
    state = torch.zeros((r, nh, p, n), dtype=torch.float32, device=h.device)
    idx = torch.arange(SCAN_BLOCK, device=h.device)
    ys = []
    for q0 in range(0, t, SCAN_BLOCK):
        q1 = min(t, q0 + SCAN_BLOCK)
        n_q = q1 - q0
        dtb, xb = dt[:, q0:q1], xh[:, q0:q1]
        bb, cb = b[:, q0:q1], c[:, q0:q1]
        # log-decay from the block's start through each position, inclusive
        cum = torch.cumsum((dtb * a).double(), dim=1)              # [R,q,H]
        # within the block: source s feeds t >= s with weight
        # C_t . B_s exp(cum_t - cum_s) dt_s
        vis = idx[:n_q, None] >= idx[None, :n_q]
        diff = cum[:, :, None, :] - cum[:, None, :, :]             # [R,q,k,H]
        decay = torch.exp(diff.masked_fill(~vis[None, :, :, None],
                                           float("-inf"))).float()
        cbk = prec.einsum("rqn,rkn->rqk", cb, bb)
        wgt = cbk[..., None] * decay * dtb[:, None]
        y = prec.einsum("rqkh,rkhp->rqhp", wgt, xb)
        # the state at the block's start, decayed to each position
        y = y + prec.einsum("rqn,rhpn->rqhp", cb, state) \
            * torch.exp(cum).float()[..., None]
        # the state at the block's end
        tail = torch.exp(cum[:, -1:] - cum).float() * dtb          # [R,q,H]
        state = state * torch.exp(cum[:, -1]).float()[..., None, None] \
            + prec.einsum("rkhp,rkn->rhpn", xb * tail[..., None], bb)
        ys.append(y)
    y = torch.cat(ys, dim=1) + xh * w["ssm.D"][:, None]
    y = y.reshape(r, t, nh * p) * F.silu(z)
    y = rmsnorm(y, w["ssm.norm"], m["norm_eps"])
    return prec.mm(y, w["ssm.w_out"])


def block(m: Dict[str, Any], w: Dict[str, torch.Tensor], kind: str,
          x: torch.Tensor, calls: Sequence[Tuple[int, int]],
          prec: Precision) -> torch.Tensor:
    eps, rs = m["norm_eps"], m["residual_scale"]
    h = rmsnorm(x, w["ln1"], eps)
    mixer = attention if kind == "attention" else mamba
    x = x + rs * mixer(m, w, h, prec)
    return x + rs * moe(m, w, rmsnorm(x, w["ln2"], eps), calls, prec)


def hidden(m: Dict[str, Any], weights: Dict[str, torch.Tensor],
           tokens: torch.Tensor, calls: Sequence[Tuple[int, int]],
           prec: Precision = FP32) -> torch.Tensor:
    """The last layer's output [R, T, d] for ``tokens`` [R, T]."""
    x = m["embed_scale"] * weights["embed"][tokens].float()
    for i, kind in enumerate(m["layer_kinds"]):
        x = block(m, layer_weights(m, weights, i), kind, x, calls, prec)
    return x


def head(m: Dict[str, Any], weights: Dict[str, torch.Tensor],
         x: torch.Tensor, prec: Precision = FP32) -> torch.Tensor:
    """Logits [..., vocab] of hidden states x [..., d] (tied embeddings)."""
    x = rmsnorm(x, weights["final_norm"].float(), m["norm_eps"])
    return prec.mm(x, weights["embed"].T.float())[..., :m["vocab"]] \
        / m["logit_scale"]


def logits_at(m: Dict[str, Any], weights: Dict[str, torch.Tensor],
              tokens: torch.Tensor, positions: List[int],
              calls: Sequence[Tuple[int, int]],
              prec: Precision = FP32) -> torch.Tensor:
    """Logits [R, len(positions), vocab] after the tokens up to each of
    ``positions``, for ``tokens`` [R, T] served in ``calls``."""
    with torch.no_grad():
        x = hidden(m, weights, tokens, calls, prec)
        return head(m, weights, x[:, positions], prec)
