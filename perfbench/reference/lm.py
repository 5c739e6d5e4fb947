"""The language models of the benchmark's configurations in plain PyTorch.

One function per piece, written from the published descriptions and the
configuration file's stated semantics, every product and every
elementwise step in float32 (TF32 off). It reads the weights in the
benchmark's layout (``perfbench.harness.weights.leaves``) and upcasts one
layer at a time.

- Block: ``x + mixer(rmsnorm(x))`` then ``x + ffn(rmsnorm(x))``; the
  hybrid block's mixer is ``(attention * mix[0] + ssm * mix[1]) / 2`` on
  the same normed input.
- Attention: rotary embeddings (rotate-half, base ``rope_theta``), grouped
  query heads, causal, and a query at position i sees keys j with
  i - window < j when the configuration has a window. Computed in blocks
  of queries over all the keys they may see.
- SSM (Mamba2, one group): depthwise causal convolutions of width
  ``d_conv`` then SiLU on x, B and C; dt = softplus(x W_dt + dt_bias);
  A = -exp(A_log); h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = C_t
  h_t + D x_t, written in its quadratic form (the weight of source s at
  t is C_t . B_s exp(sum of dt A over (s, t]) dt_s), gated by SiLU(z),
  normed and projected out.
- MoE (the configuration's ``assumed`` dispatch): every call to the model
  routes its tokens (rows by positions, row-major) in groups of
  ``moe_group`` (fewer where they do not divide the call), softmax
  router in float32, the ``top_k`` most probable experts (ties to the
  lower index) with their probabilities renormalised, each (token,
  choice) slot taking the next place of its expert in the group in
  (token, choice) order and dropped past ``int(capacity_factor * group *
  top_k / n_experts)`` places (at least one); plus the shared experts on
  every token.

``Precision`` puts the operands of every product through a rounding: none
for the reference, float8 (e4m3, one scale per tensor, float32
accumulation) for the control that a check must refuse.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

QUERY_BLOCK = 256
SCAN_BLOCK = 128
FAR = -110.0      # exp(-110) is below half float32's least subnormal


def e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the tensor (its
    largest magnitude at 448), back in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Rounded(torch.autograd.Function):
    """A product's operand in float8: rounded on the way forward, the
    gradient passed through as it is (the backward's own products round
    their operands at :class:`_RoundedGrad`)."""

    @staticmethod
    def forward(ctx, x):
        return e4m3(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundedGrad(torch.autograd.Function):
    """A product's result: unchanged forward, its gradient (an operand of
    the backward's products) rounded to float8."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return e4m3(g)


class Precision:
    """How the operands of a product are rounded, forward and backward:
    ``float32`` keeps them, ``float8`` rounds each to e4m3 under one scale
    per tensor (float32 accumulation)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "float8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def _product(self, fn, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return fn(a, b)
        return _RoundedGrad.apply(fn(_Rounded.apply(a), _Rounded.apply(b)))

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._product(torch.matmul, a, b)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
        return self._product(lambda x, y: torch.einsum(eq, x, y), a, b)


FP32 = Precision("float32")


def exact_float32() -> None:
    """Products in float32 proper: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [R, T, H, D] rotated by positions ``pos`` [T]."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = (pos.double()[:, None] * inv[None, :]).float()
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(m: Dict[str, Any], w: Dict[str, torch.Tensor],
              h: torch.Tensor, pos: torch.Tensor, prec: Precision
              ) -> torch.Tensor:
    r, t, _ = h.shape
    nh, nkv, hd = m["n_heads"], m["n_kv_heads"], m.get("head_dim", 128)
    q = prec.mm(h, w["attn.wq"])
    k = prec.mm(h, w["attn.wk"])
    v = prec.mm(h, w["attn.wv"])
    if m.get("qkv_bias"):
        q, k, v = q + w["attn.bq"], k + w["attn.bk"], v + w["attn.bv"]
    theta = m.get("rope_theta", 10000.0)
    q = rope(q.view(r, t, nh, hd), pos, theta)
    k = rope(k.view(r, t, nkv, hd), pos, theta)
    k = k.repeat_interleave(nh // nkv, dim=2)
    v = v.view(r, t, nkv, hd).repeat_interleave(nh // nkv, dim=2)
    win = m.get("attn_window", 0)
    outs = []
    for q0 in range(0, t, QUERY_BLOCK):
        q1 = min(t, q0 + QUERY_BLOCK)
        k0 = max(0, q0 - win + 1) if win else 0
        s = prec.einsum("rqhd,rkhd->rhqk", q[:, q0:q1], k[:, k0:q1])
        s = s / math.sqrt(hd)
        qp, kp = pos[q0:q1, None], pos[None, k0:q1]
        vis = kp <= qp
        if win:
            vis = vis & (kp > qp - win)
        p = torch.softmax(s.masked_fill(~vis, float("-inf")), dim=-1)
        outs.append(prec.einsum("rhqk,rkhd->rqhd", p, v[:, k0:q1]))
    o = torch.cat(outs, dim=1).reshape(r, t, nh * hd)
    return prec.mm(o, w["attn.wo"])


def causal_conv(x: torch.Tensor, wc: torch.Tensor) -> torch.Tensor:
    """SiLU of the depthwise causal convolution of x [R, T, F] by wc [K, F]
    (the last tap on the current position)."""
    k, t = wc.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return F.silu(sum(xp[:, i:i + t] * wc[i] for i in range(k)))


def ssm(m: Dict[str, Any], w: Dict[str, torch.Tensor], h: torch.Tensor,
        prec: Precision) -> torch.Tensor:
    r, t, _ = h.shape
    nh, p = m["ssm_heads"], m.get("ssm_head_dim", 64)
    z = prec.mm(h, w["ssm.w_z"])
    x = causal_conv(prec.mm(h, w["ssm.w_x"]), w["ssm.conv_x"])
    b = causal_conv(prec.mm(h, w["ssm.w_B"]), w["ssm.conv_B"])
    c = causal_conv(prec.mm(h, w["ssm.w_C"]), w["ssm.conv_C"])
    dt = F.softplus(prec.mm(h, w["ssm.w_dt"]) + w["ssm.dt_bias"])
    a = -torch.exp(w["ssm.A_log"])
    cum = torch.cumsum((dt * a).double(), dim=1)              # [R, T, H]
    xh = x.view(r, t, nh, p)
    idx = torch.arange(t, device=h.device)
    ys = []
    for q0 in range(0, t, SCAN_BLOCK):
        q1 = min(t, q0 + SCAN_BLOCK)
        # sources whose decay to every query of the block is below
        # exp(FAR) round to exactly zero in float32: skip them
        near = (cum[:, q0:q0 + 1] - cum[:, :q1]).amax(dim=(0, 2)) > FAR
        k0 = int(torch.nonzero(near)[0]) if bool(near.any()) else q0
        cb = prec.einsum("rqn,rkn->rqk", c[:, q0:q1], b[:, k0:q1])
        diff = cum[:, q0:q1, None, :] - cum[:, None, k0:q1, :]  # [R,q,k,H]
        vis = idx[q0:q1, None] >= idx[None, k0:q1]
        decay = torch.exp(diff.masked_fill(~vis[None, :, :, None],
                                           float("-inf"))).float()
        wgt = cb[..., None] * decay * dt[:, None, k0:q1, :]
        ys.append(prec.einsum("rqkh,rkhp->rqhp", wgt, xh[:, k0:q1]))
    y = torch.cat(ys, dim=1) + xh * w["ssm.D"][:, None]
    y = y.reshape(r, t, nh * p) * F.silu(z)
    y = rmsnorm(y, w["ssm.norm"], m.get("norm_eps", 1e-5))
    return prec.mm(y, w["ssm.w_out"])


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor, prec: Precision) -> torch.Tensor:
    return prec.mm(F.silu(prec.mm(x, wg)) * prec.mm(x, wu), wd)


def moe_groups(t: int, size: int) -> int:
    """Groups of a call of ``t`` tokens: ``t // size`` (at least one),
    lowered until it divides ``t``."""
    g = max(1, t // size)
    while t % g:
        g -= 1
    return g


def routed(m: Dict[str, Any], w: Dict[str, torch.Tensor], xs: torch.Tensor,
           prec: Precision) -> torch.Tensor:
    """The routed experts' sum for the tokens xs [T, d] of one call."""
    t, d = xs.shape
    e, k = m["n_experts"], m["top_k"]
    g = moe_groups(t, m.get("moe_group", 512))
    sg = t // g
    cap = max(1, int(m.get("capacity_factor", 1.25) * sg * k / e))
    xg = xs.view(g, sg, d)
    probs = torch.softmax(prec.mm(xg, w["moe.router"]), dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, idx = top[..., :k], idx[..., :k]
    gate = top / top.sum(-1, keepdim=True)
    slots = F.one_hot(idx, e).reshape(g, sg * k, e)
    place = ((torch.cumsum(slots, dim=1) - 1) * slots).sum(-1)
    keep = (place < cap).view(g, sg, k)
    out = torch.zeros_like(xg)
    for ex in range(e):
        gi, ti, ki = torch.nonzero((idx == ex) & keep, as_tuple=True)
        if gi.numel() == 0:
            continue
        ye = swiglu(xg[gi, ti], w["moe.w_gate"][ex], w["moe.w_up"][ex],
                    w["moe.w_down"][ex], prec)
        out.index_put_((gi, ti), ye * gate[gi, ti, ki][:, None],
                       accumulate=True)
    return out.view(t, d)


def moe(m: Dict[str, Any], w: Dict[str, torch.Tensor], h: torch.Tensor,
        calls: Sequence[Tuple[int, int]], prec: Precision) -> torch.Tensor:
    """Shared plus routed experts of h [R, T, d]; ``calls`` are the
    position ranges that the model was called on, each routed over all
    rows at once."""
    r, _, d = h.shape
    out = torch.zeros_like(h)
    if m.get("n_shared_experts"):
        out = swiglu(h, w["moe.shared.w_gate"], w["moe.shared.w_up"],
                     w["moe.shared.w_down"], prec)
    parts = [routed(m, w, h[:, p0:p1].reshape(-1, d), prec)
             .view(r, p1 - p0, d) for p0, p1 in calls]
    return out + torch.cat(parts, dim=1)


def layer_weights(weights: Dict[str, torch.Tensor], i: int
                  ) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s leaves in float32, named without ``blocks.``."""
    return {name[len("blocks."):]: t[i].float()
            for name, t in weights.items() if name.startswith("blocks.")}


def block(m: Dict[str, Any], w: Dict[str, torch.Tensor], x: torch.Tensor,
          pos: torch.Tensor, calls: Sequence[Tuple[int, int]],
          prec: Precision) -> torch.Tensor:
    eps = m.get("norm_eps", 1e-5)
    h = rmsnorm(x, w["ln1"], eps)
    if m["family"] == "hybrid":
        mix = w["mix"]
        x = x + (attention(m, w, h, pos, prec) * mix[0]
                 + ssm(m, w, h, prec) * mix[1]) * 0.5
    elif m["family"] == "ssm":
        x = x + ssm(m, w, h, prec)
    else:
        x = x + attention(m, w, h, pos, prec)
    if m.get("n_experts"):
        x = x + moe(m, w, rmsnorm(x, w["ln2"], eps), calls, prec)
    elif m["d_ff"]:
        x = x + swiglu(rmsnorm(x, w["ln2"], eps), w["mlp.w_gate"],
                       w["mlp.w_up"], w["mlp.w_down"], prec)
    return x


def hidden(m: Dict[str, Any], weights: Dict[str, torch.Tensor],
           tokens: torch.Tensor, calls: Sequence[Tuple[int, int]],
           prec: Precision = FP32) -> torch.Tensor:
    """The last block's output [R, T, d] for ``tokens`` [R, T]."""
    x = weights["embed"][tokens].float()
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    for i in range(m["n_layers"]):
        x = block(m, layer_weights(weights, i), x, pos, calls, prec)
    return x


def head(m: Dict[str, Any], weights: Dict[str, torch.Tensor],
         x: torch.Tensor, prec: Precision = FP32) -> torch.Tensor:
    """Logits [..., vocab] of hidden states x [..., d]."""
    x = rmsnorm(x, weights["final_norm"].float(), m.get("norm_eps", 1e-5))
    w = (weights["embed"].T if m.get("tie_embeddings")
         else weights["lm_head"]).float()
    return prec.mm(x, w)[..., :m["vocab"]]


def logits_at(m: Dict[str, Any], weights: Dict[str, torch.Tensor],
              tokens: torch.Tensor, positions: List[int],
              calls: Sequence[Tuple[int, int]],
              prec: Precision = FP32) -> torch.Tensor:
    """Logits [R, len(positions), vocab] after the tokens up to each of
    ``positions``, for ``tokens`` [R, T] served in ``calls``."""
    with torch.no_grad():
        x = hidden(m, weights, tokens, calls, prec)
        return head(m, weights, x[:, positions], prec)
