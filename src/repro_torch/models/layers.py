"""Model layers in torch: norm, RoPE, int8 KV quantisation, attention,
SwiGLU, MoE, SSD (copies of the JAX package's ``models/layers.py``).
Gradients come from autograd, except ``rmsnorm``'s, which is the
reference's custom VJP as a ``torch.autograd.Function``.

Every function takes plain tensors and dicts of parameter tensors, keeps
the reference's layouts ([B,S,H,D] activations, [in, out] weights,
[E, in, out] expert weights) and computes in f32 exactly where the
reference upcasts. Attention is *blockwise* (online softmax over KV
blocks) by default; ``impl="flash"`` sends prefill attention to the
hand-written CUDA kernel (``repro_torch.kernels.flash_attention``; its
plain version on the CPU). The SSM's whole-sequence SSD runs on the
hand-written ``ssd_scan`` kernel where the call allows it (a plain CUDA
or meta tensor, no autograd graph recorded; :func:`ssd_route`), else on
the torch ``ssd_chunked``.

The MoE layers keep the reference's dispatch groups, capacity, drop
order and aux loss. Where torch and JAX differ they follow JAX: top-k
is a stable descending sort, so ties go to the lower expert index as in
``jax.lax.top_k``; the token order within an expert comes from a stable
argsort; a dropped token is written to a spare row (or a spare capacity
slot) that is sliced off, where JAX drops an out-of-range update; and
the router's bf16 weights are cast to f32 before the product, which JAX
promotes implicitly. The expert products are plain ``torch`` matmuls
(the reference computes them outside any Pallas kernel too).
"""
from __future__ import annotations

import math
import sys
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import tracing
from ..kernels.flash_attention import flash_attention
from ..kernels.ssd_scan import ssd_scan
from .config import ModelConfig
from .sharding import AttnPlan

Params = Dict[str, torch.Tensor]
_NEG = -2.0 ** 30  # large-negative for masking (safe in bf16/f32)


# ----------------------------------------------------------------- basics
class _RMSNorm(torch.autograd.Function):
    """RMSNorm with the reference's custom VJP (``_rmsnorm_fwd``/``_bwd``):
    the backward keeps the *cotangent boundary* in the residual dtype (dx is
    cast to x's dtype, dw to w's), whatever the f32 math inside."""

    @staticmethod
    def forward(ctx, x, w, eps):
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        r = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, w, r)
        return (xf * r).to(x.dtype) * w

    @staticmethod
    def backward(ctx, dy):
        x, w, r = ctx.saved_tensors
        xf = x.float()
        dyf = dy.float()
        xhat = xf * r
        g = dyf * w.float()
        dw = torch.sum(dyf * xhat, dim=tuple(range(x.dim() - 1)))
        dx = r * (g - xhat * torch.mean(g * xhat, dim=-1, keepdim=True))
        return dx.to(x.dtype), dw.to(w.dtype), None


def _feature_mean(mesh, pl, local: torch.Tensor, n: int) -> torch.Tensor:
    """The mean over all ``n`` features of a local [..., F] f32 term of a
    DTensor laid out as ``pl`` on ``mesh``, [..., 1], whole on every rank:
    the local mean where no mesh axis of more than one rank splits the
    features, else the local sums all-reduced over the axes that do (one
    explicit ``redistribute`` of a partial sum) over ``n``, other axes as
    the rows."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    last = local.dim() - 1
    split = [p.is_shard(last) and mesh.size(i) > 1 for i, p in enumerate(pl)]
    if not any(split):
        return torch.mean(local, dim=-1, keepdim=True)
    part = [Partial() if s else p for s, p in zip(split, pl)]
    whole = [Replicate() if s else p for s, p in zip(split, pl)]
    total = DTensor.from_local(local.sum(dim=-1, keepdim=True), mesh, part,
                               run_check=False)
    return total.redistribute(mesh, whole).to_local() / n


def _fresh(local: torch.Tensor, mesh, pl, shape) -> torch.Tensor:
    """The DTensor of global ``shape`` laid out as ``pl`` whose local shard
    is ``local``, with the dense strides of a tensor an op makes."""
    from torch.distributed.tensor import DTensor
    stride, n = [], 1
    for d in reversed(shape):
        stride.insert(0, n)
        n *= d
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=shape,
                              stride=tuple(stride))


class _ShardedRMSNorm(torch.autograd.Function):
    """:class:`_RMSNorm` of a DTensor, on its local shards, ``w`` split as
    ``x``'s features. Each rank normalises its own rows and features; the
    two means over the features (of the squares forward, of g * xhat
    backward) are all-reduced over the axes that split the features, [...,
    1] f32 each (:func:`_feature_mean`; none where no axis splits them:
    the residual's norms), where DTensor's propagation would choose the
    collectives itself (differently in different torch versions). A
    partial cotangent (a row-parallel product's) is summed in the residual
    dtype, at the boundary, not in the f32 inside. ``w``'s gradient is a
    partial sum over the axes that split ``x``'s rows."""

    @staticmethod
    def forward(ctx, x, w, eps):
        mesh, pl = x.device_mesh, tuple(x.placements)
        xl, wl = x.to_local(), w.to_local()
        xf = xl.float()
        r = torch.rsqrt(_feature_mean(mesh, pl, xf * xf, x.shape[-1]) + eps)
        ctx.save_for_backward(xl, wl, r)
        ctx.meta = (mesh, pl, x.shape, w.shape)
        return _fresh((xf * r).to(xl.dtype) * wl, mesh, pl, x.shape)

    @staticmethod
    def backward(ctx, dy):
        from torch.distributed.tensor import Partial, Replicate, Shard
        mesh, pl, xshape, wshape = ctx.meta
        xl, wl, r = ctx.saved_tensors
        if tuple(dy.placements) != pl:
            dy = dy.redistribute(mesh, pl)
        last = xl.dim() - 1
        xf, dyf = xl.float(), dy.to_local().float()
        xhat = xf * r
        g = dyf * wl.float()
        dw = torch.sum(dyf * xhat, dim=tuple(range(last)))
        dx = r * (g - xhat * _feature_mean(mesh, pl, g * xhat, xshape[-1]))
        dwp = [Shard(0) if p.is_shard(last) else
               Partial() if p.is_shard() else Replicate() for p in pl]
        return (_fresh(dx.to(xl.dtype), mesh, pl, xshape),
                _fresh(dw.to(wl.dtype), mesh, dwp, wshape), None)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm; differentiable through the reference's custom VJP. A
    DTensor takes :class:`_ShardedRMSNorm`, ``w`` relaid out as ``x``'s
    features first (a decode step's replicated norm weight on the
    embedding's feature shards: a local slice)."""
    if not is_sharded(x):
        return _RMSNorm.apply(x, w, eps)
    from torch.distributed.tensor import Replicate, Shard
    last = x.dim() - 1
    if any(p.is_partial() for p in x.placements):
        raise ValueError(f"rmsnorm of a partial sum: {x.placements}")
    want = [Shard(0) if p.is_shard(last) else Replicate()
            for p in x.placements]
    return _ShardedRMSNorm.apply(x, _laid_out(w, want), eps)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] (int)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs              # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                      # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------- KV quantization
def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per-(pos, head) quantization over the head_dim axis.
    x: [..., hd] -> (int8 [..., hd], scale f32 [...]). Bit-identical to the
    reference on the same input (f32 division, round half to even)."""
    xf = x.float()
    amax = torch.clamp(xf.abs().amax(dim=-1), min=1e-8)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which rounds otherwise than amax / 127
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


# ------------------------------------------------------------- attention
def _scaled(q: torch.Tensor, scale: Optional[float]) -> torch.Tensor:
    """q in f32 times the softmax scale (``None``: 1/sqrt(D))."""
    if scale is None:
        return q.float() / math.sqrt(q.shape[-1])
    return q.float() * scale


def naive_attention(q, k, v, q_pos, k_pos, window: int = 0,
                    scale: Optional[float] = None):
    """O(S_q*S_k) reference. q: [B,Sq,H,D], k/v: [B,Sk,KV,D]; scores
    scaled by ``scale`` (None: 1/sqrt(D))."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    group = h // kvh
    qf = _scaled(q, scale)
    qg = qf.reshape(b, sq, kvh, group, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    mask = k_pos[:, None, :] <= q_pos[:, :, None]            # causal
    if window:
        mask &= k_pos[:, None, :] > q_pos[:, :, None] - window
    scores = torch.where(mask[:, None, None, :, :], scores, _NEG)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def blockwise_attention(q, k, v, q_pos, k_pos, window: int = 0,
                        block: int = 512, scale: Optional[float] = None):
    """Flash-style online-softmax attention over KV blocks of ``block``
    keys (a Python loop where the reference scans). Peak memory
    O(Sq * block); same signature and semantics as naive_attention."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    kvh = k.shape[2]
    group = h // kvh
    nblk = -(-sk // block)
    pad = nblk * block - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=2 ** 30)
    qf = _scaled(q, scale).reshape(b, sq, kvh, group, d)
    m = torch.full((b, kvh, group, sq), _NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, group, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, group, sq, d), dtype=torch.float32,
                      device=q.device)
    for i in range(nblk):
        kc = k[:, i * block:(i + 1) * block].float()
        vc = v[:, i * block:(i + 1) * block].float()
        pc = k_pos[:, i * block:(i + 1) * block]
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kc)
        mask = pc[:, None, :] <= q_pos[:, :, None]
        if window:
            mask &= pc[:, None, :] > q_pos[:, :, None] - window
        s = torch.where(mask[:, None, None, :, :], s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd",
                                                    p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)
    return out.to(q.dtype)


def attention_layer(cfg: ModelConfig, plan: AttnPlan, p: Params,
                    x: torch.Tensor, positions: torch.Tensor,
                    cache: Optional[Params] = None, window: int = 0,
                    impl: str = "blockwise", rope_on: bool = True,
                    scale: Optional[float] = None,
                    ) -> Tuple[torch.Tensor, Params]:
    """x: [B,S,D]. cache: {"k","v": [B,Skv,KV,hd], "pos": [B,Skv]} (the
    decode ring buffer). Returns (out [B,S,D], {"k", "v"} of this call,
    k after RoPE). ``rope_on=False`` leaves q and k without rotary
    positions (NoPE); ``scale`` is the softmax scale of the scores (None:
    1/sqrt(head_dim))."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, plan.h_pad, hd)
    k = (x @ p["wk"]).reshape(b, s, plan.kv_virtual, hd)
    v = (x @ p["wv"]).reshape(b, s, plan.kv_virtual, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(plan.h_pad, hd)
        k = k + p["bk"].reshape(plan.kv_virtual, hd)
        v = v + p["bv"].reshape(plan.kv_virtual, hd)
    if rope_on:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    if cache is None:
        kk, vv, kpos = k, v, positions
    else:
        # decode: attend over the ring buffer PLUS the current token(s);
        # stale/unwritten ring slots are excluded by the position mask
        kk = torch.cat([cache["k"], k], dim=1)
        vv = torch.cat([cache["v"], v], dim=1)
        kpos = torch.cat([cache["pos"], positions], dim=1)

    if impl == "flash" and cache is None:
        # kernel layout [B,H,S,D] as swapped views; the kernel takes their
        # strides, and its output has q's strides, so the swap back is
        # contiguous. Prefill only (contiguous positions); decode keeps the
        # blockwise path for ring-buffer position masks.
        out = flash_attention(q.transpose(1, 2), kk.transpose(1, 2),
                              vv.transpose(1, 2), causal=True,
                              window=window, scale=scale).transpose(1, 2)
    else:
        fn = blockwise_attention if impl == "blockwise" else naive_attention
        if is_sharded(q):
            # each rank's batch rows and heads (a local map): no DTensor
            # rule is needed for the einsums over blocks
            heads = _follow(q, 0, 2, 2)
            rows = _follow(q, 0, None, 2)
            out = _local_map(lambda *a: fn(*a, window=window, scale=scale),
                             heads, (heads, heads, heads, rows, rows),
                             (q, kk, vv, positions, kpos))
        else:
            out = fn(q, kk, vv, positions, kpos, window=window, scale=scale)
    if s == 1 and is_sharded(out):
        # a decode step as the ops that torch's matmul folds a plain tensor
        # into (view, mm, _unsafe_view): DTensor's stride for the size-1
        # sequence axis defeats the fold
        out = torch.ops.aten._unsafe_view(
            out.reshape(b, plan.h_pad * hd) @ p["wo"], (b, s, cfg.d_model))
    else:
        out = out.reshape(b, s, plan.h_pad * hd) @ p["wo"]
    return out, {"k": k, "v": v}


_SHARDINGS: list = []


def is_sharded(t: torch.Tensor) -> bool:
    """Whether ``t`` is a DTensor (the partitioned LM's; see
    ``repro_torch.models.model``). No DTensor exists before its module is
    imported, so a plain run never imports it."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def _follow(x: torch.Tensor, batch: Optional[int], feat: Optional[int],
            x_feat: int) -> list:
    """Placements, per mesh dimension, of a tensor whose dimension
    ``batch`` is split as ``x``'s dimension 0 is and whose dimension
    ``feat`` as ``x``'s dimension ``x_feat`` (the SSM's channels or
    heads); every other mesh dimension replicates it. The local maps
    below run on these layouts."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for p in x.placements:
        if batch is not None and p.is_shard(0):
            out.append(Shard(batch))
        elif feat is not None and p.is_shard(x_feat):
            out.append(Shard(feat))
        else:
            out.append(Replicate())
    return out


def _summed(x: torch.Tensor, pl: list) -> list:
    """The gradient layout of an input laid out as ``pl`` that every rank
    applies to its own batch rows of ``x`` (a weight): a partial sum over
    each mesh dimension that splits ``x``'s batch, ``pl`` elsewhere."""
    from torch.distributed.tensor import Partial
    return [Partial() if px.is_shard(0) else p
            for px, p in zip(x.placements, pl)]


def _local_map(fn, outs, ins, args, grads=None):
    """``fn(*args)`` on each rank's local shards (``local_map``): the
    inputs laid out as ``ins`` already (a call site relays an input out
    with :func:`_laid_out`; ``local_map`` raises on any other layout, so
    no collective here depends on a layout DTensor chose), the outputs
    laid out as ``outs`` (a list of placements for one output, a tuple of
    such lists for several), the inputs' gradients as ``grads`` (default:
    as ``ins``)."""
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=outs, in_placements=ins,
                     in_grad_placements=grads or ins,
                     redistribute_inputs=False)(*args)


def _laid_out(t: Optional[torch.Tensor], pl) -> Optional[torch.Tensor]:
    """``t`` redistributed to the placements ``pl`` (an explicit relayout
    before a local map), ``t`` itself where it is laid out so (or None)."""
    if t is None or tuple(t.placements) == tuple(pl):
        return t
    return t.redistribute(t.device_mesh, pl)


def _column_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a weight whose output features are split over
    "model" (column-parallel: the MLP's gate and up, the SSM's z and x).
    On DTensors a local map: each rank's rows of ``x`` (features whole)
    times its columns of ``w``, the output's features split as ``w``'s
    columns; ``x``'s gradient a partial sum over the axes that split the
    columns, ``w``'s over the axes that split ``x``'s rows."""
    if not is_sharded(x):
        return x @ w
    from torch.distributed.tensor import Partial, Shard
    last = x.dim() - 1
    xp, wp = list(x.placements), list(w.placements)
    if any(p.is_shard(last) or p.is_partial() for p in xp) or \
            any(p.is_shard(0) or p.is_partial() for p in wp):
        raise ValueError(f"column-parallel product of {xp} and {wp}: x "
                         f"takes its features whole, w splits its columns")
    out = [Shard(last) if pw.is_shard(1) else px for px, pw in zip(xp, wp)]
    xg = [Partial() if pw.is_shard(1) else px for px, pw in zip(xp, wp)]
    wg = [Partial() if px.is_shard() else pw for px, pw in zip(xp, wp)]
    return _local_map(torch.matmul, out, (xp, wp), (x, w), (xg, wg))


def _row_parallel(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``y @ w`` for a weight whose input features are split over "model"
    as ``y``'s are (row-parallel: the MLP's down, the SSM's out). On
    DTensors a local map whose output is a partial sum over the axes that
    split the features, which the caller lays out (``LM._scattered``);
    ``y``'s gradient laid out as ``y``, ``w``'s a partial sum over the axes
    that split ``y``'s rows."""
    if not is_sharded(y):
        return y @ w
    from torch.distributed.tensor import Partial
    last = y.dim() - 1
    yp, wp = list(y.placements), list(w.placements)
    if any(py.is_shard(last) != pw.is_shard(0) or py.is_partial()
           or pw.is_shard(1) or pw.is_partial() for py, pw in zip(yp, wp)):
        raise ValueError(f"row-parallel product of {yp} and {wp}: w splits "
                         f"its rows as y its features")
    out = [Partial() if pw.is_shard(0) else py for py, pw in zip(yp, wp)]
    wg = [Partial() if py.is_shard() and not py.is_shard(last) else pw
          for py, pw in zip(yp, wp)]
    return _local_map(torch.matmul, out, (yp, wp), (y, w), (yp, wg))


class _PartialGrad(torch.autograd.Function):
    """The identity, whose gradient is laid out as a partial sum over the
    mesh axes where it is replicated: a replicated product's share of an
    input's gradient then adds to the sharded products' partial shares
    without an all-reduce, as XLA adds them (DTensor in torch 2.11
    all-reduces the partial sum instead). The relayout is free: the first
    rank of each such axis keeps the value, the others hold zeros."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        mesh = g.device_mesh
        axes = [i for i, p in enumerate(g.placements)
                if p == Replicate() and mesh.size(i) > 1]
        if not axes:
            return g
        local = g.to_local()
        if any(mesh.get_local_rank(i) for i in axes):
            local = torch.zeros_like(local)
        want = [Partial() if i in axes else p
                for i, p in enumerate(g.placements)]
        return DTensor.from_local(local, mesh, want, run_check=False,
                                  shape=g.shape, stride=g.stride())


def _partial_grad(x: torch.Tensor) -> torch.Tensor:
    """``x``, its gradient a partial sum (:class:`_PartialGrad`) on
    DTensors; ``x`` itself otherwise."""
    return _PartialGrad.apply(x) if is_sharded(x) else x


def hybrid_mix(a: torch.Tensor, s: torch.Tensor, mix: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """The hybrid block's branches combined, ``(a mix[0] + s mix[1]) / 2``
    in f32 (as the reference: a bf16 tensor times an f32 array promotes
    there; torch would keep bf16 for a 0-d operand), cast to ``dtype``.
    On DTensors the branches are row-parallel partial sums: each rank
    combines its partial values (a local map), so the gradient of
    ``mix`` is a partial sum too, where DTensor would all-reduce both f32
    branches first."""
    if not is_sharded(a):
        mix = mix.float()
        return (a.float() * mix[0] + s.float() * mix[1]).to(dtype) * 0.5
    from torch.distributed.tensor import Partial, Replicate
    part = list(a.placements)
    whole = [Replicate() if p.is_partial() else p for p in part]
    summed = [Partial() if p.is_partial() or p.is_shard(0) else Replicate()
              for p in part]
    return _local_map(lambda a_, s_, m_: hybrid_mix(a_, s_, m_, dtype),
                      part, (part, part, [Replicate()] * len(part)),
                      (a, s, mix), (whole, whole, summed))


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """``table[tokens]``; on DTensors (the table's features split over
    "model", the tokens' batch over the data axes) each rank's lookup of
    its rows in its columns (a local map)."""
    if not is_sharded(table):
        return table[tokens]
    from torch.distributed.tensor import Replicate, Shard
    out = [Shard(0) if pt.is_shard(0) else Shard(2) if pw.is_shard(1)
           else Replicate() for pw, pt in zip(table.placements,
                                              tokens.placements)]
    grads = (_summed(tokens, list(table.placements)),
             list(tokens.placements))
    return _local_map(embed_lookup, out,
                      (list(table.placements), list(tokens.placements)),
                      (table, tokens), grads)


def _dt_softplus(dt: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The SSM's step sizes, softplus(dt + bias) in f32; on DTensors each
    rank's batch rows (a local map, so the backward stays one
    ``softplus_backward``, for which DTensor has no rule)."""
    if not is_sharded(dt):
        return F.softplus(dt.float() + bias)
    rows = _follow(dt, 0, None, 2)
    vec = _follow(dt, None, 0, 2)
    return _local_map(_dt_softplus, rows, (rows, vec), (dt, bias),
                      (rows, _summed(dt, vec)))


def register_shardings() -> None:
    """DTensor sharding rules for the ops of this module that DTensor has
    none for, registered once a process (the partitioned LM calls it):
    ``torch.ops.repro_torch.flash_attention`` runs on each rank's local
    heads and batch rows, so q, k, v and the output may be sharded alike
    on the batch axis (0) or the head axis (1) of its [B, H, S, D] layout,
    or replicated; the sequence and head-dim axes are never sharded. A
    head shard keeps whole GQA groups: the attention plan makes the KV
    head count a multiple of the TP degree and q heads are laid out group
    by group."""
    if _SHARDINGS:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _flash(q, k, v, causal, window, q_offset, scale=None):
        rest = [None, None, None, None]
        return [([p], [p, p, p] + rest)
                for p in (Replicate(), Shard(0), Shard(1))]

    _SHARDINGS.append(_flash)


# ------------------------------------------------------------------- loss
def ce_terms(lg: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logsumexp of ``lg`` [B,T,V] over the vocabulary, the logit of each
    label [B,T]). A label of -1 takes the logit at 0 (``gather`` raises on
    it where JAX's ``take_along_axis`` does not): the loss's mask zeroes
    its term. On DTensor logits whose vocabulary is split over a mesh
    axis both are vocabulary-parallel, as XLA partitions them: the max
    and the sum of exponentials all-reduced over that axis ([B,T] each),
    and the label's logit gathered by the rank that holds it (a local
    map, summed over the axis); DTensor alone would gather the logits."""
    split = [i for i, p in enumerate(lg.placements)
             if p.is_shard(2) and lg.device_mesh.size(i) > 1] \
        if is_sharded(lg) else []
    if not split:
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, labels.clamp(min=0).long()[..., None]
                            )[..., 0]
        return lse, gold
    from torch.distributed.tensor import Partial
    mesh = lg.device_mesh
    rows = _follow(lg, 0, None, 2)
    m = lg.detach().amax(dim=-1, keepdim=True).redistribute(mesh, rows)
    lse = m[..., 0] + torch.log(
        torch.exp(lg - m).sum(dim=-1).redistribute(mesh, rows))
    vloc = lg.to_local().shape[-1]
    offset = sum(mesh.get_local_rank(i) * math.prod(
        mesh.size(j) for j in split if j > i) for i in split) * vloc

    def gold_local(lg_l, labels_l):
        idx = labels_l.long() - offset
        inside = (idx >= 0) & (idx < vloc)
        got = torch.gather(lg_l, -1, idx.clamp(0, vloc - 1)[..., None]
                           )[..., 0]
        return torch.where(inside, got, torch.zeros_like(got))

    out = [Partial() if i in split else p for i, p in enumerate(rows)]
    gold = _local_map(gold_local, out,
                      (list(lg.placements), list(labels.placements)),
                      (lg, labels))
    return lse, gold.redistribute(mesh, rows)


# ------------------------------------------------------------------- MLP
def swiglu(p: Params, x: torch.Tensor, bias: bool = False) -> torch.Tensor:
    g = _column_parallel(x, p["w_gate"])
    u = _column_parallel(x, p["w_up"])
    if bias:
        g = g + p["b_gate"]
        u = u + p["b_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    out = _row_parallel(h, p["w_down"])
    if bias:
        out = out + p["b_down"]
    return out


def _moe_groups(cfg: ModelConfig, t: int) -> int:
    """Number of dispatch groups: capacity is enforced per group so the
    dispatch structures stay O(group) — groups align with data shards."""
    g = max(1, t // cfg.moe_group)
    while t % g:
        g -= 1
    return g


def _route(cfg: ModelConfig, p: Params, x: torch.Tensor,
           t: Optional[int] = None):
    """The router of both dispatches: x [B,S,D] in groups of ``sg``
    tokens, ``sg`` and the capacity those of ``t`` tokens (default: x's
    own; a rank's rows hold whole groups of the global batch's ``t``).
    Returns (xg [g,sg,d], probs [g,sg,e] f32, gate [g,sg,k] f32 (top-k
    probabilities renormalised), idx [g,sg,k] int64, cap)."""
    b, s, d = x.shape
    t = b * s if t is None else t
    e, k = cfg.n_experts, cfg.top_k
    sg = t // _moe_groups(cfg, t)
    cap = max(1, int(cfg.capacity_factor * sg * k / e))
    xg = x.reshape(b * s // sg, sg, d)
    logits = xg.float() @ p["router"].float()                # [g,sg,e]
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k: descending, the lower index first on ties
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[..., :k], idx[..., :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return xg, probs, gate, idx, cap


def _slots(idx: torch.Tensor, e: int, cap: int):
    """The einsum dispatch's slots: (one-hot of idx [g,sg,k,e] f32, each
    (token, k) slot's position in its expert's buffer [g,sg,k] int64,
    counted in (token, k) order, and whether it fits, pos < cap)."""
    ng, sg, k = idx.shape
    onehot = F.one_hot(idx, e).float()
    # the running count per expert, scanned along the last axis
    pos = torch.cumsum(onehot.reshape(ng, sg * k, e).transpose(1, 2),
                       dim=-1) - 1.0                         # [g,e,sg*k]
    pos = torch.gather(pos, 1, idx.reshape(ng, 1, sg * k)).reshape(ng, sg, k)
    return onehot, pos.long(), pos < cap


def _aux(cfg: ModelConfig, psum: torch.Tensor, csum: torch.Tensor,
         t: int) -> torch.Tensor:
    """Load-balancing loss e * sum(mean prob * mean assignment count) of
    ``t`` tokens, from the sums over them of the router probabilities and
    of the one-hot assignments ([e] f32 each)."""
    return cfg.n_experts * torch.sum((psum / t) * (csum / t))


def _experts(p: Params, xin: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU on its capacity buffer: xin [g,e,c,d] ->
    [g,e,c,d], one batched product per weight, experts on the batch axis.
    Each temporary is dropped once read, so the expert-major copy of the
    buffer and the gate and up products are gone before the output is
    made (at granite-4.0-h-small's 32k-token prefill each buffer is 3.3
    GB beside 64 GB of weights)."""
    g, e, c, d = xin.shape
    xe = xin.transpose(0, 1).reshape(e, g * c, d)
    gg = torch.bmm(xe, p["w_gate"])
    uu = torch.bmm(xe, p["w_up"])
    del xe
    hh = F.silu(gg.float()).to(xin.dtype) * uu
    del gg, uu
    eout = torch.bmm(hh, p["w_down"])                        # [e,g*c,d]
    return eout.reshape(e, g, c, d).transpose(0, 1)


def _local_experts(keep: torch.Tensor, idx: torch.Tensor, lo: int, el: int,
                   e: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keep, idx) for the ``el`` experts from ``lo`` that hold weights
    here: a slot routed to another expert is dropped here, and idx counts
    from ``lo``. Unchanged when every expert is here."""
    if el == e:
        return keep, idx
    return keep & (idx >= lo) & (idx < lo + el), idx - lo


def _count_slots(keep: torch.Tensor) -> None:
    """Count a dispatch's (token, expert) slots and those dropped past
    their expert's capacity (``keep`` false), while tracing is on."""
    if tracing.active():
        tracing.count("moe_routed_slots", keep.numel())
        # written as int64, so the sum reads it without a cast: 2 kernels
        dropped = torch.empty(keep.shape, dtype=torch.int64,
                              device=keep.device)
        tracing.count("moe_dropped_slots",
                      torch.logical_not(keep, out=dropped).sum())


def _sort_dispatch(p: Params, xg: torch.Tensor, gate: torch.Tensor,
                   idx: torch.Tensor, cap: int, lo: int, e: int
                   ) -> torch.Tensor:
    """The sort/scatter dispatch of ``moe_sort`` on the experts from
    ``lo`` whose weights ``p`` holds: [g,sg,d] in xg's dtype, the sum of
    each token's gated outputs of those experts."""
    ng, sg, d = xg.shape
    k = idx.shape[-1]
    el = p["w_gate"].shape[0]
    with tracing.span("moe.dispatch"):
        flat_e = idx.reshape(ng, sg * k)
        order = torch.argsort(flat_e, dim=1, stable=True)
        sorted_e = torch.gather(flat_e, 1, order)            # [g, sg*k]
        # position within expert = rank - first occurrence of that expert
        first = torch.searchsorted(sorted_e, sorted_e, side="left")
        pos = torch.arange(sg * k, device=xg.device)[None, :] - first
        fits = pos < cap
        _count_slots(fits)
        keep, sorted_e = _local_experts(fits, sorted_e, lo, el, e)
        dest = torch.where(keep, sorted_e * cap + pos, el * cap)  # spare row
        token = order // k                                   # [g, sg*k]
        src = torch.gather(xg, 1, token[..., None].expand(-1, -1, d))
        xin = torch.zeros((ng, el * cap + 1, d), dtype=xg.dtype,
                          device=xg.device)
        xin.scatter_(1, dest[..., None].expand(-1, -1, d), src)
    with tracing.span("moe.experts"):
        eout = _experts(p, xin[:, :el * cap].reshape(ng, el, cap, d))
    with tracing.span("moe.combine"):
        eout = eout.reshape(ng, el * cap, d)
        back = torch.gather(eout, 1, torch.where(keep, dest, 0)[..., None]
                            .expand(-1, -1, d))              # [g, sg*k, d]
        gflat = torch.gather(gate.reshape(ng, sg * k), 1, order)
        w = torch.where(keep, gflat, 0.0).float()
        contrib = back.float() * w[..., None]
        out = torch.zeros((ng, sg, d), dtype=torch.float32, device=xg.device)
        out.scatter_add_(1, token[..., None].expand(-1, -1, d), contrib)
        return out.to(xg.dtype)


def _einsum_dispatch(p: Params, xg: torch.Tensor, gate: torch.Tensor,
                     idx: torch.Tensor, cap: int, lo: int, e: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one-hot dispatch of ``moe_einsum`` on the experts from ``lo``
    whose weights ``p`` holds: ([g,sg,d] in xg's dtype, the one-hot of
    idx [g,sg,k,e] f32)."""
    ng, sg, d = xg.shape
    el = p["w_gate"].shape[0]
    with tracing.span("moe.dispatch"):
        onehot, pos, keep = _slots(idx, e, cap)
        _count_slots(keep)
        keep, idx = _local_experts(keep, idx, lo, el, e)
        col = torch.where(keep, idx * cap + pos, el * cap)   # [g,sg,k]
        dispatch = torch.zeros((ng, sg, el * cap + 1), dtype=torch.float32,
                               device=xg.device)
        combine = torch.zeros_like(dispatch)
        dispatch.scatter_(2, col, 1.0)
        combine.scatter_(2, col, gate)
        dispatch = dispatch[..., :el * cap].to(xg.dtype)     # [g,sg,el*cap]
        combine = combine[..., :el * cap].to(xg.dtype)
        xin = dispatch.transpose(1, 2) @ xg                  # [g,el*cap,d]
        del dispatch
    with tracing.span("moe.experts"):
        eout = _experts(p, xin.reshape(ng, el, cap, d))
        del xin        # read once: gone before the combine copies eout
    with tracing.span("moe.combine"):
        return combine @ eout.reshape(ng, el * cap, d), onehot  # [g,sg,d]


def _routed(cfg: ModelConfig, p: Params, x: torch.Tensor,
            t: Optional[int] = None, lo: int = 0, aux_grad: bool = True):
    """The routed experts of ``x`` [B,S,D]'s groups (of ``t`` tokens'
    grouping, default x's own), by ``cfg.moe_impl``, on the experts from
    ``lo`` whose weights ``p`` holds (every expert on one device).
    Returns (out [B,S,D], the sums over x's tokens of the router
    probabilities and of the one-hot assignments, [e] f32 each). Without
    ``aux_grad`` no gradient flows back through the probabilities' sum."""
    b, s, d = x.shape
    e = cfg.n_experts
    with tracing.span("moe.route"):
        xg, probs, gate, idx, cap = _route(cfg, p, x, t)
    if cfg.moe_impl == "sort":
        out = _sort_dispatch(p, xg, gate, idx, cap, lo, e)
        onehot = None
    else:
        out, onehot = _einsum_dispatch(p, xg, gate, idx, cap, lo, e)
    with tracing.span("moe.aux"):
        if onehot is None:
            onehot = F.one_hot(idx, e).float()
        pa = probs if aux_grad else probs.detach()
        psum, csum = pa.reshape(-1, e).sum(0), onehot.reshape(-1, e).sum(0)
    return out.reshape(b, s, d), psum, csum


def _moe_sharded(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 shared: Optional[torch.Tensor]):
    """The routed experts on DTensors, expert-parallel (a local map; no
    DTensor rule is needed for the router, the sort, the scatters and
    gathers): ``x`` [B,S,D] split on its batch over the data axes and
    whole over "model", the expert weights [E, in, out] split over
    "model" (``E / tp`` experts a rank; under ``fsdp_experts`` also over
    the data axes, all-gathered here at use and their gradients
    reduce-scattered back). Every rank routes its rows' groups over all
    experts, as on one device (the same groups, capacity and drops), and
    runs its own experts: the output is a partial sum over "model" (plus
    ``shared``, the shared experts' partial sum), which the caller
    reduce-scatters into the residual. Where the groups do not fall
    inside one data shard (a decode batch of fewer than ``moe_group``
    tokens is one group) the tokens are all-gathered over the data axes,
    each rank routes every group and keeps its rows of the output. The
    aux loss's gradient flows through one rank of the axes whose ranks
    route the same tokens. Returns (out, the two [e] sums of
    :func:`_routed`, partial sums over the data axes that split the
    groups)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    m = mesh.mesh_dim_names.index("model")
    b, s, _ = x.shape
    rows = [i for i, pl in enumerate(x.placements) if pl.is_shard(0)]
    if m in rows or not all(pl.is_replicate() or pl.is_shard(0)
                            for pl in x.placements):
        raise ValueError(f"moe_layer: tokens laid out as {x.placements}; "
                         f"the dispatch takes them split on the batch over "
                         f"the data axes only")
    split = math.prod(mesh.size(i) for i in rows)
    whole = _moe_groups(cfg, b * s) % split != 0
    el = cfg.n_experts // mesh.size(m)
    lo = mesh.get_local_rank(m) * el
    first = all(mesh.get_local_rank(i) == 0
                for i in [m] + (rows if whole else []))
    r = sum(mesh.get_local_rank(i) * math.prod(
        mesh.size(j) for j in rows if j > i) for i in rows)
    nb = b // split

    def lay(on_rows, on_model):
        return [on_model if i == m else on_rows if i in rows else Replicate()
                for i in range(mesh.ndim)]

    rep, part, sh0 = Replicate(), Partial(), Shard(0)
    out_pl = lay(sh0, part)
    sums = lay(rep if whole else part, rep)
    x_in = lay(rep if whole else sh0, rep)
    x_grad = lay(part if whole else sh0, part)
    exp_in, exp_grad = lay(rep, sh0), lay(part, sh0)
    shared_in = None if shared is None else out_pl
    shared_grad = None if shared is None else lay(sh0, rep)

    def local(x_l, router, wg, wu, wd, sh):
        out, psum, csum = _routed(
            cfg, {"router": router, "w_gate": wg, "w_up": wu, "w_down": wd},
            x_l, b * s, lo, first)
        if whole:
            out = out[r * nb:(r + 1) * nb]
        if sh is not None:
            out = out + sh
        return out, psum, csum

    ins = (x_in, lay(rep, rep), exp_in, exp_in, exp_in, shared_in)
    args = (x, p["router"], p["w_gate"], p["w_up"], p["w_down"], shared)
    # a whole group's tokens gathered over the data axes, and under
    # fsdp_experts the expert weights, relaid out here
    return _local_map(
        local, (out_pl, sums, sums), ins,
        tuple(_laid_out(a, pl) for a, pl in zip(args, ins)),
        (x_grad, lay(part, part), exp_grad, exp_grad, exp_grad,
         shared_grad))


def moe_layer(cfg: ModelConfig, p: Params, x: torch.Tensor,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixture-of-experts block, the dispatch by ``cfg.moe_impl``: the
    shared experts' SwiGLU, the routed experts (:func:`_routed`; on
    DTensors :func:`_moe_sharded`, whose probability and assignment sums
    are all-reduced over the data axes that split the groups) and the
    aux loss over all tokens. Returns (out [B,S,D], aux loss f32)."""
    b, s, _ = x.shape
    shared = None
    if cfg.n_shared_experts:
        with tracing.span("moe.shared"):
            shared = swiglu(p["shared"], x)
    if is_sharded(x):
        from torch.distributed.tensor import Replicate
        out, psum, csum = _moe_sharded(cfg, p, x, shared)
        everywhere = [Replicate()] * x.device_mesh.ndim
        psum, csum = (v.redistribute(x.device_mesh, everywhere)
                      for v in (psum, csum))
    else:
        out, psum, csum = _routed(cfg, p, x)
        if shared is not None:
            out = out + shared
    with tracing.span("moe.aux"):
        return out, _aux(cfg, psum, csum, b * s)


def moe_sort(cfg: ModelConfig, p: Params, x: torch.Tensor,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort/scatter MoE dispatch: tokens argsorted (stably) by expert
    within a group, placed into per-expert capacity buffers by a scatter
    (overflow goes to a spare row that is sliced off, where the reference
    drops the write), and combined back with a scatter-add in f32.
    Returns (out [B,S,D], aux loss f32)."""
    return moe_layer(cfg.replace(moe_impl="sort"), p, x)


def moe_einsum(cfg: ModelConfig, p: Params, x: torch.Tensor,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard-style dispatch with per-group capacity: one-hot dispatch and
    combine tensors [g,sg,e,cap] and products with them.

    The reference forms them as einsums over a [g,sg,k,e,cap] one-hot of
    each slot's position. Every element of those einsums has at most one
    non-zero term (a token picks an expert once), so they are built here
    by a scatter of 1 and of the gate into [g,sg,e*cap + 1], a dropped
    slot going to the spare last column, which gives the same values
    without the five-axis tensor. The combine weights are rounded to the
    model dtype before the product, as in the reference.
    Returns (out [B,S,D], aux loss f32)."""
    return moe_layer(cfg.replace(moe_impl="einsum"), p, x)


# ------------------------------------------------------------------- SSD
def ssd_chunked(x, dt, A_log, B, C, D, chunk: int, return_state: bool = False):
    """Mamba2 SSD, chunked dual form (arXiv:2405.21060 listing 1).

    x:  [b, s, h, p]   (heads h, head dim p)
    dt: [b, s, h]      (softplus-ed outside)
    A_log: [h]         B, C: [b, s, n]  (single group), D: [h]
    Returns y: [b, s, h, p], or (y, final_state [b,h,p,n]) when
    ``return_state`` (the prefill -> decode handoff).

    The reference's three multi-operand einsums are written as explicit
    pairwise products, so the arithmetic does not depend on the einsum
    path torch picks and no intermediate holds l*l*h*p values. On DTensors
    it runs on each rank's batch rows and heads (a local map).
    """
    if is_sharded(x):
        xp = _follow(x, 0, 2, 2)
        hd = _follow(x, 0, 2, 2)
        vec = _follow(x, None, 0, 2)
        bc = _follow(x, 0, None, 2)
        st = _follow(x, 0, 1, 2)
        from torch.distributed.tensor import Partial
        sv = _summed(x, vec)
        # each rank's heads contribute a partial sum to B's and C's grads
        bcg = [Partial() if px.is_shard(2) else p
               for px, p in zip(x.placements, bc)]
        # the step sizes and the per-head vectors sliced to this rank's
        # heads (a local slice; the backward gathers their gradients)
        return _local_map(
            lambda *a: ssd_chunked(*a, chunk, return_state),
            (xp, st) if return_state else xp,
            (xp, hd, vec, bc, bc, vec),
            (x, _laid_out(dt, hd), _laid_out(A_log, vec), B, C,
             _laid_out(D, vec)),
            (xp, hd, sv, bcg, bcg, sv))
    b, s, h, hp = x.shape
    n = B.shape[-1]
    if s % chunk:
        # pad to a chunk multiple; dt=0 makes padding a no-op for the state
        pad = chunk - s % chunk
        xp = F.pad(x, (0, 0, 0, 0, 0, pad))
        dtp = F.pad(dt, (0, 0, 0, pad))
        Bp = F.pad(B, (0, 0, 0, pad))
        Cp = F.pad(C, (0, 0, 0, pad))
        out = ssd_chunked(xp, dtp, A_log, Bp, Cp, D, chunk, return_state)
        if return_state:
            return out[0][:, :s], out[1]
        return out[:, :s]
    nc = s // chunk
    xf = x.float()
    dtf = dt.float()
    A = -torch.exp(A_log.float())                            # [h], negative
    dA = dtf * A                                             # [b,s,h]
    xc = xf.reshape(b, nc, chunk, h, hp)
    dtc = dtf.reshape(b, nc, chunk, h)
    dAc = dA.reshape(b, nc, chunk, h)
    Bc = B.float().reshape(b, nc, chunk, n)
    Cc = C.float().reshape(b, nc, chunk, n)
    seg = torch.cumsum(dAc, dim=2)                           # [b,nc,l,h]
    # intra-chunk (diagonal block): attention-like with decay matrix L
    rel = seg[:, :, :, None, :] - seg[:, :, None, :, :]      # [b,nc,l,l,h]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    # masked before the exp (the reference masks after it): the same values,
    # but no exp(rel) = inf above the diagonal once a chunk's decay passes
    # e^88, whose gradient (0 * inf) would be NaN
    L = torch.exp(torch.where(causal[None, None, :, :, None], rel,
                              float("-inf")))
    cb = Cc @ Bc.transpose(-1, -2)                           # [b,nc,l,m]
    # y_diag[l,h,p] = sum_m cb[l,m] L[l,m,h] dt[m,h] x[m,h,p]
    w = cb[..., None] * L * dtc[:, :, None, :, :]            # [b,nc,l,m,h]
    y_diag = (w.permute(0, 1, 4, 2, 3)                       # [b,nc,h,l,m]
              @ xc.permute(0, 1, 3, 2, 4)                    # [b,nc,h,m,p]
              ).permute(0, 1, 3, 2, 4)                       # [b,nc,l,h,p]
    # chunk-level states: decayed sum of inputs
    decay_to_end = torch.exp(seg[:, :, -1:, :] - seg)        # [b,nc,l,h]
    wx = (decay_to_end * dtc)[..., None] * xc                # [b,nc,l,h,p]
    states = wx.permute(0, 1, 3, 4, 2) @ Bc[:, :, None]      # [b,nc,h,p,n]
    # inter-chunk recurrence over chunk states
    chunk_decay = torch.exp(seg[:, :, -1, :])                # [b,nc,h]
    prev = torch.zeros((b, h, hp, n), dtype=torch.float32, device=x.device)
    prev_states = []
    for c in range(nc):
        prev_states.append(prev)                             # state *before* chunk
        prev = states[:, c] + chunk_decay[:, c, :, None, None] * prev
    final_state = prev
    prev_states = torch.stack(prev_states, dim=1)            # [b,nc,h,p,n]
    # contribution of carried state to each position
    state_decay = torch.exp(seg)                             # decay from chunk start
    cs = (Cc[:, :, None] @ prev_states.transpose(-1, -2)     # [b,nc,h,l,p]
          ).permute(0, 1, 3, 2, 4)                           # [b,nc,l,h,p]
    y_off = state_decay[..., None] * cs
    y = (y_diag + y_off).reshape(b, s, h, hp)
    y = y + xf * D.float()[None, None, :, None]
    y = y.to(x.dtype)
    if return_state:
        return y, final_state
    return y


def ssd_route(*operands: torch.Tensor) -> str:
    """Where the SSD of a whole sequence runs for these operands (x, dt,
    A_log, B, C, D): ``"kernel"``, the hand-written ``ssd_scan``, for
    plain CUDA tensors on a call that records no autograd graph (grad
    mode off, or no operand requiring grad), since the kernel has no
    backward; ``"chunked"``, :func:`ssd_chunked`, otherwise: the CPU,
    DTensors, training and remat's recompute. The meta device, the dry
    run's stand-in for the card, routes as CUDA does (the kernel's
    operator has a fake kernel and a FLOP formula). It reads the device,
    the layout and the grad mode alone, so every SSM config takes the
    same route on the same inputs."""
    x = operands[0]
    if x.device.type not in ("cuda", "meta") or \
            any(map(is_sharded, operands)):
        return "chunked"
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return "chunked"
    return "kernel"


def ssd_prefill(x, dt, A_log, B, C, D, chunk: int,
                return_state: bool = False):
    """The SSD of a whole sequence on the route :func:`ssd_route` picks,
    with :func:`ssd_chunked`'s arguments and results (the kernel's state
    is f32 too, and y in x's dtype). While tracing is on it counts the
    route's calls, ``ssd_kernel_calls`` or ``ssd_chunked_calls``, under
    the top-level span (host integers: no launch, no synchronize)."""
    if ssd_route(x, dt, A_log, B, C, D) == "kernel":
        tracing.count("ssd_kernel_calls", 1)
        return ssd_scan(x, dt, A_log, B, C, D, chunk=chunk,
                        return_state=return_state)
    tracing.count("ssd_chunked_calls", 1)
    return ssd_chunked(x, dt, A_log, B, C, D, chunk, return_state)


def ssd_decode_step(state, x, dt, A_log, B, C, D):
    """Single-token SSD recurrence. state: [b,h,p,n]; x: [b,h,p];
    dt: [b,h]; B,C: [b,n]. Returns (y [b,h,p], new state). On DTensors
    it runs on each rank's batch rows and heads (a local map)."""
    if is_sharded(x):
        xp = _follow(x, 0, 1, 1)
        vec = _follow(x, None, 0, 1)
        bc = _follow(x, 0, None, 1)
        return _local_map(ssd_decode_step, (xp, xp),
                          (xp, xp, xp, vec, bc, bc, vec),
                          (_laid_out(state, xp), x, _laid_out(dt, xp),
                           _laid_out(A_log, vec), B, C, _laid_out(D, vec)))
    A = -torch.exp(A_log.float())
    dtf = dt.float()
    dA = torch.exp(dtf * A)                                  # [b,h]
    xf = x.float()
    upd = dtf[:, :, None, None] * xf[..., None] * B.float()[:, None, None, :]
    new_state = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, C.float())
    y = y + xf * D.float()[None, :, None]
    return y.to(x.dtype), new_state


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 prev: Optional[torch.Tensor],
                 bias: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: [B,S,F], w: [K,F], prev: [B,K-1,F] or None,
    bias: [F] or None. A sum of K shifted slices (plus the bias), in f32.
    Returns (silu(conv(x)), new_prev [B,K-1,F]). On DTensors it runs on
    each rank's rows and channels (a local map), without a bias."""
    if is_sharded(x):
        if bias is not None:
            raise NotImplementedError("_causal_conv: a bias on DTensors")
        xp = _follow(x, 0, 2, 2)
        wp = _follow(x, None, 1, 2)
        ins = (xp, wp, None if prev is None else xp)
        return _local_map(_causal_conv, (xp, xp), ins, (x, w, prev),
                          (xp, _summed(x, wp), ins[2]))
    b, s, f = x.shape
    k = w.shape[0]
    if prev is None:
        prev = torch.zeros((b, k - 1, f), dtype=x.dtype, device=x.device)
    xp = torch.cat([prev, x], dim=1)
    y = sum(xp[:, i:i + s, :].float() * w[i].float() for i in range(k))
    if bias is not None:
        y = y + bias.float()
    y = F.silu(y).to(x.dtype)
    return y, xp[:, -(k - 1):, :]


def _viewed(t: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """``t.reshape(shape)`` between the SSM's channels [B,S,H*P] and heads
    [B,S,H,P]; on DTensors a local map (each rank's rows and heads, dim 2
    split alike on both sides, the gradient laid out so too)."""
    if not is_sharded(t):
        return t.reshape(shape)
    pl = list(t.placements)
    if any(p.is_partial() or (p.is_shard() and not p.is_shard(0)
                              and not p.is_shard(2)) for p in pl):
        raise ValueError(f"the SSM's view of {pl}: rows on dim 0, channels "
                         f"or heads on dim 2")
    tail = tuple(shape[3:])
    return _local_map(lambda a: a.reshape(a.shape[0], a.shape[1], -1, *tail),
                      pl, (pl,), (t,))


def _gated(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The SSM's gate ``y * silu(z)`` (silu in f32, cast to y's dtype);
    on DTensors a local map on each rank's rows and channels."""
    if not is_sharded(y):
        return y * F.silu(z.float()).to(y.dtype)
    pl = list(y.placements)
    return _local_map(_gated, pl, (pl, pl), (y, z))


def ssm_layer(cfg: ModelConfig, p: Params, x: torch.Tensor,
              cache: Optional[Params] = None, want_cache: bool = False):
    """Mamba2 mixer. x: [B,S,D]. If ``cache`` is given (decode), S must be 1.
    The convolutions of x, B and C add their biases where ``p`` holds
    them (``conv_x_bias``, ``conv_B_bias``, ``conv_C_bias``), and run
    inside the span ``conv``. Returns (out [B,S,D], new_cache)."""
    b, s, d = x.shape
    h, hp = cfg.ssm_heads, cfg.ssm_head_dim
    di = h * hp
    z = _column_parallel(x, p["w_z"])
    xin = _column_parallel(x, p["w_x"])
    xr = _partial_grad(x)       # the replicated weights' products
    Bc = xr @ p["w_B"]
    Cc = xr @ p["w_C"]
    dt = xr @ p["w_dt"]
    cv = cache or {}
    with tracing.span("conv"):
        xin, conv_x = _causal_conv(xin, p["conv_x"], cv.get("conv_x"),
                                   p.get("conv_x_bias"))
        Bc, conv_B = _causal_conv(Bc, p["conv_B"], cv.get("conv_B"),
                                  p.get("conv_B_bias"))
        Cc, conv_C = _causal_conv(Cc, p["conv_C"], cv.get("conv_C"),
                                  p.get("conv_C_bias"))
    dt = _dt_softplus(dt, p["dt_bias"])
    xh = _viewed(xin, (b, s, h, hp))
    if cache is None:
        if want_cache:  # prefill: also hand the final state to decode
            y, new_state = ssd_prefill(xh, dt, p["A_log"], Bc, Cc, p["D"],
                                       cfg.ssm_chunk, return_state=True)
        else:
            y = ssd_prefill(xh, dt, p["A_log"], Bc, Cc, p["D"],
                            cfg.ssm_chunk)
            new_state = None
    else:
        if s != 1:
            raise ValueError(f"ssm_layer: decode takes one token, got {s}")
        y1, new_state = ssd_decode_step(
            cache["state"], xh[:, 0], dt[:, 0], p["A_log"], Bc[:, 0],
            Cc[:, 0], p["D"])
        y = y1[:, None]
    y = _viewed(y, (b, s, di))
    y = rmsnorm(_gated(y, z), p["norm"], cfg.norm_eps)
    out = _row_parallel(y, p["w_out"])
    new_cache = ({"state": new_state, "conv_x": conv_x, "conv_B": conv_B,
                  "conv_C": conv_C}
                 if (cache is not None or want_cache) else None)
    return out, new_cache
