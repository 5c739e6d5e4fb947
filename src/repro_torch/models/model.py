"""The LM in torch: parameters, forward, logits, prefill and decode (a copy
of the JAX package's ``models/model.py`` for the dense, MoE, SSM and hybrid
families, including ``audio``/``vlm`` fed tokens or embeddings, which take
the dense block, and the int8 KV cache of ``kv_quant=True``).

The parameters keep the reference's tree: ``blocks.*`` stacked on a
leading layer axis, plus ``embed``, ``final_norm`` and ``lm_head``, each
in the reference's [in, out] layout (routed experts [E, in, out]);
``state_dict()`` keys are the tree's paths joined by dots
(``blocks.attn.wq``, ``blocks.moe.shared.w_up``), which is what
``repro_torch.convert.lm_params_from_numpy`` produces. The port runs on
one GPU, so the head plan is read at tp=1, there are no sharding
constraints, and ``fsdp_experts`` (the reference's FSDP sharding of
expert weights over the data axes) has nothing to shard: every expert
lives on the one card. The layers run in a Python loop over the stacked
layer axis (the reference scans), and ``decode_step`` updates the
ring-buffer cache in place (the reference returns a new one). With
``kv_quant`` the cache holds int8 ``k``/``v`` with f32 per-(position,
head) scales: a decode step dequantizes each layer's ring to the model
dtype before attention and quantizes the new slot, and
``prefill_with_cache`` quantizes each layer's slots as it writes them.

Training: ``loss_fn`` is the reference's (CE over the text positions,
the ``labels >= 0`` mask, plus the router's aux loss). ``forward`` carries
gradients when grad mode is on; with ``cfg.remat`` each block then runs
under ``torch.utils.checkpoint`` (non-reentrant), which keeps only the
block's inputs, as the reference's ``nothing_saveable`` policy does. The
parameters are registered with ``requires_grad=False``: the training step
(``repro_torch.launch.steps``) turns it on, and the serving methods run
under ``torch.no_grad()`` whatever it is.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import layers
from .config import ModelConfig
from .sharding import AttnPlan, pad_to, plan_attention

Params = Dict[str, Any]
_F32_LEAVES = ("dt_bias", "A_log", "D")   # f32 whatever the model dtype


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "ssm", "hybrid", "audio", "vlm"):
        raise ValueError(cfg.family)


def _block_shapes(cfg: ModelConfig, plan: Optional[AttnPlan]
                  ) -> Dict[str, Tuple[int, ...]]:
    """Leaf name -> shape for ONE block (unstacked), in the reference's
    order (the order ``LM.init`` draws them in)."""
    d, hd = cfg.d_model, cfg.head_dim
    out: Dict[str, Tuple[int, ...]] = {"ln1": (d,)}
    if not cfg.is_attention_free:
        out["attn.wq"] = (d, plan.h_pad * hd)
        out["attn.wk"] = (d, plan.kv_virtual * hd)
        out["attn.wv"] = (d, plan.kv_virtual * hd)
        out["attn.wo"] = (plan.h_pad * hd, d)
        if cfg.qkv_bias:
            out["attn.bq"] = (plan.h_pad * hd,)
            out["attn.bk"] = (plan.kv_virtual * hd,)
            out["attn.bv"] = (plan.kv_virtual * hd,)
    if cfg.has_ssm:
        h, hp, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        di = h * hp
        out.update({
            "ssm.w_z": (d, di), "ssm.w_x": (d, di), "ssm.w_B": (d, n),
            "ssm.w_C": (d, n), "ssm.w_dt": (d, h),
            "ssm.conv_x": (cfg.d_conv, di), "ssm.conv_B": (cfg.d_conv, n),
            "ssm.conv_C": (cfg.d_conv, n), "ssm.dt_bias": (h,),
            "ssm.A_log": (h,), "ssm.D": (h,), "ssm.norm": (di,),
            "ssm.w_out": (di, d)})
    if cfg.family == "hybrid":
        out["mix"] = (2,)
    if cfg.n_experts:
        e, f = cfg.n_experts, cfg.d_ff
        out["ln2"] = (d,)
        out["moe.router"] = (d, e)
        out["moe.w_gate"] = (e, d, f)
        out["moe.w_up"] = (e, d, f)
        out["moe.w_down"] = (e, f, d)
        if cfg.n_shared_experts:
            fs = cfg.n_shared_experts * f
            out["moe.shared.w_gate"] = (d, fs)
            out["moe.shared.w_up"] = (d, fs)
            out["moe.shared.w_down"] = (fs, d)
    elif cfg.d_ff:
        out["ln2"] = (d,)
        out["mlp.w_gate"] = (d, cfg.d_ff)
        out["mlp.w_up"] = (d, cfg.d_ff)
        out["mlp.w_down"] = (cfg.d_ff, d)
        if cfg.mlp_bias:
            out["mlp.b_gate"] = (cfg.d_ff,)
            out["mlp.b_up"] = (cfg.d_ff,)
            out["mlp.b_down"] = (d,)
    return out


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...],
                                                        torch.dtype]]:
    """Every parameter of the LM of ``cfg``: dotted name -> (shape, dtype),
    block leaves stacked on a leading ``n_layers`` axis. The names are the
    JAX parameter tree's paths joined by dots."""
    _check_supported(cfg)
    plan = None if cfg.is_attention_free else plan_attention(
        cfg.n_heads, cfg.n_kv_heads, 1)
    dt, L = _dtype(cfg), cfg.n_layers
    out = {}
    for name, shape in _block_shapes(cfg, plan).items():
        leaf_dt = torch.float32 if name.split(".")[-1] in _F32_LEAVES else dt
        out[f"blocks.{name}"] = ((L, *shape), leaf_dt)
    vocab_pad = pad_to(cfg.vocab, 1)
    out["embed"] = ((vocab_pad, cfg.d_model), dt)
    out["final_norm"] = ((cfg.d_model,), dt)
    if not cfg.tie_embeddings:
        out["lm_head"] = ((cfg.d_model, vocab_pad), dt)
    return out


class LM(nn.Module):
    """The LM of ``cfg`` on ``device`` (default: the port's default
    device, ``cuda`` unless ``repro_torch.set_default_device("cpu")``).
    Parameters start uninitialised: fill them with :meth:`init` or
    ``load_state_dict(convert.lm_params_from_numpy(tree, cfg))``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        shapes = param_shapes(cfg)
        self.cfg = cfg
        self.device = (torch.device(device) if device is not None
                       else resolve_device())
        self.plan: Optional[AttnPlan] = None
        if not cfg.is_attention_free:
            self.plan = plan_attention(cfg.n_heads, cfg.n_kv_heads, 1)
        self.vocab_pad = pad_to(cfg.vocab, 1)
        self.dtype = _dtype(cfg)
        for name, (shape, dt) in shapes.items():
            *path, leaf = name.split(".")
            node = self
            for part in path:
                if not hasattr(node, part):
                    node.add_module(part, nn.Module())
                node = getattr(node, part)
            node.register_parameter(leaf, nn.Parameter(
                torch.empty(shape, dtype=dt, device=self.device),
                requires_grad=False))

    # ------------------------------------------------------------- params
    def _leaf(self, name: str) -> torch.Tensor:
        node = self
        for part in name.split("."):
            node = getattr(node, part)
        return node

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "LM":
        """Draw the weights as the reference's ``LM.init`` does (norms and
        ``mix`` one, biases and ``dt_bias`` zero, ``A_log`` zero, ``D`` one,
        matrices N(0, 0.02) with the output projections scaled by
        1/sqrt(2 n_layers), top-level leaves N(0, 0.02)), from
        ``generator``, which must live on the LM's device. Each leaf is drawn
        in place (``normal_``, computed in f32 and rounded to the leaf's
        dtype), so no temporary the size of a leaf exists: at
        deepseek_moe_16b's widths one expert leaf is 10 GB in bf16. The
        numbers differ from JAX's: carry a JAX tree across with
        ``lm_params_from_numpy``."""
        for name in param_shapes(self.cfg):
            base = name.split(".")[-1]
            leaf = self._leaf(name)
            if not name.startswith("blocks."):
                leaf.normal_(0.0, 0.02, generator=generator)
            elif base in ("ln1", "ln2", "norm", "mix", "D"):
                leaf.fill_(1)
            elif base in ("dt_bias", "A_log") or base.startswith("b"):
                leaf.zero_()
            else:
                scale = 0.02
                if base in ("wo", "w_down", "w_out"):
                    scale = 0.02 / math.sqrt(2 * self.cfg.n_layers)
                leaf.normal_(0.0, scale, generator=generator)
        if not self.cfg.is_attention_free:
            self._mask_dead_heads()
        return self

    def _dead_head_mask(self) -> torch.Tensor:
        """[h_pad] 1.0 for real q-head slots, 0.0 for padding slots."""
        plan, cfg = self.plan, self.cfg
        gs = cfg.n_heads // cfg.n_kv_heads
        gs_p = plan.h_pad // (plan.kv_virtual // plan.repl)
        slot = torch.arange(plan.h_pad, device=self.device)
        grp, r = slot // gs_p, slot % gs_p
        return ((grp < cfg.n_kv_heads) & (r < gs)).float()

    @torch.no_grad()
    def _mask_dead_heads(self) -> None:
        """Zero wo rows of padded q-head slots => padding never affects
        the function (heads compute garbage that is multiplied by zero)."""
        mask = self._dead_head_mask()
        hd, d = self.cfg.head_dim, self.cfg.d_model
        wo = self.blocks.attn.wo
        wom = wo.reshape(wo.shape[0], -1, hd, d) * mask[None, :, None, None]
        wo.copy_(wom.reshape(wo.shape))

    def _layers(self) -> List[Params]:
        """Every layer's parameters as the reference's per-layer tree of
        views: [{"ln1": ..., "attn": {"wq": ...}, ...}, ...]. Each stacked
        leaf is unbound once, so a backward stacks each leaf's gradient
        once (indexing ``t[i]`` per layer would add a zero tensor the size
        of the whole leaf per layer)."""
        out: List[Params] = [{} for _ in range(self.cfg.n_layers)]
        for name, t in self.blocks.named_parameters():
            *path, leaf = name.split(".")
            for tree, ti in zip(out, t.unbind(0)):
                node = tree
                for part in path:
                    node = node.setdefault(part, {})
                node[leaf] = ti
        return out

    # ------------------------------------------------------------ forward
    def _block(self, p: Params, x: torch.Tensor, positions: torch.Tensor,
               cache: Optional[Params], window: int,
               want_cache: bool = False,
               ) -> Tuple[torch.Tensor, Params, Any]:
        """Returns (x, new_cache, aux_loss); the aux loss is an f32 tensor
        under MoE and 0.0 otherwise (no launch on a decode step)."""
        cfg = self.cfg
        aux: Any = 0.0
        h = layers.rmsnorm(x, p["ln1"], cfg.norm_eps)
        new_cache: Dict[str, Any] = {}
        impl = cfg.attn_impl if cache is None else "blockwise"
        if cfg.family in ("dense", "moe", "audio", "vlm"):
            a, kv = layers.attention_layer(
                cfg, self.plan, p["attn"], h, positions,
                cache=cache.get("attn") if cache else None, window=window,
                impl=impl)
            x = x + a
            new_cache["attn_kv"] = kv
        elif cfg.family == "ssm":
            a, sc = layers.ssm_layer(cfg, p["ssm"], h,
                                     cache=cache.get("ssm") if cache else None,
                                     want_cache=want_cache)
            x = x + a
            new_cache["ssm"] = sc
        elif cfg.family == "hybrid":
            a, kv = layers.attention_layer(
                cfg, self.plan, p["attn"], h, positions,
                cache=cache.get("attn") if cache else None, window=window,
                impl=impl)
            s_out, sc = layers.ssm_layer(
                cfg, p["ssm"], h, cache=cache.get("ssm") if cache else None,
                want_cache=want_cache)
            # f32 as in the reference (a bf16 tensor times an f32 array
            # promotes there; torch would keep bf16 for a 0-d operand)
            mix = p["mix"].float()
            x = x + (a.float() * mix[0]
                     + s_out.float() * mix[1]).to(x.dtype) * 0.5
            new_cache["attn_kv"] = kv
            new_cache["ssm"] = sc
        else:
            raise ValueError(cfg.family)
        if cfg.n_experts:
            h2 = layers.rmsnorm(x, p["ln2"], cfg.norm_eps)
            mo, aux = layers.moe_layer(cfg, p["moe"], h2)
            x = x + mo
        elif cfg.d_ff:
            h2 = layers.rmsnorm(x, p["ln2"], cfg.norm_eps)
            x = x + layers.swiglu(p["mlp"], h2, bias=cfg.mlp_bias)
        return x, new_cache, aux

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        x = layers.rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        lg = (x @ head).float()
        # mask padded vocab slots
        valid = torch.arange(self.vocab_pad, device=x.device) < self.cfg.vocab
        return torch.where(valid, lg, -1e30)

    def _inputs(self, tokens: Optional[torch.Tensor],
                embeds: Optional[torch.Tensor]) -> torch.Tensor:
        parts = []
        if embeds is not None:
            parts.append(embeds.to(self.dtype))
        if tokens is not None:
            parts.append(self.embed_tokens(tokens))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def forward(self, tokens: Optional[torch.Tensor],
                embeds: Optional[torch.Tensor] = None, window: int = 0,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward. Returns (hidden [B,S,D], aux_loss), the
        aux loss summed over the layers (zero without MoE). With grad mode
        on and ``cfg.remat``, each block is recomputed in the backward."""
        x = self._inputs(tokens, embeds)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for lp in self._layers():
            if remat:
                x, aux = checkpoint(self._fwd_block, x, aux, lp, positions,
                                    window, use_reentrant=False)
            else:
                x, aux = self._fwd_block(x, aux, lp, positions, window)
        return x, aux

    def _fwd_block(self, x, aux, lp, positions, window):
        x, _, a = self._block(lp, x, positions, cache=None, window=window)
        return x, aux + a

    # ------------------------------------------------------------ training
    def loss_fn(self, batch: Dict[str, torch.Tensor],
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The reference's loss: mean CE over the text positions whose label
        is >= 0 (prepended frontend embeds carry no loss), plus
        ``router_aux_weight`` times the aux loss per layer. ``batch`` holds
        ``labels`` [B,T] and ``tokens`` and/or ``embeds``. Returns
        (loss, {"ce", "aux"}), f32 scalars."""
        cfg = self.cfg
        x, aux = self.forward(batch.get("tokens"), batch.get("embeds"),
                              window=cfg.attn_window)
        labels = batch["labels"]
        lg = self.logits(x[:, -labels.shape[1]:, :])          # f32
        lse = torch.logsumexp(lg, dim=-1)
        # gather raises on a label of -1 (JAX's take_along_axis does not):
        # clamp it, and the mask zeroes its term
        gold = torch.gather(lg, -1, labels.clamp(min=0).long()[..., None]
                            )[..., 0]
        mask = (labels >= 0).float()
        ce = torch.sum((lse - gold) * mask) / torch.clamp(mask.sum(), min=1.0)
        loss = ce + cfg.router_aux_weight * aux / max(cfg.n_layers, 1)
        return loss, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------- decode
    def cache_shapes(self, batch: int, window: int
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """Shapes and dtypes of the decode cache (ring buffer of
        ``window``)."""
        cfg = self.cfg
        dt, L = self.dtype, cfg.n_layers
        out: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
        if not cfg.is_attention_free:
            kvh, hd = self.plan.kv_virtual, cfg.head_dim
            kv_dt = torch.int8 if cfg.kv_quant else dt
            out["k"] = ((L, batch, window, kvh, hd), kv_dt)
            out["v"] = ((L, batch, window, kvh, hd), kv_dt)
            if cfg.kv_quant:
                out["k_scale"] = ((L, batch, window, kvh), torch.float32)
                out["v_scale"] = ((L, batch, window, kvh), torch.float32)
            out["pos"] = ((L, batch, window), torch.int32)
        if cfg.has_ssm:
            h, hp, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
            di, k = h * hp, cfg.d_conv
            out["state"] = ((L, batch, h, hp, n), torch.float32)
            out["conv_x"] = ((L, batch, k - 1, di), dt)
            out["conv_B"] = ((L, batch, k - 1, n), dt)
            out["conv_C"] = ((L, batch, k - 1, n), dt)
        return out

    def init_cache(self, batch: int, window: int) -> Params:
        out = {}
        for k, (shape, dt) in self.cache_shapes(batch, window).items():
            if k == "pos":    # never-written slots are masked out by position
                out[k] = torch.full(shape, 2 ** 30, dtype=dt,
                                    device=self.device)
            else:
                out[k] = torch.zeros(shape, dtype=dt, device=self.device)
        return out

    def _write_kv(self, cache: Params, i: int, slots, k: torch.Tensor,
                  v: torch.Tensor) -> None:
        """Write layer ``i``'s k/v [B, n, KV, hd] into ring ``slots`` (an
        int or n slot indices), quantized to int8 with their scales under
        ``kv_quant``."""
        if self.cfg.kv_quant:
            k, ks = layers.quantize_kv(k)
            v, vs = layers.quantize_kv(v)
            cache["k_scale"][i][:, slots] = ks
            cache["v_scale"][i][:, slots] = vs
        cache["k"][i][:, slots] = k
        cache["v"][i][:, slots] = v

    @torch.no_grad()
    def decode_step(self, cache: Params, tokens: torch.Tensor, t: int,
                    ) -> Tuple[torch.Tensor, Params]:
        """One token for the whole batch. tokens: [B,1]; t: the current
        absolute position. Ring-buffer insert at t % window. Updates
        ``cache`` in place and returns (logits [B,1,Vp], cache)."""
        cfg = self.cfg
        t = int(t)
        x = self.embed_tokens(tokens)
        b = x.shape[0]
        positions = torch.full((b, 1), t, dtype=torch.int32, device=x.device)
        if not cfg.is_attention_free:
            slot = t % cache["k"].shape[2]
        aw = cfg.attn_window if cfg.attn_window else 0
        for i, lp in enumerate(self._layers()):
            layer_cache: Dict[str, Any] = {}
            if not cfg.is_attention_free:
                k, v = cache["k"][i], cache["v"][i]
                if cfg.kv_quant:
                    k = layers.dequantize_kv(k, cache["k_scale"][i],
                                             self.dtype)
                    v = layers.dequantize_kv(v, cache["v_scale"][i],
                                             self.dtype)
                layer_cache["attn"] = {"k": k, "v": v, "pos": cache["pos"][i]}
            if cfg.has_ssm:
                layer_cache["ssm"] = {
                    "state": cache["state"][i], "conv_x": cache["conv_x"][i],
                    "conv_B": cache["conv_B"][i],
                    "conv_C": cache["conv_C"][i]}
            x, nc, _ = self._block(lp, x, positions, layer_cache, window=aw)
            if not cfg.is_attention_free:
                self._write_kv(cache, i, slot, nc["attn_kv"]["k"][:, 0],
                               nc["attn_kv"]["v"][:, 0])
                cache["pos"][i, :, slot] = t
            if cfg.has_ssm:
                for key in ("state", "conv_x", "conv_B", "conv_C"):
                    cache[key][i] = nc["ssm"][key]
        return self.logits(x), cache

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor,
                embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Prefill forward; returns last-position logits [B,1,V]."""
        x, _ = self.forward(tokens, embeds, window=self.cfg.attn_window)
        return self.logits(x[:, -1:, :])

    @torch.no_grad()
    def prefill_with_cache(self, tokens: Optional[torch.Tensor],
                           embeds: Optional[torch.Tensor] = None,
                           window: Optional[int] = None,
                           ) -> Tuple[torch.Tensor, Params]:
        """Prefill that also materializes the decode cache (ring buffer of
        ``window`` slots; decode continues at t = prompt length).
        Returns (last logits [B,1,Vp], cache). Each layer's k/v goes
        straight into its ring slots (the reference stacks all layers
        first)."""
        cfg = self.cfg
        x = self._inputs(tokens, embeds)
        b, s, _ = x.shape
        if window is None:
            window = min(s, cfg.attn_window) if cfg.attn_window else s
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        cache = self.init_cache(b, window)
        take = min(window, s)
        src = torch.arange(s - take, s, device=x.device)
        slots = src % window
        for i, lp in enumerate(self._layers()):
            x, nc, _ = self._block(lp, x, positions, cache=None,
                                   window=cfg.attn_window, want_cache=True)
            if not cfg.is_attention_free:
                self._write_kv(cache, i, slots,
                               nc["attn_kv"]["k"][:, s - take:s],
                               nc["attn_kv"]["v"][:, s - take:s])
                cache["pos"][i][:, slots] = src.to(torch.int32)
            if cfg.has_ssm:
                for key in ("state", "conv_x", "conv_B", "conv_C"):
                    cache[key][i] = nc["ssm"][key]
        return self.logits(x[:, -1:, :]), cache
