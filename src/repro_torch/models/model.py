"""The LM in torch: parameters, forward, logits, prefill and decode (a copy
of the JAX package's ``models/model.py`` for the dense, MoE, SSM and hybrid
families, including ``audio``/``vlm`` fed tokens or embeddings, which take
the dense block, and the int8 KV cache of ``kv_quant=True``).

The parameters keep the reference's tree: ``blocks.*`` stacked on a
leading layer axis, plus ``embed``, ``final_norm`` and ``lm_head``, each
in the reference's [in, out] layout (routed experts [E, in, out]);
``state_dict()`` keys are the tree's paths joined by dots
(``blocks.attn.wq``, ``blocks.moe.shared.w_up``), which is what
``repro_torch.convert.lm_params_from_numpy`` produces. Without a mesh
the LM runs on one GPU: it reads the head plan at tp=1, there are no
sharding constraints, and ``fsdp_experts`` (the reference's FSDP sharding
of expert weights over the data axes) has nothing to shard, every expert
living on the one card. On a mesh (below) the routed experts [E, in,
out] are split over "model", and under ``fsdp_experts`` their ``in``
axis over the data axes too, as the reference's specs lay them out; the
MoE layer all-gathers them at use. The dry run
(``repro_torch.launch.dryrun``) builds the LM on the meta device at a
mesh's TP degree (``LM(cfg, "meta", tp=16)``: the reference's padded
head plan and vocabulary), and reads each leaf's layout from
:func:`param_specs` and :func:`cache_specs`.

The partitioned LM, ``LM(cfg, device, mesh=dm)`` with a ``DeviceMesh``
``dm`` of axes ("data", "model") or ("pod", "data", "model")
(``repro_torch.launch.mesh.device_mesh``), holds every parameter as a
DTensor laid out by :func:`param_specs` (``sharding.placements``), whose
local shard lives on ``device``: meta for the partitioned dry run, cuda
for one rank's shard on the card. Its inputs are DTensors laid out by the
reference's input specs (:meth:`LM.rows` for a rank's data shard,
:meth:`LM.split_rows` for a batch every rank holds), and the reference's
sharding constraints become ``redistribute`` calls at the reference's
points: the residual stream at the forward's and the prefill's entry and
at each block's end (``_act_spec``), the head as (None, "vocab") before
the logits. Plain tensors the methods make (positions, masks, scalars)
count as replicated: a caller runs them under :meth:`LM.sharded`
(``implicit_replication``). Without a mesh none of this runs.
The layers run in a Python loop over the stacked layer axis (the
reference scans), and ``decode_step`` updates the
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

import contextlib
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import layers
from .config import ModelConfig
from .sharding import (AttnPlan, Spec, pad_to, placements, plan_attention,
                       shard_shape, spec, tp_size)

Params = Dict[str, Any]
_F32_LEAVES = ("dt_bias", "A_log", "D")   # f32 whatever the model dtype


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class _ToResidual(torch.autograd.Function):
    """``a`` redistributed to the residual's placements; the gradient
    redistributed to ``back`` (replicated over "model"), not to ``a``'s
    partial layout: no product's backward then flattens a gradient whose
    sequence is split, which DTensor refuses in some versions."""

    @staticmethod
    def forward(ctx, a, mesh, target, back):
        ctx.mesh, ctx.back = mesh, back
        return a.redistribute(mesh, target)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.back), None, None, None


class _Relayout(torch.autograd.Function):
    """``x`` redistributed to ``target``; its gradient laid out back as
    ``x`` except where it is a partial sum over an axis that replicates
    ``x``, which stays partial: a weight's gradient is summed over the
    data axes once, in the train step's layout."""

    @staticmethod
    def forward(ctx, x, mesh, target):
        ctx.mesh, ctx.src = mesh, tuple(x.placements)
        return x.redistribute(mesh, target)

    @staticmethod
    def backward(ctx, g):
        back = [gp if (sp.is_replicate() and gp.is_partial()) else sp
                for sp, gp in zip(ctx.src, g.placements)]
        return g.redistribute(ctx.mesh, back), None, None


def _contiguous_strides(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "ssm", "hybrid", "audio", "vlm"):
        raise ValueError(cfg.family)


def _block_leaves(cfg: ModelConfig, plan: Optional[AttnPlan]
                  ) -> Dict[str, Tuple[Tuple[int, ...], Tuple[Any, ...]]]:
    """Leaf name -> (shape, logical axes) for ONE block (unstacked), in the
    reference's order (the order ``LM.init`` draws them in)."""
    d, hd = cfg.d_model, cfg.head_dim
    out: Dict[str, Tuple[Tuple[int, ...], Tuple[Any, ...]]] = {}

    def add(name, shape, *axes):
        out[name] = (shape, axes)

    add("ln1", (d,), None)
    if not cfg.is_attention_free:
        add("attn.wq", (d, plan.h_pad * hd), None, "model")
        add("attn.wk", (d, plan.kv_virtual * hd), None, "model")
        add("attn.wv", (d, plan.kv_virtual * hd), None, "model")
        add("attn.wo", (plan.h_pad * hd, d), "model", None)
        if cfg.qkv_bias:
            add("attn.bq", (plan.h_pad * hd,), "model")
            add("attn.bk", (plan.kv_virtual * hd,), "model")
            add("attn.bv", (plan.kv_virtual * hd,), "model")
    if cfg.has_ssm:
        h, hp, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        di = h * hp
        add("ssm.w_z", (d, di), None, "model")
        add("ssm.w_x", (d, di), None, "model")
        add("ssm.w_B", (d, n), None, None)
        add("ssm.w_C", (d, n), None, None)
        add("ssm.w_dt", (d, h), None, None)
        add("ssm.conv_x", (cfg.d_conv, di), None, "model")
        add("ssm.conv_B", (cfg.d_conv, n), None, None)
        add("ssm.conv_C", (cfg.d_conv, n), None, None)
        add("ssm.dt_bias", (h,), None)
        add("ssm.A_log", (h,), None)
        add("ssm.D", (h,), None)
        add("ssm.norm", (di,), "model")
        add("ssm.w_out", (di, d), "model", None)
    if cfg.family == "hybrid":
        add("mix", (2,), None)
    if cfg.n_experts:
        e, f = cfg.n_experts, cfg.d_ff
        dax = "fsdp" if cfg.fsdp_experts else None
        add("ln2", (d,), None)
        add("moe.router", (d, e), None, None)
        add("moe.w_gate", (e, d, f), "expert", dax, None)
        add("moe.w_up", (e, d, f), "expert", dax, None)
        add("moe.w_down", (e, f, d), "expert", dax, None)
        if cfg.n_shared_experts:
            fs = cfg.n_shared_experts * f
            add("moe.shared.w_gate", (d, fs), None, "model")
            add("moe.shared.w_up", (d, fs), None, "model")
            add("moe.shared.w_down", (fs, d), "model", None)
    elif cfg.d_ff:
        add("ln2", (d,), None)
        add("mlp.w_gate", (d, cfg.d_ff), None, "model")
        add("mlp.w_up", (d, cfg.d_ff), None, "model")
        add("mlp.w_down", (cfg.d_ff, d), "model", None)
        if cfg.mlp_bias:
            add("mlp.b_gate", (cfg.d_ff,), "model")
            add("mlp.b_up", (cfg.d_ff,), "model")
            add("mlp.b_down", (d,), None)
    return out


def _top_leaves(cfg: ModelConfig, vocab_pad: int
                ) -> Dict[str, Tuple[Tuple[int, ...], Tuple[Any, ...]]]:
    """embed is d-sharded (local gather); lm_head is vocab-sharded."""
    out = {"embed": ((vocab_pad, cfg.d_model), (None, "model")),
           "final_norm": ((cfg.d_model,), (None,))}
    if not cfg.tie_embeddings:
        out["lm_head"] = ((cfg.d_model, vocab_pad), (None, "vocab"))
    return out


def _layout(cfg: ModelConfig, tp: int) -> Tuple[Optional[AttnPlan], int]:
    """The reference's head plan and padded vocabulary at TP degree ``tp``,
    with its checks (``src/repro/models/model.py`` ``LM.__init__``)."""
    _check_supported(cfg)
    plan = None if cfg.is_attention_free else plan_attention(
        cfg.n_heads, cfg.n_kv_heads, tp)
    if cfg.has_ssm and (cfg.ssm_heads * cfg.ssm_head_dim) % tp:
        raise ValueError(f"{cfg.name}: ssm heads*dim "
                         f"{cfg.ssm_heads * cfg.ssm_head_dim} must divide "
                         f"TP {tp}")
    if cfg.d_ff and cfg.d_ff % tp:
        raise ValueError(f"{cfg.name}: d_ff {cfg.d_ff} must divide TP {tp}")
    return plan, pad_to(cfg.vocab, tp)


def param_shapes(cfg: ModelConfig, tp: int = 1
                 ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Every parameter of the LM of ``cfg`` at TP degree ``tp``: dotted
    name -> (shape, dtype), block leaves stacked on a leading ``n_layers``
    axis. The names are the JAX parameter tree's paths joined by dots.
    ``dt_bias``, ``A_log`` and ``D`` are f32 whatever the model dtype, as
    the reference's ``LM.init`` makes them (its ``param_shapes`` writes
    the model dtype for them)."""
    plan, vocab_pad = _layout(cfg, tp)
    dt, L = _dtype(cfg), cfg.n_layers
    out = {}
    for name, (shape, _) in _block_leaves(cfg, plan).items():
        leaf_dt = torch.float32 if name.split(".")[-1] in _F32_LEAVES else dt
        out[f"blocks.{name}"] = ((L, *shape), leaf_dt)
    for name, (shape, _) in _top_leaves(cfg, vocab_pad).items():
        out[name] = (shape, dt)
    return out


def param_specs(cfg: ModelConfig, mesh: Any) -> Dict[str, Spec]:
    """Every parameter's spec on ``mesh``, keyed as :func:`param_shapes`
    (the reference's ``LM.param_specs``; block leaves carry a replicated
    leading layer axis)."""
    plan, vocab_pad = _layout(cfg, tp_size(mesh))
    out = {f"blocks.{name}": spec(mesh, None, *axes)
           for name, (_, axes) in _block_leaves(cfg, plan).items()}
    out.update({name: spec(mesh, *axes)
                for name, (_, axes) in _top_leaves(cfg, vocab_pad).items()})
    return out


def cache_specs(cfg: ModelConfig, mesh: Any, batch: Optional[int] = None
                ) -> Dict[str, Spec]:
    """The decode cache's specs on ``mesh``, keyed as
    :meth:`LM.cache_shapes` (the reference's ``LM.cache_specs``);
    ``batch=1`` (long_500k) falls back to a replicated batch axis."""
    m, bs = mesh, batch
    out: Dict[str, Spec] = {}
    if not cfg.is_attention_free:
        out["k"] = spec(m, None, "batch", None, "model", None, batch_size=bs)
        out["v"] = spec(m, None, "batch", None, "model", None, batch_size=bs)
        if cfg.kv_quant:
            out["k_scale"] = spec(m, None, "batch", None, "model",
                                  batch_size=bs)
            out["v_scale"] = spec(m, None, "batch", None, "model",
                                  batch_size=bs)
        out["pos"] = spec(m, None, "batch", None, batch_size=bs)
    if cfg.has_ssm:
        out["state"] = spec(m, None, "batch", "model", None, None,
                            batch_size=bs)
        out["conv_x"] = spec(m, None, "batch", None, "model", batch_size=bs)
        out["conv_B"] = spec(m, None, "batch", None, None, batch_size=bs)
        out["conv_C"] = spec(m, None, "batch", None, None, batch_size=bs)
    return out


class LM(nn.Module):
    """The LM of ``cfg`` on ``device`` (default: the port's default
    device, ``cuda`` unless ``repro_torch.set_default_device("cpu")``).
    Parameters start uninitialised: fill them with :meth:`init` or
    ``load_state_dict(convert.lm_params_from_numpy(tree, cfg))``.

    ``tp`` is the TP degree whose head plan and padded vocabulary the
    parameters take. One device runs tp=1; only the meta device builds a
    larger one (the dry run's), and a real device with ``tp > 1`` raises
    ``ValueError``. ``mesh`` (a ``DeviceMesh``) builds the partitioned
    LM at the mesh's TP degree, on any device (see the module's
    docstring); ``tp`` is then the mesh's "model" size."""

    def __init__(self, cfg: ModelConfig, device=None, tp: int = 1,
                 mesh: Any = None):
        super().__init__()
        self.device = (torch.device(device) if device is not None
                       else resolve_device())
        self.mesh = mesh
        if mesh is not None:
            from ..launch.mesh import logical_mesh
            self.spec_mesh = logical_mesh(mesh)
            tp = tp_size(self.spec_mesh)
            layers.register_shardings()
        elif tp != 1 and self.device.type != "meta":
            raise ValueError(f"LM(tp={tp}) on {self.device}: a padded "
                             f"tensor-parallel plan is built on the meta "
                             f"device only (one device runs tp=1)")
        shapes = param_shapes(cfg, tp)
        specs = param_specs(cfg, self.spec_mesh) if mesh is not None else {}
        self.cfg = cfg
        self.tp = tp
        self.plan, self.vocab_pad = _layout(cfg, tp)
        self.dtype = _dtype(cfg)
        for name, (shape, dt) in shapes.items():
            *path, leaf = name.split(".")
            node = self
            for part in path:
                if not hasattr(node, part):
                    node.add_module(part, nn.Module())
                node = getattr(node, part)
            if mesh is None:
                t = torch.empty(shape, dtype=dt, device=self.device)
            else:
                t = self.sharded_empty(shape, dt, specs[name])
            node.register_parameter(leaf, nn.Parameter(t, requires_grad=False))

    # --------------------------------------------------------- partitioned
    def sharded_empty(self, shape: Tuple[int, ...], dtype: torch.dtype,
                      sp: Spec) -> torch.Tensor:
        """An uninitialised DTensor of global ``shape`` laid out by ``sp`` on
        the LM's mesh, its local shard (``shard_shape``) on the LM's
        device."""
        from torch.distributed.tensor import DTensor
        local = torch.empty(shard_shape(tuple(shape), sp, self.spec_mesh),
                            dtype=dtype, device=self.device)
        return DTensor.from_local(local, self.mesh,
                                  placements(sp, self.mesh),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=_contiguous_strides(shape))

    def sharded_zeros(self, shapes: Any, specs: Any) -> Any:
        """Zero DTensors of a tree of ``(shape, dtype)`` leaves, each laid
        out by the matching leaf of ``specs`` (:meth:`sharded_empty`)."""
        if isinstance(shapes, dict):
            return {k: self.sharded_zeros(shapes[k], specs[k])
                    for k in shapes}
        shape, dtype = shapes
        t = self.sharded_empty(tuple(shape), dtype, specs)
        t._local_tensor.zero_()
        return t

    def _constrain(self, x: torch.Tensor, sp: Spec) -> torch.Tensor:
        """The reference's ``with_sharding_constraint``: ``x`` laid out by
        ``sp`` (a ``redistribute``). Where ``x`` is laid out so already it
        is returned as it is: a redistribute's backward would lay the
        gradient out as ``x`` (all-reducing a partial one)."""
        want = placements(sp, self.mesh)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(self.mesh, want)

    def _rows(self, make, b: int) -> torch.Tensor:
        """``make(b)``, a tensor whose leading axis is the batch's; on the
        mesh a DTensor whose batch follows the residual stream's layout,
        each rank making its own rows (every row the same)."""
        if self.mesh is None:
            return make(b)
        from torch.distributed.tensor import DTensor
        sp = spec(self.spec_mesh, "batch", batch_size=b)
        local = make(shard_shape((b,), sp, self.spec_mesh)[0])
        pl = placements(sp + (None,) * (local.dim() - 1), self.mesh)
        shape = (b,) + tuple(local.shape[1:])
        return DTensor.from_local(local, self.mesh, pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=_contiguous_strides(shape))

    def rows(self, local: torch.Tensor, batch: int) -> torch.Tensor:
        """``local``, this rank's rows of a tensor whose leading axis is a
        batch of ``batch`` rows (a data shard of a training batch), as the
        tensor the LM reads: on the mesh a DTensor split over the data
        axes as the residual stream is; ``local`` itself without a mesh."""
        def make(n):
            if local.shape[0] != n:
                raise ValueError(f"LM.rows: {local.shape[0]} local rows of "
                                 f"a batch of {batch}; this rank holds {n}")
            return local
        return self._rows(make, batch)

    def split_rows(self, whole: torch.Tensor) -> torch.Tensor:
        """``whole``, a batch that every rank holds alike (prompts), as
        the tensor the LM reads: on the mesh each rank keeps its rows
        (no collective); ``whole`` itself without a mesh."""
        if self.mesh is None:
            return whole
        from torch.distributed.tensor import distribute_tensor
        b = whole.shape[0]
        sp = spec(self.spec_mesh, "batch", *(None,) * (whole.dim() - 1),
                  batch_size=b)
        return distribute_tensor(whole, self.mesh, placements(sp, self.mesh),
                                 src_data_rank=None)

    def sharded(self):
        """The context a partitioned step runs in: plain tensors made inside
        it (positions, masks, scalars) count as replicated
        (``implicit_replication``). Nothing without a mesh."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import implicit_replication
        return implicit_replication()

    def _gathered(self, h: torch.Tensor) -> torch.Tensor:
        """A normed input as the products after it read it (a block's, the
        head's): batch over the data axes, sequence and features whole
        (under ``seq_shard`` the sequence-parallel all-gather). Made once,
        where XLA shares one gather among the projections; eager DTensor
        would gather for each product, or refuse to flatten a sharded
        sequence. The identity without a mesh."""
        if self.mesh is None:
            return h
        b = h.shape[0]
        return self._constrain(h, spec(self.spec_mesh, "batch", None, None,
                                       batch_size=b))

    def _scattered(self, a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """A row-parallel output (a partial sum over "model") laid out as
        the residual ``x`` it is added to: a reduce-scatter under
        ``seq_shard`` (an all-reduce where the sequence is whole), whose
        backward gathers the gradient over "model", as Megatron's sequence
        parallelism pairs them (``_ToResidual``). The identity without a
        mesh."""
        if self.mesh is None:
            return a
        back = placements(spec(self.spec_mesh, "batch", None, None,
                               batch_size=x.shape[0]), self.mesh)
        return _ToResidual.apply(a, self.mesh, tuple(x.placements), back)

    def _act_spec(self, x: torch.Tensor) -> Spec:
        """Residual-stream sharding: batch over the data axes (when
        divisible); sequence over the model axis under ``seq_shard``."""
        b, s, _ = x.shape
        seq_ax = "model" if (self.cfg.seq_shard and s > 1
                             and s % self.tp == 0) else None
        return spec(self.spec_mesh, "batch", seq_ax, None, batch_size=b)

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
        ``generator``, which must live on the LM's device. Without a mesh
        each leaf is drawn in place (``normal_``, computed in f32 and
        rounded to the leaf's dtype), so no temporary the size of a leaf
        exists: at deepseek_moe_16b's widths one expert leaf is 10 GB in
        bf16. The numbers differ from JAX's: carry a JAX tree across with
        ``lm_params_from_numpy``.

        On a mesh over a real process group (a host world) every rank
        draws each whole leaf in the same order, so, one leaf-sized
        temporary at a time, and keeps its shard: the global weights are
        one device's from the same seed, bit for bit, whatever the mesh's
        shape (where a mesh's head plan pads the heads, the padded leaves
        differ in shape). On the meta device or a ``fake`` world, whose
        values nothing reads, each rank draws its own local shard."""
        whole = self._draws_whole()
        for name in param_shapes(self.cfg, self.tp):
            base = name.split(".")[-1]
            leaf = self._leaf(name)
            local = leaf.to_local() if self.mesh is not None else leaf
            if not name.startswith("blocks."):
                std = 0.02
            elif base in ("ln1", "ln2", "norm", "mix", "D"):
                local.fill_(1)
                continue
            elif base in ("dt_bias", "A_log") or base.startswith("b"):
                local.zero_()
                continue
            elif base in ("wo", "w_down", "w_out"):
                std = 0.02 / math.sqrt(2 * self.cfg.n_layers)
            else:
                std = 0.02
            if whole:
                from torch.distributed.tensor import distribute_tensor
                t = torch.empty(leaf.shape, dtype=leaf.dtype,
                                device=self.device)
                t.normal_(0.0, std, generator=generator)
                local.copy_(distribute_tensor(
                    t, self.mesh, leaf.placements,
                    src_data_rank=None).to_local())
                del t
            else:
                local.normal_(0.0, std, generator=generator)
        if not self.cfg.is_attention_free:
            self._mask_dead_heads()
        return self

    def _draws_whole(self) -> bool:
        """Whether :meth:`init` draws whole leaves: on a mesh over a real
        process group (not the meta device, not a ``fake`` world)."""
        if self.mesh is None or self.device.type == "meta":
            return False
        import torch.distributed as dist
        return dist.get_backend() != "fake"

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
        if self.mesh is not None:       # this rank's heads, split over "model"
            m = self.mesh.mesh_dim_names.index("model")
            n = mask.numel() // self.mesh.size(m)
            r = self.mesh.get_local_rank(m)
            wo, mask = wo.to_local(), mask[r * n:(r + 1) * n]
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
        h = self._gathered(layers.rmsnorm(x, p["ln1"], cfg.norm_eps))
        new_cache: Dict[str, Any] = {}
        impl = cfg.attn_impl if cache is None else "blockwise"
        if cfg.family in ("dense", "moe", "audio", "vlm"):
            a, kv = layers.attention_layer(
                cfg, self.plan, p["attn"], h, positions,
                cache=cache.get("attn") if cache else None, window=window,
                impl=impl)
            x = x + self._scattered(a, x)
            new_cache["attn_kv"] = kv
        elif cfg.family == "ssm":
            a, sc = layers.ssm_layer(cfg, p["ssm"], h,
                                     cache=cache.get("ssm") if cache else None,
                                     want_cache=want_cache)
            x = x + self._scattered(a, x)
            new_cache["ssm"] = sc
        elif cfg.family == "hybrid":
            a, kv = layers.attention_layer(
                cfg, self.plan, p["attn"], h, positions,
                cache=cache.get("attn") if cache else None, window=window,
                impl=impl)
            s_out, sc = layers.ssm_layer(
                cfg, p["ssm"], h, cache=cache.get("ssm") if cache else None,
                want_cache=want_cache)
            x = x + self._scattered(
                layers.hybrid_mix(a, s_out, p["mix"], x.dtype), x)
            new_cache["attn_kv"] = kv
            new_cache["ssm"] = sc
        else:
            raise ValueError(cfg.family)
        if cfg.n_experts:
            h2 = self._gathered(layers.rmsnorm(x, p["ln2"], cfg.norm_eps))
            mo, aux = layers.moe_layer(cfg, p["moe"], h2)
            x = x + self._scattered(mo, x)
        elif cfg.d_ff:
            h2 = self._gathered(layers.rmsnorm(x, p["ln2"], cfg.norm_eps))
            x = x + self._scattered(
                layers.swiglu(p["mlp"], h2, bias=cfg.mlp_bias), x)
        if self.mesh is not None:
            x = self._constrain(x, self._act_spec(x))
        return x, new_cache, aux

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return layers.embed_lookup(self.embed, tokens)

    def logits(self, x: torch.Tensor, keep: Optional[int] = None
               ) -> torch.Tensor:
        """The last ``keep`` positions' logits (all with None). On a mesh
        that splits the sequence the final norm runs on the split residual
        before the gather and the slice, so the norm's gradient is
        reduce-scattered, not all-reduced."""
        if self.mesh is not None and any(
                p.is_shard(1) and self.mesh.size(i) > 1
                for i, p in enumerate(x.placements)):
            x = self._gathered(layers.rmsnorm(x, self.final_norm,
                                              self.cfg.norm_eps))
            x = x if keep is None else x[:, -keep:, :]
        else:
            x = x if keep is None else x[:, -keep:, :]
            x = self._gathered(layers.rmsnorm(x, self.final_norm,
                                              self.cfg.norm_eps))
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        if self.mesh is not None:
            # the contraction axis d unsharded, the vocabulary over "model";
            # the gradient stays a partial sum over the data axes until the
            # train step lays it out (a redistribute would all-reduce it)
            want = placements(spec(self.spec_mesh, None, "vocab"), self.mesh)
            if tuple(head.placements) != want:
                head = _Relayout.apply(head, self.mesh, want)
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
        if self.mesh is not None:
            x = self._constrain(x, self._act_spec(x))
        b, s, _ = x.shape
        positions = self._rows(lambda n: torch.arange(
            s, device=self.device)[None, :].expand(n, s), b)
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
        lg = self.logits(x, keep=labels.shape[1])             # f32
        lse, gold = layers.ce_terms(lg, labels)
        mask = (labels >= 0).float()
        total, count = torch.sum((lse - gold) * mask), mask.sum()
        if self.mesh is not None:
            # both sums over the batch all-reduced, as the reference's
            # replicated loss needs them
            total, count = (self._constrain(t, ()) for t in (total, count))
        ce = total / torch.clamp(count, min=1.0)
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
        if self.mesh is not None:
            specs = cache_specs(self.cfg, self.spec_mesh, batch=batch)
            out = {}
            for k, (shape, dt) in self.cache_shapes(batch, window).items():
                t = self.sharded_empty(shape, dt, specs[k])
                out[k] = t.fill_(2 ** 30) if k == "pos" else t.zero_()
            return out
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
            self._put(cache["k_scale"], i, ks, slots)
            self._put(cache["v_scale"], i, vs, slots)
        self._put(cache["k"], i, k, slots)
        self._put(cache["v"], i, v, slots)

    def _put(self, buf: torch.Tensor, i: int, val: Any, slots=None) -> None:
        """``buf[i][:, slots] = val`` (``buf[i] = val`` without ``slots``):
        a write into layer ``i`` of a cache leaf. On the mesh each rank
        writes its own shard, ``val`` laid out as the written slice (a
        leaf's layer axis is never split); DTensor has no rule for
        ``index_put_`` in some versions and none for ``fill_``."""
        if self.mesh is not None:
            from torch.distributed.tensor import Shard
            if layers.is_sharded(val):
                # buf's dim d is val's d - 1, or d - 2 past a ring slot
                # that an int index drops
                drop = isinstance(slots, int)
                want = [Shard(p.dim - 1 - (drop and p.dim > 2))
                        if p.is_shard() else p for p in buf.placements]
                if tuple(val.placements) != tuple(want):
                    val = val.redistribute(self.mesh, want)
                val = val.to_local()
            buf = buf.to_local()
        if slots is None:
            buf[i] = val
        else:
            buf[i][:, slots] = val

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
        positions = self._rows(lambda n: torch.full(
            (n, 1), t, dtype=torch.int32, device=self.device), b)
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
                self._put(cache["pos"], i, t, slot)
            if cfg.has_ssm:
                for key in ("state", "conv_x", "conv_B", "conv_C"):
                    self._put(cache[key], i, nc["ssm"][key])
        return self.logits(x), cache

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor,
                embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Prefill forward; returns last-position logits [B,1,V]."""
        x, _ = self.forward(tokens, embeds, window=self.cfg.attn_window)
        return self.logits(x, keep=1)

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
        if self.mesh is not None:
            x = self._constrain(x, self._act_spec(x))
        b, s, _ = x.shape
        if window is None:
            window = min(s, cfg.attn_window) if cfg.attn_window else s
        positions = self._rows(lambda n: torch.arange(
            s, device=self.device)[None, :].expand(n, s), b)
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
                self._put(cache["pos"], i, src.to(torch.int32), slots)
            if cfg.has_ssm:
                for key in ("state", "conv_x", "conv_B", "conv_C"):
                    self._put(cache[key], i, nc["ssm"][key])
        return self.logits(x, keep=1), cache
