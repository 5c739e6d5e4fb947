"""AdamW over the port's dict of parameter leaves (a copy of the JAX
package's ``repro.optim.adamw``).

The state is ``{"m", "v", "step"}``: f32 first and second moments keyed as
the parameters are (``blocks.attn.wq``, ...) and an int32 0-d step.
``update`` keeps the reference's order: the global gradient norm in f32
over every leaf before clipping, ``scale = min(1, clip / max(gnorm,
1e-9))``, the learning rate's warm-up read at the step *before* the
increment and the bias corrections at the step after it, weight decay on
every leaf (norms and biases included, as the reference does), and the
update computed in f32 and cast back to the leaf's dtype.

Deliberate difference: ``update`` writes the parameters, m and v in place
(as ``LM.decode_step`` writes its cache), where the reference returns new
trees; so it runs under ``torch.no_grad()``. ``torch.optim.AdamW`` is not
used: its clipping, warm-up and decay differ.

The state's layout on a mesh is the reference's ZeRO-1: ``state_specs``
gives each moment the parameter's spec plus its first unsharded axis that
the data-parallel degree divides, split over the data axes
(``zero1_spec``). On one card the data-parallel degree is 1 and the
layout is the parameter's own. ``launch.steps.opt_state_specs`` applies
it to a model: the training loop lays the moments out so on a host
world's mesh (``launch.steps.init_opt_state``), and the dry run
(``repro_torch.launch.dryrun``) reads it to count each device's bytes of
the state on the reference's production meshes.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, NamedTuple, Tuple

import torch

from .. import tracing
from ..models.layers import is_sharded
from ..models.sharding import Spec, batch_axes, dp_size

State = Dict[str, Any]


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def init(params: Mapping[str, torch.Tensor]) -> State:
    """Zero f32 moments on each leaf's device and an int32 step of 0."""
    dev = next(iter(params.values())).device
    return {"m": {k: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def state_shapes(param_shapes: Mapping[str, Tuple[Tuple[int, ...], Any]]
                 ) -> Dict[str, Any]:
    """(shape, dtype) of every leaf of :func:`init`'s state for parameters
    of ``param_shapes`` (name -> (shape, dtype)): f32 moments, an int32
    0-d step."""
    f32 = {k: (tuple(shape), torch.float32)
           for k, (shape, _) in param_shapes.items()}
    return {"m": f32, "v": dict(f32), "step": ((), torch.int32)}


def zero1_spec(param_spec: Spec, shape: Tuple[int, ...], mesh: Any) -> Spec:
    """Shard the first unsharded, divisible tensor axis over the data axes."""
    dps = batch_axes(mesh)
    dp = dp_size(mesh)
    if dp == 1 or not shape:
        return param_spec
    axes = list(param_spec) + [None] * (len(shape) - len(param_spec))
    # already data-sharded (fsdp weights): nothing more to shard over data
    for ax in axes:
        used = ax if isinstance(ax, tuple) else (ax,)
        if any(a in dps for a in used if a):
            return param_spec
    for i, (ax, dim) in enumerate(zip(axes, shape)):
        if ax is None and dim % dp == 0 and dim > 0:
            axes[i] = dps if len(dps) > 1 else dps[0]
            return tuple(axes)
    return param_spec


def state_specs(param_specs: Mapping[str, Spec],
                param_shapes: Mapping[str, Tuple[Tuple[int, ...], Any]],
                mesh: Any, zero1: bool = True) -> Dict[str, Any]:
    """The state's specs on ``mesh``, keyed as :func:`state_shapes`: with
    ``zero1`` each moment takes :func:`zero1_spec` of its parameter's
    spec, else the parameter's own; the step is replicated."""
    if zero1:
        sharded = {k: zero1_spec(sp, tuple(param_shapes[k][0]), mesh)
                   for k, sp in param_specs.items()}
    else:
        sharded = dict(param_specs)
    return {"m": sharded, "v": dict(sharded), "step": ()}


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr`` over ``warmup_steps``; ``step`` is the
    count of updates made so far (0-d int32)."""
    # a tensor divisor (CUDA divides by a Python scalar as a product with
    # its reciprocal); torch.full fills on the device, with no host copy
    warm = torch.clamp((step + 1).float() / torch.full(
        (), float(cfg.warmup_steps), device=step.device), max=1.0)
    return cfg.lr * warm


def _sum_of_squares(grads: List[torch.Tensor]) -> torch.Tensor:
    """The sum of every leaf's squared entries in f32, 0-d. On DTensors
    (the partitioned LM's gradients, each split or replicated over each
    mesh axis) every rank adds the sums of its local shards, a leaf
    replicated over an axis that splits another leaf counted on that
    axis's first rank only, and the total is all-reduced once over each
    such axis: the same collectives whatever DTensor's version would make
    of a sum of partial sums laid out otherwise (torch 2.11 all-reduces
    each leaf's, 2.13 fewer)."""
    if not is_sharded(grads[0]):
        return sum(torch.sum(torch.square(g.float())) for g in grads)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = grads[0].device_mesh
    if any(p.is_partial() for g in grads for p in g.placements):
        raise ValueError("adamw.update: a gradient laid out as a partial "
                         "sum has no local sum of squares")
    split = [i for i in range(mesh.ndim) if mesh.size(i) > 1 and any(
        g.placements[i].is_shard() for g in grads)]

    def local(g):
        s = torch.sum(torch.square(g.to_local().float()))
        if any(g.placements[i].is_replicate() and mesh.get_local_rank(i)
               for i in split):
            s = torch.zeros_like(s)
        return s

    total = DTensor.from_local(
        sum(local(g) for g in grads), mesh,
        [Partial() if i in split else Replicate() for i in range(mesh.ndim)],
        run_check=False)
    return total.redistribute(mesh, [Replicate()] * mesh.ndim)


def _gathered_to(new: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The updated leaf ``new`` laid out as the parameter ``p``: under
    ZeRO-1 the update is computed on the moments' data shards, and the
    parameter's dtype is all-gathered over the data axes here (an explicit
    ``redistribute``, not the one ``copy_``'s propagation would pick)."""
    if is_sharded(new) and tuple(new.placements) != tuple(p.placements):
        return new.redistribute(p.device_mesh, p.placements)
    return new


@torch.no_grad()
@tracing.spanned("optimizer")
def update(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor], state: State,
           params: Mapping[str, torch.Tensor]) -> Tuple[State, Dict[str, Any]]:
    """One AdamW step, in place on ``params`` and ``state["m"]``/``["v"]``.
    Returns (state with its new step, {"grad_norm", "lr"}), both metrics
    f32 0-d tensors on the device (no host sync)."""
    if set(grads) != set(params):
        raise ValueError(f"adamw.update: gradients for "
                         f"{sorted(set(grads) ^ set(params))} do not match "
                         f"the parameters")
    step = state["step"] + 1
    gnorm = torch.sqrt(_sum_of_squares(list(grads.values())))
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(cfg, state["step"])
    b1c = 1.0 - torch.pow(torch.full((), cfg.b1, device=step.device),
                          step.float())
    b2c = 1.0 - torch.pow(torch.full((), cfg.b2, device=step.device),
                          step.float())
    for k, p in params.items():
        m, v = state["m"][k], state["v"][k]
        g = grads[k].float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        mh = m / b1c
        vh = v / b2c
        pf = p.float()
        pf = pf - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                        + cfg.weight_decay * pf)
        p.copy_(_gathered_to(pf.to(p.dtype), p))
    return {"m": state["m"], "v": state["v"], "step": step}, {
        "grad_norm": gnorm, "lr": lr}
