"""Step-function factories shared by ``train.py`` and serving (a copy of
the JAX package's ``repro.launch.steps``).

The port's ``LM`` holds its parameters, so a train step takes the
optimizer state and a batch and updates the parameters in place. The
reference's ``grad_barrier`` (keeping the data-parallel gradient
all-reduce in bf16), ``zero1`` (reduce-scattering gradients onto the
data-sharded optimizer state) and ``seq_shard`` (sequence-parallel
activations) shape collectives between devices; on one card there are
none, so these config fields are accepted and change nothing. On the
partitioned LM (``LM(cfg, device, mesh=...)``) the train step constrains
the gradients to the optimizer state's layout, as the reference does under
``zero1``: the data-parallel sum is then a reduce-scatter onto the
data-sharded moments, and without ``zero1`` an all-reduce onto the
parameters' layout: the span ``grad_reduce``, whose counter
``grad_reduce_bytes`` adds the bytes of this rank's gradient shards
handed to it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import tracing
from ..models.config import ModelConfig
from ..models.model import LM, param_shapes, param_specs
from ..models.sharding import placements, tp_size
from ..optim import adamw

Batch = Dict[str, torch.Tensor]


@tracing.spanned("value_and_grad")
def value_and_grad(lm: LM, batch: Batch
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor]]:
    """(loss, {"ce", "aux"}, gradients by parameter name) of
    ``lm.loss_fn(batch)``, all detached. With ``cfg.accum_steps = a > 1``
    the batch is cut into ``a`` microbatches of ``B // a`` rows (the
    reference's ``dynamic_slice``), and the gradients are accumulated in
    f32 as ``g.float() / a`` in the reference's order; then ``ce`` is the
    mean loss, as in the reference. A leaf the loss does not reach gets a
    zero gradient. Turns on ``requires_grad`` for every parameter of
    ``lm`` (the serving methods run under ``torch.no_grad()`` whatever it
    is)."""
    params = dict(lm.named_parameters())
    leaves = list(params.values())
    for p in leaves:
        p.requires_grad_(True)

    def one(b: Batch):
        with torch.enable_grad():
            loss, metrics = lm.loss_fn(b)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(params, grads)))

    a = lm.cfg.accum_steps
    if a <= 1:
        return one(batch)
    rows = next(iter(batch.values())).shape[0] // a
    acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in params.items()}
    dev = leaves[0].device
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(a):
        loss, metrics, g = one({k: v[i * rows:(i + 1) * rows]
                                for k, v in batch.items()})
        for k, s in acc.items():
            s.add_(g[k].float() / a)
        loss_sum = loss_sum + loss / a
        aux_sum = aux_sum + metrics["aux"] / a
    return loss_sum, {"ce": loss_sum, "aux": aux_sum}, acc


def opt_state_specs(cfg: ModelConfig, mesh: Any) -> Dict[str, Any]:
    """The AdamW state's specs on ``mesh`` (a logical mesh), keyed as
    ``adamw.state_shapes``: the reference's ZeRO-1 moments under
    ``cfg.zero1``, else each parameter's own spec. The one place the
    state's layout is decided: the train step lays gradients out by it,
    the training loop places and checkpoints the state by it, and the dry
    run counts its bytes by it."""
    return adamw.state_specs(param_specs(cfg, mesh),
                             param_shapes(cfg, tp_size(mesh)), mesh,
                             zero1=cfg.zero1)


def init_opt_state(lm: LM) -> Dict[str, Any]:
    """Zero AdamW state for ``lm``'s parameters: ``adamw.init`` on one
    device; on a mesh zero DTensors laid out by :func:`opt_state_specs`."""
    if lm.mesh is None:
        return adamw.init(dict(lm.named_parameters()))
    return lm.sharded_zeros(adamw.state_shapes(param_shapes(lm.cfg, lm.tp)),
                            opt_state_specs(lm.cfg, lm.spec_mesh))


def make_train_step(lm: LM, opt_cfg: Optional[adamw.AdamWConfig] = None,
                    ) -> Callable[[Dict[str, Any], Batch],
                                  Tuple[Dict[str, Any], Dict[str, Any]]]:
    """A step ``(opt_state, batch) -> (opt_state, metrics)`` that updates
    ``lm``'s parameters in place with AdamW. ``metrics`` holds ``loss``,
    ``ce``, ``aux``, ``grad_norm`` and ``lr`` as 0-d device tensors (no host
    sync)."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    params = dict(lm.named_parameters())
    grad_layout = None
    if lm.mesh is not None:
        specs = opt_state_specs(lm.cfg, lm.spec_mesh)["m"]
        grad_layout = {k: placements(sp, lm.mesh) for k, sp in specs.items()}

    def train_step(opt_state, batch):
        loss, metrics, grads = value_and_grad(lm, batch)
        if grad_layout is not None:
            with tracing.span("grad_reduce"):
                if tracing.active():
                    tracing.count("grad_reduce_bytes", sum(
                        g.to_local().numel() * g.element_size()
                        for g in grads.values()))
                grads = {k: g.redistribute(lm.mesh, grad_layout[k])
                         for k, g in grads.items()}
        opt_state, opt_metrics = adamw.update(opt_cfg, grads, opt_state,
                                              params)
        return opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def make_prefill_step(lm: LM) -> Callable:
    def prefill_step(batch):
        return lm.prefill(batch.get("tokens"), batch.get("embeds"))
    return prefill_step


def make_decode_step(lm: LM) -> Callable:
    def decode_step(cache, tokens, t):
        return lm.decode_step(cache, tokens, t)
    return decode_step
