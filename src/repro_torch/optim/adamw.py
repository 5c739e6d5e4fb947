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

One card has no data axis to shard the state over, so ``zero1_spec`` and
``state_specs`` are the single-device identity.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Tuple

import torch

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


def zero1_spec(param_spec: Any, shape: Tuple[int, ...], mesh: Any = None
               ) -> Any:
    """The reference shards the state's first free axis over the data axes
    (ZeRO-1). One card has no data axis: the spec is returned unchanged."""
    return param_spec


def state_specs(param_specs: Any, param_shapes: Any = None, mesh: Any = None,
                zero1: bool = True) -> Dict[str, Any]:
    """The state's placement: on one card, the parameters' own, unsharded
    (see ``zero1_spec``)."""
    return {"m": param_specs, "v": param_specs, "step": None}


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr`` over ``warmup_steps``; ``step`` is the
    count of updates made so far (0-d int32)."""
    # a tensor divisor (CUDA divides by a Python scalar as a product with
    # its reciprocal); torch.full fills on the device, with no host copy
    warm = torch.clamp((step + 1).float() / torch.full(
        (), float(cfg.warmup_steps), device=step.device), max=1.0)
    return cfg.lr * warm


@torch.no_grad()
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
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in grads.values()))
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
        p.copy_(pf.to(p.dtype))
    return {"m": state["m"], "v": state["v"], "step": step}, {
        "grad_norm": gnorm, "lr": lr}
