"""The training step of the benchmark's configurations in plain PyTorch:
the loss, its gradients and the AdamW update, in float32.

- Loss: the mean over every position of the cross-entropy of the next
  token (``reference.lm``'s model, one routing call over the whole
  batch); no router loss, so a configuration with experts is refused.
- Gradients by autograd, each block recomputed in the backward
  (``torch.utils.checkpoint``) so that the float32 activations fit.
- AdamW as the configuration's training semantics state it: the global
  gradient norm over every leaf, clipping to ``grad_clip``, a linear
  warm-up of the rate over ``warmup_steps`` read before the step's
  increment, bias corrections after it, decoupled weight decay on every
  leaf; the update computed in float32 and stored in each leaf's own
  dtype (the configuration keeps its weights in bfloat16, and three
  dynamic-range leaves of the SSM in float32).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import lm as ref

ADAMW = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
         "weight_decay": 0.1, "grad_clip": 1.0, "warmup_steps": 100}


def loss_and_grads(m: Dict[str, Any], weights: Dict[str, torch.Tensor],
                   tokens: torch.Tensor, labels: torch.Tensor,
                   prec: ref.Precision = ref.FP32
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(mean next-token loss, float32 gradients by leaf) of the weights
    (any dtype, upcast) on ``tokens`` [B, T] and ``labels`` [B, T]."""
    if m.get("n_experts"):
        raise NotImplementedError("the reference's training has no router "
                                  "loss: no configuration with experts")
    leaves = {k: t.detach().to(torch.float32, copy=True).requires_grad_(True)
              for k, t in weights.items()}
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    calls = [(0, tokens.shape[1])]
    with torch.enable_grad():
        x = leaves["embed"][tokens]
        for i in range(m["n_layers"]):
            lw = {k[len("blocks."):]: t[i] for k, t in leaves.items()
                  if k.startswith("blocks.")}
            x = checkpoint(ref.block, m, lw, x, pos, calls, prec,
                           use_reentrant=False)
        lg = ref.head(m, leaves, x, prec)
        gold = torch.gather(lg, -1, labels[..., None].long())[..., 0]
        loss = (torch.logsumexp(lg, dim=-1) - gold).mean()
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                    materialize_grads=True)
    return float(loss.detach()), dict(zip(names, grads))


class AdamW:
    """The reference's optimizer over a dict of weights, updated in place
    in their own dtypes; float32 moments."""

    def __init__(self, weights: Dict[str, torch.Tensor], **cfg: Any):
        self.cfg = dict(ADAMW, **cfg)
        self.m = {k: torch.zeros(t.shape, dtype=torch.float32,
                                 device=t.device) for k, t in weights.items()}
        self.v = {k: torch.zeros_like(t) for k, t in self.m.items()}
        self.steps = 0

    def step(self, weights: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One update; returns each leaf's gradient norm as the update
        takes it (after clipping)."""
        c = self.cfg
        gnorm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                              for g in grads.values()))
        scale = min(1.0, c["grad_clip"] / max(gnorm, 1e-9))
        lr = c["lr"] * min(1.0, (self.steps + 1) / c["warmup_steps"])
        self.steps += 1
        b1c = 1.0 - c["b1"] ** self.steps
        b2c = 1.0 - c["b2"] ** self.steps
        taken = {}
        with torch.no_grad():
            for k, p in weights.items():
                g = grads[k] * scale
                taken[k] = float(torch.linalg.vector_norm(g))
                self.m[k].mul_(c["b1"]).add_(g, alpha=1 - c["b1"])
                self.v[k].mul_(c["b2"]).add_(g * g, alpha=1 - c["b2"])
                pf = p.float()
                upd = (self.m[k] / b1c) / (torch.sqrt(self.v[k] / b2c)
                                           + c["eps"])
                p.copy_((pf - lr * (upd + c["weight_decay"] * pf)).to(p.dtype))
        return taken


def follow(m: Dict[str, Any], weights: Dict[str, torch.Tensor],
           batches: List[Tuple[torch.Tensor, torch.Tensor]],
           prec: ref.Precision = ref.FP32, **adamw: Any
           ) -> Dict[str, Any]:
    """The reference's first steps on ``batches`` from ``weights`` (updated
    in place): each step's loss, the first step's gradient norms by leaf
    as the optimizer takes them, and each leaf's norm of change over all
    the steps."""
    start = {k: t.clone() for k, t in weights.items()}
    opt = AdamW(weights, **adamw)
    losses, first = [], None
    for tokens, labels in batches:
        loss, grads = loss_and_grads(m, weights, tokens, labels, prec)
        taken = opt.step(weights, grads)
        del grads
        losses.append(loss)
        first = first or taken
    change = {k: float(torch.linalg.vector_norm(
        weights[k].float() - start[k].float())) for k in weights}
    return {"losses": losses, "grad_norms": first, "change_norms": change}
