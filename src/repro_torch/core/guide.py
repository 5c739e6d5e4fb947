"""Learned II guidance for the sweep: predict where the feasible II lives.

A small MLP trained on campaign cell records (:mod:`repro_torch.core.campaign`)
maps :func:`~repro_torch.core.campaign.cell_features` — DFG statistics, the KMS
mobility histogram, fabric geometry/capability summary — to (a) a
distribution over the *II offset* (final II − MII, bucketed to
``N_OFFSETS``) and (b) a *hopelessness* probability (the sweep will refute
every candidate II). The sweep consumes predictions through
:meth:`IIGuide.suggest`.

**Soundness contract.** Guidance is advisory only: it chooses the sweep's
*window extents* (how many candidate IIs to encode and race per round),
never which IIs exist. The sweep still walks every II from MII upward in
ascending order and only reports a winner once every lower candidate holds
a proven refutation — so the guided final II is bit-identical to the
unguided one on every input, by construction (held to the JAX package in
``tests/test_torch_guide.py``). A guide that predicts garbage can only
waste or save wall-clock.

**Inference is numpy, training is torch.** :class:`IIGuide` runs once per
guided compile on a 31x32 MLP, inside :class:`~repro_torch.core.workers.WorkerPool`
shards and before the CDCL pool forks: a device launch there would only
add a sync, and numpy keeps suggestions bit-identical to the JAX
package's. torch is imported inside :func:`train_guide` only, which trains
on the port's device (``cuda`` unless the caller asked for the CPU). The
``.npz`` checkpoints hold the same arrays as the JAX package's, so a guide
saved by either package loads in the other.

Guides are referenced by *name* (``MapperConfig.guide`` is a string so
configs stay hashable/serialisable for the service cache and the store):
:func:`resolve_guide` looks the name up in a process registry first
(:func:`register_guide` — how campaigns and tests inject guides, including
adversarial stubs) and falls back to loading an ``.npz`` checkpoint path.
A spawned shard starts with an empty registry, so only a path resolves
there.
"""
from __future__ import annotations

import math
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .campaign import N_FEATURES

# offset buckets: final II - MII clipped to [0, N_OFFSETS-1]; the last
# bucket absorbs "far above MII" (offsets that large are rare and the
# sweep's max-span cap truncates any suggestion anyway)
N_OFFSETS = 8

# the widest window a suggestion may open (in IIs); also the width used
# for cells predicted hopeless — burn through the II range in few rounds
MAX_GUIDED_SPAN = 8


@dataclass
class GuideSuggestion:
    """One prediction, ready for the sweep: ``order`` is every offset
    bucket sorted most-probable first, ``offset`` its head, ``hopeless``
    the probability that no candidate II maps at all."""
    offset: int
    order: Tuple[int, ...]
    probs: Tuple[float, ...]
    hopeless: float

    def span_from(self, base_offset: int) -> int:
        """Window width (in IIs) to open at ``base_offset`` = base - MII:
        wide enough to cover the most probable not-yet-refuted offset, at
        least 1, at most :data:`MAX_GUIDED_SPAN`. Cells predicted hopeless
        get the full span — every candidate needs refuting anyway."""
        if self.hopeless > 0.5:
            return MAX_GUIDED_SPAN
        for off in self.order:
            if off >= base_offset:
                return max(1, min(off - base_offset + 1, MAX_GUIDED_SPAN))
        return 1


class IIGuide:
    """Numpy forward pass of the trained MLP (one tanh hidden layer, a
    softmax offset head and a sigmoid hopelessness head, with input
    standardisation folded into the parameters)."""

    PARAM_KEYS = ("mean", "std", "w1", "b1", "wo", "bo", "wh", "bh")

    def __init__(self, params: Dict[str, np.ndarray]):
        missing = [k for k in self.PARAM_KEYS if k not in params]
        if missing:
            raise ValueError(f"guide params missing {missing}")
        self.params = {k: np.asarray(params[k], dtype=np.float32)
                       for k in self.PARAM_KEYS}
        if self.params["w1"].shape[0] != N_FEATURES:
            raise ValueError(
                f"guide expects {self.params['w1'].shape[0]} features, "
                f"campaign emits {N_FEATURES}")

    # ------------------------------------------------------------ forward
    def _forward(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        p = self.params
        z = (x - p["mean"]) / p["std"]
        h = np.tanh(z @ p["w1"] + p["b1"])
        logits = h @ p["wo"] + p["bo"]
        logits = logits - logits.max(axis=-1, keepdims=True)
        e = np.exp(logits)
        probs = e / e.sum(axis=-1, keepdims=True)
        hop = 1.0 / (1.0 + np.exp(-(h @ p["wh"] + p["bh"])))
        return probs, hop

    def predict(self, features: np.ndarray
                ) -> Tuple[np.ndarray, float]:
        """(offset probabilities over ``N_OFFSETS`` buckets, hopelessness
        probability) for one feature vector."""
        x = np.asarray(features, dtype=np.float32).reshape(1, -1)
        probs, hop = self._forward(x)
        return probs[0], float(hop.reshape(-1)[0])

    def suggest(self, features: np.ndarray) -> GuideSuggestion:
        """Sanitised, sweep-ready suggestion: NaN/inf-free probabilities
        (a degenerate forward pass degrades to the uniform 'no opinion'
        prediction — never an exception on the mapping path)."""
        probs, hop = self.predict(features)
        probs = np.nan_to_num(probs, nan=0.0, posinf=0.0, neginf=0.0)
        if probs.sum() <= 0:
            probs = np.full(N_OFFSETS, 1.0 / N_OFFSETS, dtype=np.float32)
        if not math.isfinite(hop):
            hop = 0.0
        # stable sort: ties resolve lowest-offset-first
        order = tuple(int(o) for o in
                      np.argsort(-probs, kind="stable"))
        return GuideSuggestion(
            offset=order[0], order=order,
            probs=tuple(float(v) for v in probs),
            hopeless=min(1.0, max(0.0, float(hop))))

    # -------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        np.savez(path, **self.params)

    @classmethod
    def load(cls, path: str) -> "IIGuide":
        with np.load(path) as z:
            return cls({k: z[k] for k in cls.PARAM_KEYS})


def init_guide(seed: int = 0, hidden: int = 32) -> IIGuide:
    """A randomly initialised (untrained) guide — the training starting
    point, and a handy stand-in for tests."""
    rng = np.random.default_rng(seed)
    s1 = 1.0 / math.sqrt(N_FEATURES)
    s2 = 1.0 / math.sqrt(hidden)
    return IIGuide({
        "mean": np.zeros(N_FEATURES, dtype=np.float32),
        "std": np.ones(N_FEATURES, dtype=np.float32),
        "w1": rng.normal(0, s1, (N_FEATURES, hidden)).astype(np.float32),
        "b1": np.zeros(hidden, dtype=np.float32),
        "wo": rng.normal(0, s2, (hidden, N_OFFSETS)).astype(np.float32),
        "bo": np.zeros(N_OFFSETS, dtype=np.float32),
        "wh": rng.normal(0, s2, (hidden, 1)).astype(np.float32),
        "bh": np.zeros(1, dtype=np.float32),
    })


# ---------------------------------------------------------------- registry

_REGISTRY: Dict[str, object] = {}
_REG_LOCK = threading.Lock()


def register_guide(name: str, guide) -> None:
    """Install ``guide`` (an :class:`IIGuide`, or any object with a
    compatible ``suggest(features)``) under ``name`` for this process.
    ``None`` removes the entry."""
    with _REG_LOCK:
        if guide is None:
            _REGISTRY.pop(name, None)
        else:
            _REGISTRY[name] = guide


def clear_guides() -> None:
    with _REG_LOCK:
        _REGISTRY.clear()


def resolve_guide(spec: Optional[str]):
    """Resolve a ``MapperConfig.guide`` string: a registered name wins,
    otherwise an existing ``.npz`` checkpoint path is loaded (and cached
    in the registry so worker processes pay the load once). Returns None
    for unresolvable specs — the sweep then runs unguided."""
    if not spec:
        return None
    with _REG_LOCK:
        g = _REGISTRY.get(spec)
    if g is not None:
        return g
    if os.path.exists(spec):
        try:
            g = IIGuide.load(spec)
        except Exception:
            return None
        register_guide(spec, g)
        return g
    return None


# ---------------------------------------------------------------- training


def _dataset_arrays(records: Sequence, holdout_byte: int = 64,
                    ) -> Tuple[np.ndarray, ...]:
    """Stack campaign records into train/held-out arrays. The split is
    *deterministic* and content-keyed: a record is held out iff the first
    byte of its cell key is below ``holdout_byte`` (≈ holdout_byte/256 of
    the data) — stable across runs, shards, and processes. Structurally
    infeasible cells are dropped (the fabric can never run them, there is
    nothing to predict); refuted-everywhere cells keep offset bucket
    ``N_OFFSETS - 1`` and label the hopelessness head."""
    Xs: List[np.ndarray] = []
    yo: List[int] = []
    yh: List[float] = []
    held: List[bool] = []
    for rec in records:
        if rec.infeasible:
            continue
        off = rec.offset
        if off is None:
            off = N_OFFSETS - 1
        Xs.append(np.asarray(rec.features, dtype=np.float32))
        yo.append(min(max(int(off), 0), N_OFFSETS - 1))
        yh.append(0.0 if rec.success else 1.0)
        held.append(rec.key[0] < holdout_byte)
    if not Xs:
        raise ValueError("no trainable cells in the dataset")
    X = np.stack(Xs)
    yo_a = np.asarray(yo, dtype=np.int32)
    yh_a = np.asarray(yh, dtype=np.float32)
    held_a = np.asarray(held, dtype=bool)
    return X, yo_a, yh_a, held_a


def evaluate_guide(guide: IIGuide, X: np.ndarray, yo: np.ndarray,
                   ) -> Dict[str, float]:
    """hit@1 / hit@2 of the offset head vs the always-offset-0 baseline
    (the unguided sweep's implicit prediction: start at MII)."""
    probs, _hop = guide._forward(X.astype(np.float32))
    top2 = np.argsort(-probs, axis=-1, kind="stable")[:, :2]
    hit1 = float(np.mean(top2[:, 0] == yo))
    hit2 = float(np.mean((top2[:, 0] == yo) | (top2[:, 1] == yo)))
    return {"hit1": hit1, "hit2": hit2,
            "baseline_hit1": float(np.mean(yo == 0)),
            "n": int(len(yo))}


# the parameters that training updates (mean/std are fixed from the data)
_TRAINED_KEYS = ("w1", "b1", "wo", "bo", "wh", "bh")


def _mlp(params: Dict[str, np.ndarray], device):
    """The trainable guide as an ``nn.Module`` on ``device``, initialised
    from ``params``' numpy arrays (laid out as :class:`IIGuide`'s, so
    ``z @ w1``, not ``nn.Linear``'s transposed weights). ``forward(z)``
    returns (offset logits ``[n, N_OFFSETS]``, hopelessness logit
    ``[n]``) for standardised features ``z``."""
    import torch
    from torch import nn

    class GuideMLP(nn.Module):
        def __init__(self):
            super().__init__()
            for k in _TRAINED_KEYS:
                self.register_parameter(k, nn.Parameter(torch.tensor(
                    np.asarray(params[k], dtype=np.float32),
                    device=device)))

        def forward(self, z):
            h = torch.tanh(z @ self.w1 + self.b1)
            return h @ self.wo + self.bo, (h @ self.wh + self.bh).reshape(-1)

    return GuideMLP()


def _loss(model, z, y_off, y_hop):
    """Mean softmax cross-entropy of the offset head plus 0.25 x mean
    sigmoid binary cross-entropy of the hopelessness head (the JAX
    package's ``loss_fn``)."""
    import torch.nn.functional as F
    logits, hop_logit = model(z)
    return (F.cross_entropy(logits, y_off)
            + 0.25 * F.binary_cross_entropy_with_logits(hop_logit, y_hop))


def _epoch_perms(seed: int, n: int, epochs: int):
    """One permutation of the ``n`` training rows per epoch, from
    ``torch.Generator().manual_seed(seed)`` on the CPU. This stands in for
    the JAX package's ``jax.random.permutation``: the two streams differ,
    so the two packages visit the batches in different orders."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    return torch.stack([torch.randperm(n, generator=gen)
                        for _ in range(epochs)])


def _fit(params: Dict[str, np.ndarray], Z: np.ndarray, yo: np.ndarray,
         yh: np.ndarray, perms, lr: float, batch: int, device):
    """Adam (optax's defaults: betas 0.9/0.999, eps 1e-8, no eps_root) on
    :func:`_loss`, one step per ``batch`` rows of each epoch's permutation
    (``perms``: ``[epochs, n]`` row indices). Data, permutations and
    parameters live on ``device``; the loop reads nothing back. Returns
    (the trained module, the last step's loss as a device tensor)."""
    import torch
    model = _mlp(params, device)
    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
    Zd = torch.as_tensor(Z, dtype=torch.float32).to(device)
    Yo = torch.as_tensor(yo).to(device=device, dtype=torch.int64)
    Yh = torch.as_tensor(yh, dtype=torch.float32).to(device)
    perms = torch.as_tensor(perms).to(device)
    n = Zd.shape[0]
    loss = torch.zeros((), device=device)
    for perm in perms:
        for i in range(0, n, batch):
            idx = perm[i:i + batch]
            opt.zero_grad(set_to_none=True)
            loss = _loss(model, Zd[idx], Yo[idx], Yh[idx])
            loss.backward()
            opt.step()
    return model, loss.detach()


def train_guide(records: Sequence, seed: int = 0, hidden: int = 32,
                epochs: int = 300, lr: float = 3e-3,
                batch: int = 256, holdout_byte: int = 64,
                ) -> Tuple[IIGuide, Dict[str, float]]:
    """Train an :class:`IIGuide` on campaign cell records with torch (Adam,
    cross-entropy on the offset head + binary cross-entropy on the
    hopelessness head) on the port's device
    (``repro_torch.device.resolve_device``: cuda unless the caller asked
    for the CPU; a device the machine lacks raises
    :class:`~repro_torch.device.DeviceUnavailable`). Returns (guide,
    metrics): held-out hit@1 / hit@2 vs the always-start-at-MII baseline,
    split sizes, the final loss and the device the parameters trained on.

    The epochs' batch orders come from an explicit
    ``torch.Generator().manual_seed(seed)`` (:func:`_epoch_perms`), not
    from ``jax.random.permutation`` as in the JAX package, so the two
    packages' trained weights differ; one step from the same parameters
    on the same batch agrees with the JAX package's to rounding. The
    trained weights are exported as numpy: the guide is the same
    :class:`IIGuide` either package loads."""
    from .. import device as device_mod
    dev = device_mod.resolve_device()

    X, yo, yh, held = _dataset_arrays(records, holdout_byte)
    Xtr, ytr_o, ytr_h = X[~held], yo[~held], yh[~held]
    Xte, yte_o = X[held], yo[held]
    if len(Xtr) == 0:          # tiny corpora: train on everything
        Xtr, ytr_o, ytr_h = X, yo, yh
    mean = Xtr.mean(axis=0)
    std = Xtr.std(axis=0)
    std[std < 1e-6] = 1.0

    g0 = init_guide(seed=seed, hidden=hidden)
    Z = (Xtr - mean) / std
    model, loss = _fit(g0.params, Z, ytr_o, ytr_h,
                       _epoch_perms(seed, len(Xtr), epochs), lr, batch, dev)
    final = {k: getattr(model, k).detach().cpu().numpy().astype(np.float32)
             for k in _TRAINED_KEYS}
    final["mean"] = mean.astype(np.float32)
    final["std"] = std.astype(np.float32)
    guide = IIGuide(final)
    metrics: Dict[str, float] = {
        "n_train": int(len(Xtr)), "n_heldout": int(len(Xte)),
        "final_loss": float(loss),
        "device": str(model.w1.device),
    }
    if len(Xte):
        metrics.update(evaluate_guide(guide, Xte, yte_o))
    else:
        metrics.update({"hit1": 0.0, "hit2": 0.0, "baseline_hit1": 0.0,
                        "n": 0})
    return guide, metrics


__all__ = [
    "N_OFFSETS", "MAX_GUIDED_SPAN", "GuideSuggestion", "IIGuide",
    "init_guide", "register_guide", "clear_guides", "resolve_guide",
    "evaluate_guide", "train_guide",
]
