"""Deterministic, coordination-free synthetic data pipeline (a copy of the
JAX package's ``repro.data.pipeline``).

Every batch is a pure function of (seed, step, shard): a restarted or
replaced host regenerates exactly its shard for any step without talking
to anyone. Resume state is a single integer cursor (the step), stored in
the checkpoint manifest. Batches are numpy arrays on the host; the
training loop moves them to its device.

Deliberate difference: the reference draws from ``jax.random`` (threefry,
``fold_in`` of step and shard); the port draws from numpy's counter-based
Philox generator keyed by ``SeedSequence([seed, step, shard])``. The
stream's structure is the reference's, its token values are not.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from ..models.config import ModelConfig

# the frontend embeddings' stream, beside the tokens' (the reference folds
# 7 into the batch's key)
_EMBED_STREAM = 7


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128


def _generator(*words: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(np.random.SeedSequence(
        [int(w) for w in words])))


class SyntheticLM:
    """Zipf-ish token stream with enough structure for loss to fall."""

    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig):
        self.cfg = cfg
        self.vocab = model_cfg.vocab
        self.model_cfg = model_cfg

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1,
                 ) -> Dict[str, np.ndarray]:
        """The shard's slice of the global batch for ``step``. Stateless."""
        if n_shards < 1 or self.cfg.global_batch % n_shards:
            raise ValueError(f"SyntheticLM.batch_at: global batch "
                             f"{self.cfg.global_batch} does not split into "
                             f"{n_shards} shards")
        if min(self.cfg.seed, step, shard) < 0:
            raise ValueError(f"SyntheticLM.batch_at: seed, step and shard "
                             f"must be >= 0, got {self.cfg.seed}, {step}, "
                             f"{shard}")
        per = self.cfg.global_batch // n_shards
        rng = _generator(self.cfg.seed, step, shard)
        s = self.cfg.seq_len
        # structured stream: token_{t+1} depends on token_t (learnable)
        base = rng.integers(0, self.vocab, (per, 1))
        steps = rng.integers(0, 17, (per, s))
        tokens = ((base + np.cumsum(steps, axis=1)) % self.vocab
                  ).astype(np.int32)
        inputs = tokens[:, :-1] if s > 1 else tokens
        labels = tokens[:, 1:] if s > 1 else tokens
        out: Dict[str, np.ndarray] = {"labels": labels}
        fe = self.model_cfg.frontend
        if fe in ("audio_frames", "vision_patches"):
            n = labels.shape[1] if fe == "audio_frames" \
                else self.model_cfg.frontend_len
            out["embeds"] = _generator(
                self.cfg.seed, step, shard, _EMBED_STREAM).standard_normal(
                (per, n, self.model_cfg.d_model), dtype=np.float32)
        if fe != "audio_frames":
            out["tokens"] = inputs
        return out

    def iterate(self, start_step: int = 0, shard: int = 0, n_shards: int = 1,
                ) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step, shard, n_shards)
            step += 1
