"""Input stand-ins and their specs for every (arch, shape) (a copy of the
JAX package's ``launch/specs.py``).

Each function returns (shapes, specs) whose keys match the step
function's batch argument. A shape is a ``(shape tuple, torch dtype)``
pair, as ``repro_torch.models.model.param_shapes`` gives them, where the
reference has ``jax.ShapeDtypeStruct``; a spec is a tuple of mesh-axis
entries (``repro_torch.models.sharding.spec``). Nothing is allocated: the
dry run makes meta tensors of these shapes. Modality frontends are stubs:
audio provides precomputed EnCodec frame embeddings, VLM provides
precomputed ViT patch embeddings.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..models.config import ModelConfig, ShapeConfig
from ..models.model import LM, cache_specs
from ..models.sharding import spec

Shape = Tuple[Tuple[int, ...], torch.dtype]


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _inputs(cfg: ModelConfig, b: int, s: int, mesh: Any, labels: bool
            ) -> Tuple[Dict[str, Shape], Dict[str, Any]]:
    i32 = torch.int32
    shapes: Dict[str, Shape] = {}
    specs: Dict[str, Any] = {}
    text = s
    if cfg.frontend == "audio_frames":
        shapes["embeds"] = ((b, s, cfg.d_model), _dt(cfg))
        specs["embeds"] = spec(mesh, "batch", None, None)
    elif cfg.frontend == "vision_patches":
        fl = cfg.frontend_len
        text = s - fl
        shapes["embeds"] = ((b, fl, cfg.d_model), _dt(cfg))
        specs["embeds"] = spec(mesh, "batch", None, None)
        shapes["tokens"] = ((b, text), i32)
        specs["tokens"] = spec(mesh, "batch", None)
    else:
        shapes["tokens"] = ((b, s), i32)
        specs["tokens"] = spec(mesh, "batch", None)
    if labels:
        shapes["labels"] = ((b, text), i32)
        specs["labels"] = spec(mesh, "batch", None)
    return shapes, specs


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh: Any,
                      ) -> Tuple[Dict[str, Shape], Dict[str, Any]]:
    """The training batch: tokens and/or frontend embeds, and labels over
    the text positions."""
    return _inputs(cfg, shape.global_batch, shape.seq_len, mesh, True)


def decode_inputs(lm: LM, shape: ShapeConfig, mesh: Any):
    """(cache, tokens, t) shapes+specs for one decode step at position
    seq_len (KV cache holding seq_len context, a ring of
    ``min(seq_len, attn_window)`` slots)."""
    cfg = lm.cfg
    b = shape.global_batch
    window = shape.seq_len
    if cfg.attn_window:
        window = min(window, cfg.attn_window)
    cache_shapes = lm.cache_shapes(b, window) if (
        not cfg.is_attention_free or cfg.has_ssm) else {}
    cspecs = cache_specs(cfg, mesh, batch=b)
    tok = ((b, 1), torch.int32)
    tok_spec = spec(mesh, "batch", None, batch_size=b)
    t = ((), torch.int32)
    return (cache_shapes, cspecs), (tok, tok_spec), (t, ())


def prefill_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh: Any,
                   ) -> Tuple[Dict[str, Shape], Dict[str, Any]]:
    return _inputs(cfg, shape.global_batch, shape.seq_len, mesh, False)
