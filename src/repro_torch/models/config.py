"""Model configuration of the LM (a copy of the JAX package's
``models/config.py``; plain data, no framework).

One frozen dataclass covers every assigned architecture family:
dense GQA, MoE (shared + routed experts), SSM (Mamba2/SSD), hybrid
(parallel attention+SSM heads), and modality-stub backbones (audio/VLM).
:class:`PatternConfig`, a subclass the JAX package has no counterpart of,
describes a stack whose layers are of different kinds (Mamba2 or
attention layers in a pattern, each with the family's feed-forward), with
the scalar multipliers and options such a published model states.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int                   # per-expert hidden for MoE
    vocab: int
    head_dim: int = 128
    qkv_bias: bool = False
    mlp_bias: bool = False
    # --- MoE ---
    n_experts: int = 0          # routed experts
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    d_conv: int = 4
    # --- hybrid ---
    attn_window: int = 0        # sliding-window attention (0 = full)
    # --- misc ---
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    frontend: str = "none"      # none | audio_frames | vision_patches
    frontend_len: int = 0       # stub modality tokens prepended (vlm)
    dtype: str = "bfloat16"
    remat: bool = True
    # --- distribution knobs ---
    scan_layers: bool = True
    zero1: bool = True          # shard optimizer state over the data axis
    # sequence parallelism: measured -42% temp memory / -28% wire (yi_34b)
    seq_shard: bool = True
    # grouped one-hot dispatch; "sort" kept as the (refuted-under-jit)
    # scatter ablation — see EXPERIMENTS.md §Perf
    moe_impl: str = "einsum"
    # dispatch group size: 512 measured better than 2048 on deepseek
    # (coll 6.8->5.7s, mem 6.5->3.9s, useful 0.45->0.59) — §Perf
    moe_group: int = 512
    # FSDP-shard expert weights over the data axes too (needed when
    # E*3*d*f exceeds per-chip HBM under pure EP, e.g. llama4's 770B)
    fsdp_experts: bool = False
    # prevent XLA from hoisting f32 converts above the DP grad all-reduce
    grad_barrier: bool = False
    # microbatch gradient accumulation: divides activation temps by
    # accum_steps at the cost of accum extra weight passes (§Perf It. 10)
    accum_steps: int = 1
    # int8 KV cache with per-(pos, head) scales: halves decode cache HBM
    kv_quant: bool = False
    # attention implementation: "blockwise" (portable online-softmax),
    # "flash" (the hand-written CUDA kernel; its plain torch version on the
    # CPU), "naive" (testing)
    attn_impl: str = "blockwise"
    pp_stages: int = 1          # reserved for >1k-chip pipeline meshes

    @property
    def d_head_total(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.n_heads == 0

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid-with-window)."""
        return self.is_attention_free or (self.has_ssm and self.attn_window > 0)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        return self.replace(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=0 if self.is_attention_free else 4,
            n_kv_heads=0 if self.is_attention_free else max(1, min(self.n_kv_heads, 2)),
            d_ff=128,
            vocab=256,
            head_dim=16,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_heads=4 if self.has_ssm else 0,
            ssm_head_dim=16,
            ssm_chunk=8,
            attn_window=min(self.attn_window, 16) if self.attn_window else 0,
            frontend_len=min(self.frontend_len, 8),
            remat=False,
        )


LAYER_KINDS = ("mamba", "attention")


@dataclass(frozen=True)
class PatternConfig(ModelConfig):
    """A stack of layers of different kinds: layer i is a Mamba2 mixer
    (``"mamba"``) or an attention mixer (``"attention"``) as
    ``layer_kinds[i]`` says, each followed by the MoE (``n_experts`` is
    required). Layer i computes
    ``x += residual_scale * mixer(rmsnorm(x))`` then
    ``x += residual_scale * ffn(rmsnorm(x))``; the stack starts from
    ``embed_scale * embed[tokens]`` and its logits are divided by
    ``logit_scale``. Attention takes rotary positions only with ``rope``
    and scales its scores by ``attn_scale`` (0: 1/sqrt(head_dim)); the
    SSM's causal convolutions add a bias with ``conv_bias``."""
    layer_kinds: Tuple[str, ...] = ()
    rope: bool = True
    attn_scale: float = 0.0
    embed_scale: float = 1.0
    residual_scale: float = 1.0
    logit_scale: float = 1.0
    conv_bias: bool = False

    def __post_init__(self):
        kinds = tuple(self.layer_kinds)
        object.__setattr__(self, "layer_kinds", kinds)
        if len(kinds) != self.n_layers or not set(kinds) <= set(LAYER_KINDS):
            raise ValueError(f"{self.name}: layer_kinds must give one of "
                             f"{LAYER_KINDS} for each of {self.n_layers} "
                             f"layers, got {kinds}")
        if "attention" in kinds and not self.n_heads:
            raise ValueError(f"{self.name}: attention layers need heads")
        if "mamba" in kinds and not self.ssm_state:
            raise ValueError(f"{self.name}: mamba layers need ssm_state")
        if not self.n_experts:
            raise ValueError(f"{self.name}: a patterned stack's feed-forward "
                             f"is the MoE; n_experts must be set")

    def layers_of(self, kind: str) -> Tuple[int, ...]:
        """The indices of the layers of ``kind``, in order."""
        return tuple(i for i, k in enumerate(self.layer_kinds) if k == kind)

    def smoke(self) -> "PatternConfig":
        """The reduced config of :meth:`ModelConfig.smoke` over three
        layers, each kind kept: the kinds in order of first appearance,
        then the first kind again."""
        kinds = tuple(dict.fromkeys(self.layer_kinds))
        kinds = kinds + kinds[:1]
        own = {f.name for f in dataclasses.fields(PatternConfig)} - \
            {f.name for f in dataclasses.fields(ModelConfig)}
        fields = dataclasses.asdict(self)
        plain = ModelConfig(**{k: v for k, v in fields.items()
                               if k not in own})
        fields.update(dataclasses.asdict(plain.smoke()),
                      n_layers=len(kinds), layer_kinds=kinds)
        return PatternConfig(**fields)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether this (arch, shape) cell runs (DESIGN.md §Arch-applicability)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k skipped: pure full-attention arch"
    return True, ""
