"""Architecture config system.

Every assigned architecture is expressed as an ``ArchConfig``. The decoder in
``repro_torch.models.transformer`` is driven entirely by this config; no
architecture has bespoke model code outside the layer library.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0  # 0 -> d_model // num_heads

    # attention features
    qk_norm: bool = False
    attn_softcap: Optional[float] = None    # gemma2: 50.0 on attention logits
    final_softcap: Optional[float] = None   # gemma2: 30.0 on lm logits
    sliding_window: Optional[int] = None    # window for 'local' layers
    local_global_pattern: bool = False      # gemma2: alternate local/global
    rope_theta: float = 10_000.0

    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 2.0

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # hybrid (zamba2-style): shared attention block every N ssm layers
    shared_attn_every: int = 0

    # input modality
    input_mode: str = "tokens"        # tokens | embeddings | vlm
    num_prefix_embeds: int = 0        # vlm: number of vision patch embeddings

    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: str = "bfloat16"

    # citation for the config numbers
    source: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer mixer kind: 'attn' | 'local' | 'mamba'."""
        if self.family in ("ssm", "hybrid"):
            return ("mamba",) * self.num_layers
        if self.local_global_pattern:
            # gemma2: even layers local (sliding window), odd layers global
            return tuple(
                "local" if i % 2 == 0 else "attn" for i in range(self.num_layers)
            )
        return ("attn",) * self.num_layers

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        n = V * d  # embedding
        if not self.tie_embeddings:
            n += V * d
        per_attn = 0
        if self.num_heads:
            qdim = self.num_heads * self.head_dim
            kvdim = self.num_kv_heads * self.head_dim
            per_attn = d * qdim + 2 * d * kvdim + qdim * d
            if self.qk_norm:
                per_attn += 2 * self.head_dim
        per_mlp = 3 * d * ff if ff else 0
        if self.is_moe:
            per_mlp = self.num_experts * 3 * d * ff + d * self.num_experts
        per_mamba = 0
        if self.family in ("ssm", "hybrid"):
            di, G, N, H = self.ssm_inner, 1, self.ssm_state, self.ssm_heads
            per_mamba = (
                d * (2 * di + 2 * G * N + H)  # in_proj (x,z,B,C,dt)
                + self.ssm_conv_width * (di + 2 * G * N)
                + 3 * H  # A_log, D, dt_bias
                + di     # gated norm
                + di * d  # out_proj
            )
        kinds = self.layer_kinds()
        for k in kinds:
            n += 2 * d  # block norms
            if k == "mamba":
                n += per_mamba
            else:
                n += per_attn + per_mlp
        if self.family == "hybrid":
            n += per_mlp  # ssm layers have no mlp; hybrid shared block has one
        if self.family in ("dense", "moe", "vlm", "audio") or self.local_global_pattern:
            pass
        if self.shared_attn_every:
            # one shared attention+mlp block (zamba2)
            qdim = self.num_heads * self.head_dim
            kvdim = self.num_kv_heads * self.head_dim
            n += d * qdim + 2 * d * kvdim + qdim * d + 3 * d * self.d_ff + 2 * d
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        inactive = self.num_layers * (self.num_experts - self.top_k) * 3 * d * ff
        return self.param_count() - inactive

    def reduced(self, **overrides) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        small = dict(
            name=self.name + "-reduced",
            num_layers=2,
            d_model=min(self.d_model, 256),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_heads=min(self.num_heads, 4) if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=64 if self.num_heads else 0,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_chunk=32,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else None,
            shared_attn_every=2 if self.shared_attn_every else 0,
            num_prefix_embeds=min(self.num_prefix_embeds, 8),
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)

    def with_sliding_window(self, window: int = 4096) -> "ArchConfig":
        """Sub-quadratic variant for long_500k on otherwise-full-attention archs."""
        if self.family in ("ssm",):
            return self
        return dataclasses.replace(
            self,
            sliding_window=window if self.sliding_window is None else self.sliding_window,
            local_global_pattern=self.local_global_pattern,
            name=self.name if self.sliding_window or self.local_global_pattern
            else self.name + "-sw",
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
