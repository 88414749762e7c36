"""Zamba2-2.7B — Mamba2 backbone + shared attention block.

[arXiv:2411.15242]; shared transformer block applied every 6 mamba layers
(weights shared across applications; the published model adds per-invocation
LoRA deltas, which we omit — noted in DESIGN.md).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10_240,
    vocab_size=32_000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    shared_attn_every=6,
    tie_embeddings=True,
    source="arXiv:2411.15242",
)
