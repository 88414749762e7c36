"""Granite-MoE 3B (800M active) — 40 experts, top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base family, scaled per assignment]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,           # per-expert ffn width
    vocab_size=49_155,
    num_experts=40,
    top_k=8,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
