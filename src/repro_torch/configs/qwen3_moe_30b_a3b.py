"""Qwen3-MoE 30B (3B active) — 128 experts, top-8, qk_norm.

[hf:Qwen/Qwen3-30B-A3B]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,           # per-expert ffn width
    vocab_size=151_936,
    num_experts=128,
    top_k=8,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    source="hf:Qwen/Qwen3-30B-A3B",
)
