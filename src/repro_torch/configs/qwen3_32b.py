"""Qwen3-32B — dense, qk_norm, GQA.

[hf:Qwen/Qwen3-8B family card, scaled per assignment]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25_600,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    source="hf:Qwen/Qwen3-8B",
)
