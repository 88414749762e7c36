"""Mistral-Nemo-12B — dense, 128k context, head_dim 128.

[hf:mistralai/Mistral-Nemo-Base-2407]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=131_072,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)
