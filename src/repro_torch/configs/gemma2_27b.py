"""Gemma2-27B — dense, alternating local(4k)/global attention, logit softcaps.

[arXiv:2408.00118]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36_864,
    vocab_size=256_000,
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    local_global_pattern=True,
    tie_embeddings=True,
    source="arXiv:2408.00118",
)
