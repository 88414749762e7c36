"""MusicGen-medium — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284]. The EnCodec conv codec frontend is STUBBED per the
assignment: ``input_specs`` feeds precomputed frame embeddings of shape
(batch, seq, d_model); the decoder and its token head are fully implemented.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    input_mode="embeddings",
    tie_embeddings=False,
    source="arXiv:2306.05284",
)
