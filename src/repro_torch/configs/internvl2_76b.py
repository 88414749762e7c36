"""InternVL2-76B — InternViT + InternLM2(llama3-70b-class) decoder.

[arXiv:2404.16821]. The InternViT vision tower + MLP projector are STUBBED
per the assignment: ``input_specs`` feeds 256 precomputed patch embeddings
per image, prepended to the text token embeddings. The 80-layer language
decoder is fully implemented.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab_size=128_256,
    input_mode="vlm",
    num_prefix_embeds=256,
    rope_theta=500_000.0,
    tie_embeddings=False,
    source="arXiv:2404.16821",
)
