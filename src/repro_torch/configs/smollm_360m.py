"""SmolLM-360M — llama-architecture small dense model.

[hf:HuggingFaceTB/SmolLM-360M / SmolLM-135M model card]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49_152,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)
