"""Hand-written Hopper (sm_90a) kernels and their plain PyTorch versions.

CUDA sources live in ``repro_torch/csrc``; ``_native`` builds and loads
them at first use.
"""
