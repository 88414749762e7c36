"""PyTorch / CUDA port of the cold-inference system (``repro``).

Mirrors ``repro``'s module layout so that every module has a twin to test
against. Imports ``torch`` and ``numpy``, never ``jax`` and nothing of
``repro``. Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""
