"""Execution-strategy flags (not architecture config) — the port of
``repro/models/runtime_flags.py``.

The port keeps only the key that changes what it computes on one card.
The reference's ``decode_flash``, ``seqpar_attn`` and ``attn_chunk``
select its sharded (mesh) paths and its jnp long-prefill fallback, which
the port has not taken over; they return with those paths.
"""

FLAGS = {
    # int8-quantized KV cache (per-entry-per-head absmax scales): half the
    # cache bytes of bf16 for the decode reads. Lossy, OFF by default.
    # Uniform-attention families only (not the local/global pattern).
    "kv_cache_int8": False,
}
