"""Config-driven decoder, dense family — the port of
``repro/models/transformer.py``.

``init_params`` draws from an explicit ``torch.Generator``: torch cannot
reproduce ``jax.random``, so its weights are the port's own (same shapes,
same scales, same parameter tree). ``from_reference`` takes the JAX
package's params as numpy arrays and returns the port's, with the same
values: parity tests and weight transfer go through it.

``forward`` is the dense branch of the reference's (plain and gemma2's
local/global layer pattern), a Python loop over the stacked blocks in
place of ``lax.scan``. Attention goes through the flash kernel at every
sequence length (the reference switches to ``chunked_attention`` above
8192 tokens; the kernel is that path's analogue).

``init_decode_state`` and ``decode_step`` are the dense branch of the
reference's decode: plain, local/global (gemma2: a window ring for the
local layers, a full cache for the global ones) and the int8 KV cache
(``runtime_flags.FLAGS["kv_cache_int8"]``), again a loop over the blocks.
Each step's attention runs on the ``decode_attention`` kernel. The cache
tensors are updated in place and returned as the new state. The moe, ssm
and hybrid families and training wait for later slices.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import bf16
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.runtime_flags import FLAGS

Params = Dict[str, Any]


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense" or cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: the port's decoder covers the dense family with "
            f"token input; {cfg.family}/{cfg.input_mode} waits for a later "
            f"slice")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _normal(g: torch.Generator, shape, scale: float, dt) -> torch.Tensor:
    return (torch.randn(shape, generator=g, dtype=torch.float32)
            * scale).to(dt)


def init_params(cfg: ArchConfig, g: torch.Generator) -> Params:
    """Random weights from ``g`` in the reference's tree and scales (embed
    N(0, .02²), projections N(0, 1/fan_in), norms zero), stacked (L, ...)
    per block weight, in ``cfg.dtype``, on the CPU."""
    _check_dense(cfg)
    dt = _dtype(cfg)
    d, V, Lr = cfg.d_model, cfg.vocab_size, cfg.num_layers
    H, KV, hd, ff = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff

    def dense(shape):
        return _normal(g, (Lr, *shape), 1.0 / math.sqrt(shape[0]), dt)

    params: Params = {"embed": _normal(g, (V, d), 0.02, dt)}
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(g, (d, V), 1.0 / math.sqrt(d), dt)
    attn = {"wq": dense((d, H * hd)), "wk": dense((d, KV * hd)),
            "wv": dense((d, KV * hd)), "wo": dense((H * hd, d))}
    if cfg.qk_norm:
        attn["q_norm"] = torch.zeros((Lr, hd), dtype=dt)
        attn["k_norm"] = torch.zeros((Lr, hd), dtype=dt)
    params["blocks"] = {
        "ln1": torch.zeros((Lr, d), dtype=dt),
        "ln2": torch.zeros((Lr, d), dtype=dt),
        "attn": attn,
        "mlp": {"w_gate": dense((d, ff)), "w_up": dense((d, ff)),
                "w_down": dense((ff, d))},
    }
    params["final_norm"] = torch.zeros((d,), dtype=dt)
    return params


def from_reference(params: Params) -> Params:
    """The reference's params (a nested dict of numpy arrays; bf16 as
    ``ml_dtypes`` or as the port's ``bf16.BFLOAT16``) as the port's: the
    same tree of CPU tensors with the same values and dtypes."""
    if isinstance(params, dict):
        return {k: from_reference(v) for k, v in params.items()}
    return bf16.to_tensor(np.array(params))


def to_device(params: Params, device) -> Params:
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    return params.to(device)


# ---------------------------------------------------------------------------
# block bodies
# ---------------------------------------------------------------------------
def _attn_block_seq(bp, x, cfg, positions, window):
    h, _ = L.attn_apply_seq(
        bp["attn"], L.rms_norm(x, bp["ln1"], cfg.norm_eps), cfg, positions,
        window=window)
    x = x + h
    xn = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + L.mlp_apply(bp["mlp"], xn)


def _embed_input(params, cfg, batch):
    """Returns (x (B,S,d), loss_mask (B,S)); token input only."""
    tokens = batch["tokens"]
    x = params["embed"][tokens]
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=x.device)
    return x, mask


def _lm_logits(params, cfg, x) -> torch.Tensor:
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings and cfg.input_mode != "embeddings":
        logits = L._mm(h, params["embed"].T)
    else:
        logits = L._mm(h, params["lm_head"])
    logits = logits.to(torch.float32)
    if cfg.final_softcap:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


# ---------------------------------------------------------------------------
# sequence forward (prefill)
# ---------------------------------------------------------------------------
def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig):
    """Full-sequence forward. Returns (logits, aux_loss, (None, mask)), the
    reference's return shape (a dense model has no aux loss; the KV cache
    for decode waits for the serving slice)."""
    _check_dense(cfg)
    x, loss_mask = _embed_input(params, cfg, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    for i in range(cfg.num_layers):
        window = cfg.sliding_window
        if cfg.local_global_pattern and i % 2 == 1:
            window = None  # (local, global) pairs: odd layers are global
        x = _attn_block_seq(_layer(params["blocks"], i), x, cfg, positions,
                            window)
    logits = _lm_logits(params, cfg, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, aux, (None, loss_mask)


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_decode_state(cfg: ArchConfig, batch: int, context_len: int, *,
                      device="cpu") -> Params:
    """Zero-initialised decode caches sized for ``context_len`` history
    (the reference's shapes and dtypes)."""
    _check_dense(cfg)
    dt = _dtype(cfg)
    KV, hd, Lr = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.local_global_pattern:
        Wl = min(cfg.sliding_window, context_len)
        return {
            "k_local": zeros(Lr // 2, batch, Wl, KV, hd),
            "v_local": zeros(Lr // 2, batch, Wl, KV, hd),
            "k_global": zeros(Lr // 2, batch, context_len, KV, hd),
            "v_global": zeros(Lr // 2, batch, context_len, KV, hd),
        }
    W = (min(cfg.sliding_window, context_len) if cfg.sliding_window
         else context_len)
    if FLAGS.get("kv_cache_int8", False):
        return {
            "k": zeros(Lr, batch, W, KV, hd, dtype=torch.int8),
            "v": zeros(Lr, batch, W, KV, hd, dtype=torch.int8),
            "k_scale": zeros(Lr, batch, W, KV, dtype=torch.float32),
            "v_scale": zeros(Lr, batch, W, KV, dtype=torch.float32),
        }
    return {"k": zeros(Lr, batch, W, KV, hd), "v": zeros(Lr, batch, W, KV, hd)}


def _attn_block_decode(bp, x, ck, cv, pos, cfg, window, ks=None, vs=None):
    h, _ = L.attn_decode_step(
        bp["attn"], L.rms_norm(x, bp["ln1"], cfg.norm_eps), ck, cv, pos, cfg,
        window=window, k_scale=ks, v_scale=vs)
    x = x + h
    xn = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + L.mlp_apply(bp["mlp"], xn)


def decode_step(params: Params, state: Params,
                batch: Dict[str, torch.Tensor], pos: int, cfg: ArchConfig):
    """One token decode for a batch at position ``pos`` (one for the
    batch, as in the reference). Returns (logits (B,1,V), state); the
    state's cache tensors are updated in place."""
    _check_dense(cfg)
    x = params["embed"][batch["tokens"]]
    blocks = params["blocks"]
    if cfg.local_global_pattern:
        for i in range(cfg.num_layers // 2):
            x = _attn_block_decode(
                _layer(blocks, 2 * i), x, state["k_local"][i],
                state["v_local"][i], pos, cfg, cfg.sliding_window)
            x = _attn_block_decode(
                _layer(blocks, 2 * i + 1), x, state["k_global"][i],
                state["v_global"][i], pos, cfg, None)
    else:
        quant = "k_scale" in state
        for i in range(cfg.num_layers):
            x = _attn_block_decode(
                _layer(blocks, i), x, state["k"][i], state["v"][i], pos, cfg,
                cfg.sliding_window,
                state["k_scale"][i] if quant else None,
                state["v_scale"][i] if quant else None)
    return _lm_logits(params, cfg, x), state
