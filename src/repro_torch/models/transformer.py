"""Config-driven decoder for every family and input mode — the port of
``repro/models/transformer.py``.

``init_params`` draws from an explicit ``torch.Generator`` on the
generator's device: torch cannot reproduce ``jax.random``, so its weights
are the port's own (same shapes, same scales, same parameter tree).
``from_reference`` takes the JAX package's params as numpy arrays and
returns the port's, with the same values: parity tests and weight
transfer go through it.

``forward`` is the reference's forward for the dense family (plain and
gemma2's local/global layer pattern; vlm and audio run the same body),
the moe family (the MLP replaced by ``moe.moe_apply``, whose load-balance
losses sum into the aux loss), the ssm family (mamba2 blocks,
``ssm.mamba_apply_seq``) and the hybrid family (zamba2: G =
``num_layers / shared_attn_every`` groups, each ``shared_attn_every``
mamba blocks followed by the one ``shared`` attention and MLP block, its
weights unstacked and applied G times), a Python loop over the stacked
blocks in place of ``lax.scan``. Attention goes through the flash kernel
at every sequence length (the reference switches to ``chunked_attention``
above 8192 tokens; the kernel is that path's analogue), the expert FFNs
through ``gmm_blocks`` and the SSD scan through ``ssd_scan``.

Input modes, as in the reference: ``tokens`` (``embed[tokens]``),
``embeddings`` (``batch["embeds"]`` in the config dtype; no ``embed``, the
head is ``lm_head`` whether tied or not) and ``vlm``
(``batch["prefix_embeds"]`` in front of the token embeddings, RoPE
positions over both, the loss mask 0 over the prefix).

``init_decode_state`` and ``decode_step`` are the reference's decode for
the same families: plain, local/global (gemma2: a window ring for the
local layers, a full cache for the global ones) and the int8 KV cache
(``runtime_flags.FLAGS["kv_cache_int8"]``) for dense, moe, vlm and audio,
whose caches are the same; the conv and SSM states for ssm; for hybrid
the mamba states shaped (G, every, ...) and the shared block's caches
``shared_k``/``shared_v`` shaped (G, B, W, KV, hd), one per application.
A step takes ``batch["embeds"]`` (B, 1, d) in the ``embeddings`` mode and
``embed[batch["tokens"]]`` otherwise. Each step's attention runs on the
``decode_attention`` kernel. The state tensors are updated in place and
returned as the new state.

Training (every family: the dense body, the dense, vlm and audio
families in all three input modes; moe; ssm; hybrid). ``loss_fn`` is the
reference's next-token cross-entropy (label slicing and mask per input
mode, the logsumexp over the f32 logits, ``+ 0.01 * aux``).
``forward(remat=True)`` checkpoints (``torch.utils.checkpoint``,
non-reentrant) each block, each group of ``remat_group`` blocks where
that divides the depth (the reference's hierarchical remat), or each of
gemma2's (local, global) pairs; for ssm each mamba block, and for hybrid
each group of ``shared_attn_every`` mamba blocks with the shared block
after them, as the reference's ``jax.checkpoint`` of its scan body and of
its group (both ignore ``remat_group``). The aux loss is carried through
each checkpointed unit and summed layer by layer in the same order as
without remat (the same bits), and the recomputed forward routes as the
first did (a stable sort, no host sync). The stacked block weights are
taken apart with one ``torch.unbind`` a leaf a forward: indexing a stack
per layer under autograd would make each layer's backward write a
zero-filled gradient of the whole stack. The hybrid family's ``shared``
block is one set of leaves read by every group, so its gradient sums the
groups' in autograd's order, the same with remat as without. The
gradients flow through the ``matmul`` and ``flash_attention`` kernels'
autograd Functions, the MoE layer's (``moe._GroupedFFN``, whose backward
runs ``gmm_blocks`` and ``gmm_blocks_dw``) and ``ssd_scan``'s
(``ssd._SsdScan``, whose backward is ``ssd_scan_bwd``), and the token
embedding is read with ``F.embedding``, whose backward sums the rows
deterministically.

``forward(collect_cache=True)`` also returns the prefill cache in the
reference's pytree, leaf for leaf: ``{"kv": (k, v)}`` with leaves (L, B,
S, KV, hd) (the post-RoPE keys and values the attention read) for dense,
moe, vlm and audio; ``{"local": (k, v), "global": (k, v)}`` with (L/2,
...) leaves for gemma2's pairs; ``{"mamba": ((conv_x, conv_B, conv_C),
ssm)}`` with (L, ...) leaves for ssm; and for hybrid the mamba states
shaped (G, every, ...) with ``"shared_kv": (k, v)`` (G, B, S, KV, hd),
one per application of the shared block. Collecting only keeps what the
blocks compute anyway, so the logits are the same bits, with or without
remat.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import bf16
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.runtime_flags import FLAGS

Params = Dict[str, Any]


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
INPUT_MODES = ("tokens", "embeddings", "vlm")


def _check_family(cfg: ArchConfig) -> None:
    """``ValueError`` for a family or input mode the decoder does not know,
    the reference's refusal (``forward``, ``init_decode_state``,
    ``decode_step``, ``_embed_input``)."""
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)
    if cfg.input_mode not in INPUT_MODES:
        raise ValueError(cfg.input_mode)
    if cfg.family == "hybrid" and (
            not cfg.shared_attn_every
            or cfg.num_layers % cfg.shared_attn_every):
        raise ValueError(
            f"{cfg.name}: {cfg.num_layers} layers do not split into groups "
            f"of shared_attn_every={cfg.shared_attn_every}")


def _groups(cfg: ArchConfig) -> int:
    """The hybrid family's G: mamba groups, each followed by the shared
    block."""
    return cfg.num_layers // cfg.shared_attn_every


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _normal(g: torch.Generator, shape, scale: float, dt,
            device) -> torch.Tensor:
    return (torch.randn(shape, generator=g, dtype=torch.float32,
                        device=device) * scale).to(dt)


def init_params(cfg: ArchConfig, g: torch.Generator, *,
                device=None) -> Params:
    """Random weights from ``g`` in the reference's tree and scales (embed
    N(0, .02²), projections N(0, 1/fan_in), norms zero), stacked (L, ...)
    per block weight, in ``cfg.dtype``, on ``g``'s device (the CPU for a
    default generator; a CUDA generator draws a full-width model on the
    card, with no f32 copy on the host). ``device="meta"`` builds the same
    tree of shapes and dtypes with no data and draws nothing
    (``launch.specs.params_shape``). ``embed`` for the ``tokens`` and
    ``vlm`` modes, ``lm_head`` for an untied head or the ``embeddings``
    mode; the hybrid family's mamba ``blocks`` and its one ``shared``
    attention block, drawn once and not stacked."""
    _check_family(cfg)
    dt = _dtype(cfg)
    dev = torch.device(device) if device is not None else g.device
    d, V, Lr = cfg.d_model, cfg.vocab_size, cfg.num_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    params: Params = {}
    if cfg.input_mode in ("tokens", "vlm"):
        params["embed"] = _normal(g, (V, d), 0.02, dt, dev)
    if not cfg.tie_embeddings or cfg.input_mode == "embeddings":
        params["lm_head"] = _normal(g, (d, V), 1.0 / math.sqrt(d), dt, dev)
    if cfg.family in ("ssm", "hybrid"):
        params["blocks"] = {"ln1": zeros(Lr, d),
                            "mamba": SSM.mamba_init(cfg, g, Lr, device=dev)}
    else:
        params["blocks"] = _attn_blocks_init(cfg, g, Lr, dev)
    if cfg.family == "hybrid":
        params["shared"] = _layer(_attn_blocks_init(cfg, g, 1, dev), 0)
    params["final_norm"] = zeros(d)
    return params


def _attn_blocks_init(cfg: ArchConfig, g: torch.Generator, n: int,
                      device) -> Params:
    """``n`` attention blocks (norms, attention, MLP or MoE) stacked
    (n, ...) on ``device``."""
    dt = _dtype(cfg)
    d, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd, ff = cfg.head_dim, cfg.d_ff

    def dense(shape):
        return _normal(g, (n, *shape), 1.0 / math.sqrt(shape[0]), dt, device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    attn = {"wq": dense((d, H * hd)), "wk": dense((d, KV * hd)),
            "wv": dense((d, KV * hd)), "wo": dense((H * hd, d))}
    if cfg.qk_norm:
        attn["q_norm"] = zeros(n, hd)
        attn["k_norm"] = zeros(n, hd)
    blocks = {"ln1": zeros(n, d), "ln2": zeros(n, d), "attn": attn}
    if cfg.is_moe:
        blocks["moe"] = MOE.moe_init(cfg, g, n, device=device)
    else:
        blocks["mlp"] = {"w_gate": dense((d, ff)), "w_up": dense((d, ff)),
                         "w_down": dense((ff, d))}
    return blocks


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
def _ffn(bp, xn, cfg):
    """The block's MLP or MoE: (out, aux loss or None)."""
    if "moe" in bp:
        return MOE.moe_apply(bp["moe"], xn, cfg)
    return L.mlp_apply(bp["mlp"], xn), None


def _attn_block_seq(bp, x, cfg, positions, window, kv_out=None):
    """(x, aux or None); with a list ``kv_out`` the attention's (k, v)
    (B, S, KV, hd) is appended to it."""
    h, kv = L.attn_apply_seq(
        bp["attn"], L.rms_norm(x, bp["ln1"], cfg.norm_eps), cfg, positions,
        window=window)
    if kv_out is not None:
        kv_out.append(kv)
    x = x + h
    h2, aux = _ffn(bp, L.rms_norm(x, bp["ln2"], cfg.norm_eps), cfg)
    return x + h2, aux


def _mamba_block_seq(bp, x, cfg, conv_states=None, ssm_state=None):
    h, states = SSM.mamba_apply_seq(
        bp["mamba"], L.rms_norm(x, bp["ln1"], cfg.norm_eps), cfg,
        conv_states=conv_states, ssm_state=ssm_state)
    return x + h, states


def _embed_input(params, cfg, batch):
    """Returns (x (B,S,d), loss_mask (B,S)): the token embeddings, the
    given embeddings in the config dtype, or the vlm prefix in front of
    the token embeddings (mask 0 over the prefix, 1 over the text)."""
    if cfg.input_mode == "tokens":
        x = F.embedding(batch["tokens"], params["embed"])
        mask = torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
    elif cfg.input_mode == "embeddings":
        x = batch["embeds"].to(_dtype(cfg))
        mask = torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
    elif cfg.input_mode == "vlm":
        tok = F.embedding(batch["tokens"], params["embed"])
        pre = batch["prefix_embeds"].to(_dtype(cfg))
        x = torch.cat([pre, tok], dim=1)
        mask = torch.cat(
            [torch.zeros(pre.shape[:2], dtype=torch.float32, device=x.device),
             torch.ones(tok.shape[:2], dtype=torch.float32,
                        device=x.device)], dim=1)
    else:
        raise ValueError(cfg.input_mode)
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
def _unbind(tree, n: int) -> List[Params]:
    """The (n, ...) stacked leaves of ``tree`` as n per-layer trees, one
    ``torch.unbind`` a leaf."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree))


def _remat_unit(cfg: ArchConfig, remat_group: int) -> int:
    """Blocks a checkpointed unit: gemma2's (local, global) pair, else
    ``remat_group`` where it divides the depth, else one."""
    if cfg.local_global_pattern:
        return 2
    g = max(remat_group, 1)
    return g if cfg.num_layers % g == 0 else 1


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            *, remat: bool = False, remat_group: int = 1,
            collect_cache: bool = False):
    """Full-sequence forward. Returns (logits, aux_loss, (cache, mask)),
    the reference's return shape: the aux loss sums the MoE layers'
    load-balance losses (zero for the other families); the cache is
    ``None`` unless ``collect_cache``, and then the family's prefill cache
    (the module docstring), which seeds decode at position S. ``remat``
    (under grad) checkpoints the blocks as ``_remat_unit`` groups them, a
    mamba block at a time for ssm and a group (its mamba blocks and the
    shared block) at a time for hybrid; a checkpointed unit hands its
    part of the cache out with x."""
    _check_family(cfg)
    x, loss_mask = _embed_input(params, cfg, batch)
    B, S, _ = x.shape
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    layers = _unbind(params["blocks"], cfg.num_layers)
    every = cfg.shared_attn_every

    def run(x, aux, lo: int, hi: int):
        """Blocks lo .. hi - 1; a hybrid unit is one group, its mamba
        blocks and then the shared block. Returns (x, aux, the units' (k,
        v) pairs, their mamba states), the last two empty unless
        collecting."""
        kvs = [] if collect_cache else None
        states = []
        for i in range(lo, hi):
            if cfg.family in ("ssm", "hybrid"):
                x, st = _mamba_block_seq(layers[i], x, cfg)
                if collect_cache:
                    states.append(st)
                continue
            window = cfg.sliding_window
            if cfg.local_global_pattern and i % 2 == 1:
                window = None  # (local, global) pairs: odd layers are global
            x, a = _attn_block_seq(layers[i], x, cfg, positions, window, kvs)
            if a is not None:
                aux = aux + a
        if cfg.family == "hybrid":
            x, a = _attn_block_seq(params["shared"], x, cfg, positions,
                                   cfg.sliding_window, kvs)
            if a is not None:
                aux = aux + a
        return x, aux, kvs or [], states

    # the checkpointed unit: a mamba block (ssm), a group (hybrid, as the
    # reference's jax.checkpoint(group)), else _remat_unit's blocks
    unit = {"ssm": 1, "hybrid": every}.get(cfg.family) or _remat_unit(
        cfg, remat_group)
    ckpt = remat and torch.is_grad_enabled()
    if not ckpt and cfg.family != "hybrid":
        unit = cfg.num_layers
    kvs, states = [], []
    for lo in range(0, cfg.num_layers, unit):
        if ckpt:
            # each unit's aux leaves its checkpoint with x, summed in
            # layer order
            x, aux, kv, st = checkpoint(
                lambda x, aux, lo=lo: run(x, aux, lo, lo + unit), x, aux,
                use_reentrant=False)
        else:
            x, aux, kv, st = run(x, aux, lo, lo + unit)
        kvs += kv
        states += st
    cache = _prefill_cache(cfg, kvs, states) if collect_cache else None
    return _lm_logits(params, cfg, x), aux, (cache, loss_mask)


def _stack_kv(kvs) -> tuple:
    return (torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs]))


def _prefill_cache(cfg: ArchConfig, kvs, states) -> Params:
    """The reference's prefill cache from the blocks' (k, v) pairs and
    mamba states ((conv_x, conv_B, conv_C), ssm), in layer order."""
    if cfg.family in ("ssm", "hybrid"):
        conv = tuple(torch.stack([c[j] for c, _ in states]) for j in range(3))
        mamba = (conv, torch.stack([s for _, s in states]))
        if cfg.family == "ssm":
            return {"mamba": mamba}
        lead = (_groups(cfg), cfg.shared_attn_every)
        mamba = (tuple(c.view(*lead, *c.shape[1:]) for c in mamba[0]),
                 mamba[1].view(*lead, *mamba[1].shape[1:]))
        return {"mamba": mamba, "shared_kv": _stack_kv(kvs)}
    if cfg.local_global_pattern:
        return {"local": _stack_kv(kvs[0::2]), "global": _stack_kv(kvs[1::2])}
    return {"kv": _stack_kv(kvs)}


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            *, remat: bool = False, remat_group: int = 1):
    """Next-token cross-entropy, the reference's: (total, {"loss",
    "aux_loss"}) with total = loss + 0.01 · aux. The vlm mode scores the
    text after its prefix; the embeddings mode scores ``batch["labels"]``;
    the loss mask's mean over the scored positions (at least 1)."""
    logits, aux, (_, mask) = forward(params, batch, cfg, remat=remat,
                                     remat_group=remat_group)
    if cfg.input_mode == "vlm":
        P = cfg.num_prefix_embeds
        lg = logits[:, P:-1]
        lb = batch["tokens"][:, 1:]
        m = mask[:, P + 1:]
    elif cfg.input_mode == "embeddings":
        lg = logits[:, :-1]
        lb = batch["labels"][:, 1:]
        m = mask[:, 1:]
    else:
        lg = logits[:, :-1]
        lb = batch["tokens"][:, 1:]
        m = mask[:, 1:]
    logz = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, lb.to(torch.int64)[..., None])[..., 0]
    nll = (logz - ll) * m
    loss = nll.sum() / torch.clamp(m.sum(), min=1.0)
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux_loss": aux}


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_decode_state(cfg: ArchConfig, batch: int, context_len: int, *,
                      device="cuda") -> Params:
    """Zero-initialised decode caches sized for ``context_len`` history
    (the reference's shapes and dtypes): KV caches for dense, moe, vlm and
    audio, the per-layer conv and SSM states for ssm, and for hybrid the
    mamba states (G, every, ...) with the shared block's KV caches
    ``shared_k``/``shared_v`` (G, B, W, KV, hd). On the card unless
    ``device`` says otherwise; raises without one."""
    _check_family(cfg)
    device = resolve_device(device)
    dt = _dtype(cfg)
    KV, hd, Lr = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    W = (min(cfg.sliding_window, context_len) if cfg.sliding_window
         else context_len)
    if cfg.family in ("ssm", "hybrid"):
        lead = ((Lr,) if cfg.family == "ssm"
                else (_groups(cfg), cfg.shared_attn_every))
        s = SSM.mamba_state_init(cfg, batch, dt, device=device)
        state = {k: zeros(*lead, *v.shape, dtype=v.dtype)
                 for k, v in s.items()}
        if cfg.family == "hybrid":
            state["shared_k"] = zeros(_groups(cfg), batch, W, KV, hd)
            state["shared_v"] = zeros(_groups(cfg), batch, W, KV, hd)
        return state

    if cfg.local_global_pattern:
        Wl = min(cfg.sliding_window, context_len)
        return {
            "k_local": zeros(Lr // 2, batch, Wl, KV, hd),
            "v_local": zeros(Lr // 2, batch, Wl, KV, hd),
            "k_global": zeros(Lr // 2, batch, context_len, KV, hd),
            "v_global": zeros(Lr // 2, batch, context_len, KV, hd),
        }
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
    h2, _ = _ffn(bp, L.rms_norm(x, bp["ln2"], cfg.norm_eps), cfg)
    return x + h2


_MAMBA_STATE = ("conv_x", "conv_B", "conv_C", "ssm")


def _mamba_block_decode(bp, x, st, cfg):
    h, ((sx, sB, sC), ssm) = SSM.mamba_decode_step(
        bp["mamba"], L.rms_norm(x, bp["ln1"], cfg.norm_eps), cfg,
        (st["conv_x"], st["conv_B"], st["conv_C"]), st["ssm"])
    return x + h, {"conv_x": sx, "conv_B": sB, "conv_C": sC, "ssm": ssm}


def _mamba_layer_decode(blocks, i, x, state, at, cfg):
    """Mamba layer ``i`` of ``blocks`` on its state ``state[k][at]``,
    updated in place."""
    x, st = _mamba_block_decode(
        _layer(blocks, i), x, {k: state[k][at] for k in _MAMBA_STATE}, cfg)
    for k in _MAMBA_STATE:
        state[k][at].copy_(st[k])
    return x


def decode_step(params: Params, state: Params,
                batch: Dict[str, torch.Tensor], pos, cfg: ArchConfig):
    """One token decode for a batch at position ``pos`` (one for the
    batch, as in the reference): ``batch["embeds"]`` (B, 1, d) in the
    ``embeddings`` mode, ``batch["tokens"]`` (B, 1) otherwise. ``pos`` is
    an int or a 0-d integer tensor on the state's device, which the step
    never reads back (the reference's traced ``pos``: a CUDA graph of the
    step serves every position). Returns (logits (B,1,V), state); the
    state's tensors are updated in place (an ssm model ignores ``pos``)."""
    _check_family(cfg)
    if cfg.input_mode == "embeddings":
        x = batch["embeds"].to(_dtype(cfg))
    else:
        x = params["embed"][batch["tokens"]]
    blocks = params["blocks"]
    if cfg.family == "ssm":
        for i in range(cfg.num_layers):
            x = _mamba_layer_decode(blocks, i, x, state, i, cfg)
    elif cfg.family == "hybrid":
        every = cfg.shared_attn_every
        for grp in range(_groups(cfg)):
            for j in range(every):
                x = _mamba_layer_decode(blocks, grp * every + j, x, state,
                                        (grp, j), cfg)
            x = _attn_block_decode(
                params["shared"], x, state["shared_k"][grp],
                state["shared_v"][grp], pos, cfg, cfg.sliding_window)
    elif cfg.local_global_pattern:
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
