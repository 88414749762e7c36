"""Cold-start LLM serving: express a transformer as a ColdEngine layer graph
— the port of ``repro/core/llm_graph.py``, lossless kernels.

Each decoder block is one schedulable unit ('tblock') whose weights stream
from disk, so the paper's three knobs apply to LLM serving directly:
  K — kernel selection: `f32_direct` (read f32 master weights, cast at
      execute) vs `bf16_cast` (weights transformed to bf16 — when cached,
      HALF the disk bytes per cold read; numerically identical to the bf16
      model definition, so zero accuracy loss w.r.t. the deployed model);
  C — cache the post-transformed (bf16) weights on disk;
  P — pipeline block weight reads with execution: the first blocks compute
      while later blocks are still loading.

The graph is embed -> L× tblock -> final_norm+lm_head, all chain-shaped (the
engine's dependency model); residual adds live inside each block unit.

Execution is bf16 on the hand-written kernels: the seven projections of a
block and the head go through the bf16 ``matmul``, the attention through
``flash_attention`` (``models.layers``). ``transform`` is numpy and
byte-identical to the reference's: ``bf16_cast`` rounds to nearest-even
into ``bf16.BFLOAT16`` arrays, the bytes ``ml_dtypes`` gives there. The
int8/int4 tblock and lmhead kernels wait for the lossy slice
(``ColdEngine(allow_lossy=True)`` raises until then).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import bf16
from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import LayerDef
from repro_torch.core.registry import KERNEL_REGISTRY, Kernel, LayerSpec
from repro_torch.models import layers as L

_BF16 = torch.bfloat16


def _block_forward(w: Dict[str, torch.Tensor], x: torch.Tensor,
                   cfg: ArchConfig, dtype) -> torch.Tensor:
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    wd = {k: v.to(dtype) for k, v in w.items()}
    p = {"wq": wd["wq"], "wk": wd["wk"], "wv": wd["wv"], "wo": wd["wo"]}
    if cfg.qk_norm:
        p["q_norm"], p["k_norm"] = wd["q_norm"], wd["k_norm"]
    h = L.rms_norm(x, wd["ln1"], cfg.norm_eps)
    attn, _ = L.attn_apply_seq(p, h, cfg, positions,
                               window=cfg.sliding_window)
    x = x + attn
    h = L.rms_norm(x, wd["ln2"], cfg.norm_eps)
    mlp = L.mlp_apply(
        {"w_gate": wd["w_gate"], "w_up": wd["w_up"], "w_down": wd["w_down"]}, h)
    return x + mlp


def _to_bf16(raw: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k: bf16.from_float(v) for k, v in raw.items()}


class TBlockF32Direct(Kernel):
    """Read f32 master weights, cast to bf16 at execute — zero transform."""
    name = "f32_direct"
    op_type = "tblock"

    def execute(self, w, x, spec):
        return _block_forward(w, x, spec.config["cfg"], _BF16)


class TBlockBf16(Kernel):
    """Transform = cast the block to bf16 (the deployed precision): cached
    post-transform weights are HALF the raw bytes -> ~2x faster cold reads.
    Bit-identical to f32_direct's execution (both run the block in bf16)."""
    name = "bf16_cast"
    op_type = "tblock"

    def transform(self, raw, spec):
        return _to_bf16(raw)

    def execute(self, w, x, spec):
        return _block_forward(w, x, spec.config["cfg"], _BF16)


class EmbedDirect(Kernel):
    name = "direct"
    op_type = "embed"

    def execute(self, w, x, spec):
        # gather, then cast: the same values as casting the whole table
        return w["embed"][x].to(_BF16)


class EmbedBf16(Kernel):
    name = "bf16_cast"
    op_type = "embed"

    def transform(self, raw, spec):
        return {"embed": bf16.from_float(raw["embed"])}

    def execute(self, w, x, spec):
        return w["embed"][x]


class HeadDirect(Kernel):
    name = "direct"
    op_type = "lmhead"

    def execute(self, w, x, spec):
        cfg = spec.config["cfg"]
        h = L.rms_norm(x, w["final_norm"].to(_BF16), cfg.norm_eps)
        return L._mm(h, w["w"].to(_BF16)).to(torch.float32)


class HeadBf16(Kernel):
    name = "bf16_cast"
    op_type = "lmhead"

    def transform(self, raw, spec):
        return _to_bf16(raw)

    def execute(self, w, x, spec):
        cfg = spec.config["cfg"]
        h = L.rms_norm(x, w["final_norm"], cfg.norm_eps)
        return L._mm(h, w["w"]).to(torch.float32)


KERNEL_REGISTRY.setdefault("tblock", [TBlockF32Direct(), TBlockBf16()])
KERNEL_REGISTRY.setdefault("embed", [EmbedDirect(), EmbedBf16()])
KERNEL_REGISTRY.setdefault("lmhead", [HeadDirect(), HeadBf16()])


def _f32(a: torch.Tensor) -> np.ndarray:
    """A weight as a contiguous float32 numpy array."""
    return np.ascontiguousarray(a.detach().to("cpu", torch.float32).numpy())


def build_llm_graph(cfg: ArchConfig, params) -> Tuple[List[LayerDef],
                                                      np.ndarray]:
    """Convert dense-family transformer params (``transformer.init_params``
    or ``transformer.from_reference``) into an engine
    graph + an example token batch. Raw storage is f32 (the master
    checkpoint); execution is bf16 (the deployed precision)."""
    assert cfg.family in ("dense",), "cold-LLM graph demo targets dense archs"
    defs: List[LayerDef] = []
    defs.append(LayerDef(
        spec=LayerSpec("embed", "embed", {"cfg": cfg},
                       {"embed": tuple(params["embed"].shape)}),
        weights={"embed": _f32(params["embed"])},
    ))
    blocks = params["blocks"]
    for i in range(cfg.num_layers):
        bw = {
            "ln1": _f32(blocks["ln1"][i]), "ln2": _f32(blocks["ln2"][i]),
            "wq": _f32(blocks["attn"]["wq"][i]),
            "wk": _f32(blocks["attn"]["wk"][i]),
            "wv": _f32(blocks["attn"]["wv"][i]),
            "wo": _f32(blocks["attn"]["wo"][i]),
            "w_gate": _f32(blocks["mlp"]["w_gate"][i]),
            "w_up": _f32(blocks["mlp"]["w_up"][i]),
            "w_down": _f32(blocks["mlp"]["w_down"][i]),
        }
        if cfg.qk_norm:
            bw["q_norm"] = _f32(blocks["attn"]["q_norm"][i])
            bw["k_norm"] = _f32(blocks["attn"]["k_norm"][i])
        defs.append(LayerDef(
            spec=LayerSpec(f"block{i:03d}", "tblock", {"cfg": cfg},
                           {k: tuple(v.shape) for k, v in bw.items()}),
            weights=bw,
        ))
    head_w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    defs.append(LayerDef(
        spec=LayerSpec("lm_head", "lmhead", {"cfg": cfg},
                       {"w": tuple(head_w.shape),
                        "final_norm": tuple(params["final_norm"].shape)}),
        weights={"w": _f32(head_w), "final_norm": _f32(params["final_norm"])},
    ))
    rng = np.random.default_rng(0)
    x = rng.integers(0, cfg.vocab_size, size=(1, 64)).astype(np.int32)
    return defs, x


def tiny_llm_graph(num_layers: int = 8, *, seed: int = 0
                   ) -> Tuple[List[LayerDef], np.ndarray]:
    """A small dense graph with ``num_layers`` shape-identical decoder blocks
    — the canonical shape-class workload for tests: all tblocks fall into
    ONE shape class, so ``decide()`` should profile/compile each kernel
    once, not L times. Weights are the port's own (``init_params`` from
    ``seed``); shapes, and so plans under ``SyntheticProfiler``, equal the
    reference's ``tiny_llm_graph``."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("smollm-360m").reduced(
        num_layers=num_layers, d_model=128, d_ff=256, num_heads=2,
        num_kv_heads=1, head_dim=64, vocab_size=512)
    params = T.init_params(cfg, torch.Generator().manual_seed(seed))
    return build_llm_graph(cfg, params)
