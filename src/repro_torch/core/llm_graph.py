"""Cold-start LLM serving: express a transformer as a ColdEngine layer graph
— the port of ``repro/core/llm_graph.py``.

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
into ``bf16.BFLOAT16`` arrays, the bytes ``ml_dtypes`` gives there.

Under ``ColdEngine(allow_lossy=True)`` the tblock and lmhead also take the
quantized cache (knob C's last rungs): ``int8``/``int4`` store every 2-D
matmul operand per channel (``quant.quantize_weights``) and 1-D gains as
bf16. ``_dequant`` expands them with the ``dequant_int8``/``dequant_int4``
kernels to f32, which the bf16 block forward casts to bf16, as the
reference does — the weights the bf16 GEMMs see are exactly the
reference's.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import bf16
from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import LayerDef
from repro_torch.core.registry import (
    KERNEL_REGISTRY, LOSSY_KERNELS, Kernel, LayerSpec,
)
from repro_torch.kernels import ops
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


def _dequant(w: Dict[str, torch.Tensor], spec: LayerSpec
             ) -> Dict[str, torch.Tensor]:
    """Expand a companion-key weight dict (``repro_torch.quant``
    convention) to a plain dict: int8/int4 tensors dequantized to f32 by
    the ``dequant_int8``/``dequant_int4`` kernels, everything else passed
    through. The logical K of a packed int4 tensor comes from the layer
    spec."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in w.items():
        if k.endswith(":qscale") or k.endswith(":qzero"):
            continue
        if k.endswith(":q8"):
            base = k[: -len(":q8")]
            out[base] = ops.dequant_int8(v, w[base + ":qscale"])
        elif k.endswith(":q4"):
            base = k[: -len(":q4")]
            out[base] = ops.dequant_int4(v, w[base + ":qscale"],
                                         spec.weight_shapes[base][0])
        else:
            out[k] = v
    return out


def _quantize(raw: Dict[str, np.ndarray], bits: int) -> Dict[str, np.ndarray]:
    """2-D matmul operands per channel in ``bits``, 1-D gains as bf16."""
    from repro_torch import quant

    out = quant.quantize_weights(raw, bits=bits)
    return {k: (bf16.from_float(v) if getattr(v, "ndim", 0) == 1 else v)
            for k, v in out.items()}


class TBlockInt8(Kernel):
    """Quantized transform cache for a decoder block: every 2-D matmul
    operand stored as per-channel int8 (+f32 scales in the extent header),
    1-D norm gains as bf16 — ~4x fewer cold cache bytes than f32, ~2x
    fewer than bf16_cast. Execution dequantizes on the card and runs the
    same bf16 block forward. Lossy (bounded per-weight error), so gated
    behind the engine's ``allow_lossy``."""
    name = "int8"
    op_type = "tblock"
    bits = 8

    def transform(self, raw, spec):
        return _quantize(raw, self.bits)

    def execute(self, w, x, spec):
        return _block_forward(_dequant(w, spec), x, spec.config["cfg"], _BF16)


class TBlockInt4(TBlockInt8):
    """Nibble-packed int4 block cache: ~8x fewer cold cache bytes than f32
    — the last rung of the read-bytes ladder; coarser than int8."""
    name = "int4"
    bits = 4


class HeadInt8(Kernel):
    """lm_head with the vocab-projection matrix as per-channel int8."""
    name = "int8"
    op_type = "lmhead"
    bits = 8

    def transform(self, raw, spec):
        return _quantize(raw, self.bits)

    def execute(self, w, x, spec):
        cfg = spec.config["cfg"]
        wd = _dequant(w, spec)
        h = L.rms_norm(x, wd["final_norm"].to(_BF16), cfg.norm_eps)
        return L._mm(h, wd["w"].to(_BF16)).to(torch.float32)


class HeadInt4(HeadInt8):
    name = "int4"
    bits = 4


KERNEL_REGISTRY.setdefault("tblock", [TBlockF32Direct(), TBlockBf16()])
KERNEL_REGISTRY.setdefault("embed", [EmbedDirect(), EmbedBf16()])
KERNEL_REGISTRY.setdefault("lmhead", [HeadDirect(), HeadBf16()])
# quantized variants are lossy: eligible only under the engine's allow_lossy
# (embed stays unquantized — it's a gather, not a matmul, and its rows feed
# the residual stream directly)
LOSSY_KERNELS.setdefault("tblock", [TBlockInt8(), TBlockInt4()])
LOSSY_KERNELS.setdefault("lmhead", [HeadInt8(), HeadInt4()])


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
