"""The port's cold-LLM prefill slice (configs, models.layers,
models.transformer, core.llm_graph; ColdEngine.decide -> run_cold on the
graph) against the JAX package's, on the CPU at small size: 2 layers,
d_model 128, d_ff 256, 2 heads, 1 kv head, head_dim 64, vocab 512
(``tests/test_llm_graph.py``'s configuration). The reference makes the
params; ``transformer.from_reference`` carries them over.

Tolerances:
* the layer functions in f32: 1e-5 (the same f32 arithmetic, another
  summation order);
* ``flash_attention_plain`` against ``flash_attention_ref`` and the Pallas
  kernel: the reference sweep's own, 5e-4 for f32 and 5e-2 for bf16;
* ``run_cold`` logits against the reference engine's: atol 0.1, rtol 0.05,
  the reference's own gate for this graph (bf16 execution; the port's
  attention keeps the scores in f32 where the reference's full_attention
  rounds them to bf16);
* nnv12 against sequential: 1e-5; f32_direct against bf16_cast: equal.
"""
import dataclasses
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.core.engine import ColdEngine as RefEngine
from repro.core.llm_graph import build_llm_graph as ref_build_llm_graph
from repro.core.llm_graph import tiny_llm_graph as ref_tiny_llm_graph
from repro.core.profiler import SyntheticProfiler as RefSynthetic
from repro.core.scheduler import Choice as RefChoice
from repro.kernels import ref as R
from repro.kernels.attention import flash_attention as pallas_flash
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch import bf16
from repro_torch.configs import get_config, list_archs
from repro_torch.core import llm_graph as LG
from repro_torch.core.engine import ColdEngine
from repro_torch.core.profiler import SyntheticProfiler
from repro_torch.core.scheduler import Choice
from repro_torch.kernels import ops
from repro_torch.kernels.attention import flash_attention_plain
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

# one intra-op thread: the suite runs in parallel workers, and the engine's
# CorePool threads already run layers concurrently
torch.set_num_threads(1)

SMALL = dict(num_layers=2, d_model=128, d_ff=256, num_heads=2,
             num_kv_heads=1, head_dim=64, vocab_size=512)


def _cfgs():
    return (ref_get_config("smollm-360m").reduced(**SMALL),
            get_config("smollm-360m").reduced(**SMALL))


@pytest.fixture(scope="module")
def params():
    rcfg, cfg = _cfgs()
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, cfg, rp, T.from_reference(jax.tree.map(np.asarray, rp))


def _engines(tmp_path, params, fmt="bundle"):
    rcfg, cfg, rp, pp = params
    rg, rx = ref_build_llm_graph(rcfg, rp)
    pg, px = LG.build_llm_graph(cfg, pp)
    assert np.array_equal(rx, px) and px.dtype == np.int32
    ref = RefEngine(rg, tmp_path / "ref", store_fmt=fmt)
    ref.profiler_factory = RefSynthetic
    port = ColdEngine(pg, tmp_path / "port", store_fmt=fmt, device="cpu")
    port.profiler_factory = SyntheticProfiler
    rs = ref.decide(rx, n_little=2, calibrate_interference=False)
    ps = port.decide(px, n_little=2, calibrate_interference=False)
    return ref, port, px, rs, ps


def _rng(*key):
    return np.random.default_rng(list(key))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def test_configs_equal_reference():
    assert list_archs() == ref_list_archs()
    for arch in list_archs():
        a, b = ref_get_config(arch), get_config(arch)
        assert type(a).__name__ == type(b).__name__ == "ArchConfig"
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert dataclasses.asdict(a.reduced()) == dataclasses.asdict(b.reduced())
        assert a.param_count() == b.param_count()
        assert a.layer_kinds() == b.layer_kinds()


# ---------------------------------------------------------------------------
# layers, f32
# ---------------------------------------------------------------------------
def _f32(*shape, key):
    return _rng(*key).standard_normal(shape).astype(np.float32)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def test_rms_norm_and_rope_match_reference():
    x, s = _f32(2, 5, 3, 64, key=(1,)), _f32(64, key=(2,)) * 0.1
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6),
           RL.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6))
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    _close(L.rope(torch.from_numpy(x), torch.from_numpy(np.array(pos)),
                  10_000.0),
           RL.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))


def test_attn_qkv_and_mlp_match_reference():
    rcfg, cfg = _cfgs()
    d, H, KV, hd, ff = 128, 2, 1, 64, 256
    p = {"wq": _f32(d, H * hd, key=(3,)), "wk": _f32(d, KV * hd, key=(4,)),
         "wv": _f32(d, KV * hd, key=(5,))}
    p = {k: v / np.sqrt(d) for k, v in p.items()}
    x = _f32(2, 7, d, key=(6,))
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    want = RL.attn_qkv({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), rcfg, jnp.asarray(pos))
    got = L.attn_qkv({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x), cfg, torch.from_numpy(np.array(pos)))
    for g, w in zip(got, want):
        _close(g, w)
    m = {"w_gate": _f32(d, ff, key=(7,)) / np.sqrt(d),
         "w_up": _f32(d, ff, key=(8,)) / np.sqrt(d),
         "w_down": _f32(ff, d, key=(9,)) / np.sqrt(ff)}
    _close(L.mlp_apply({k: torch.from_numpy(v) for k, v in m.items()},
                       torch.from_numpy(x)),
           RL.mlp_apply({k: jnp.asarray(v) for k, v in m.items()},
                        jnp.asarray(x)))


@pytest.mark.parametrize("window,softcap", [(None, None), (3, None),
                                            (None, 2.0)])
def test_full_attention_matches_reference(window, softcap):
    B, S, H, KV, D = 2, 9, 4, 2, 32
    q, k, v = (_f32(B, S, n, D, key=(10, i)) for i, n in
               enumerate((H, KV, KV)))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want = RL.full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(pos), jnp.asarray(pos),
                             window=window, softcap=softcap)
    tp = torch.from_numpy(np.array(pos))
    got = L.full_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), tp, tp, window=window,
                           softcap=softcap)
    _close(got, want)


# ---------------------------------------------------------------------------
# flash attention: the plain version over the reference's sweep
# ---------------------------------------------------------------------------
def _tol(dtype):
    return 5e-2 if dtype == "bfloat16" else 5e-4


def _qkv(B, S, H, KV, D, dtype, key):
    rng = _rng(*key)
    arrs = [rng.standard_normal((B, S, n, D)).astype(np.float32)
            for n in (H, KV, KV)]
    jt = [jnp.asarray(a, jnp.dtype(dtype)) * 0.3 for a in arrs]
    tt = [bf16.to_tensor(np.array(np.asarray(a)))
          if dtype == "bfloat16" else torch.from_numpy(np.array(a))
          for a in jt]
    return jt, tt


@pytest.mark.parametrize("S,H,KV,D", [(128, 4, 4, 64), (256, 4, 2, 64),
                                      (192, 8, 1, 32),
                                      # head dims off {32, 64, 128}: zamba2's
                                      # 80, and 96, 100, 67 and 256
                                      (96, 4, 2, 80), (64, 2, 1, 96),
                                      (80, 4, 2, 100), (72, 2, 2, 67),
                                      (64, 2, 1, 256)])
@pytest.mark.parametrize("window,softcap", [(None, None), (64, None),
                                            (None, 30.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_ref(S, H, KV, D, window, softcap,
                                           dtype):
    (jq, jk, jv), (q, k, v) = _qkv(2, S, H, KV, D, dtype,
                                   (11, S, H, KV, D))
    want = R.flash_attention_ref(jq, jk, jv, causal=True, window=window,
                                 softcap=softcap)
    ops.reset_launch_counts()
    for fn in (flash_attention_plain, ops.flash_attention):
        got = fn(q, k, v, causal=True, window=window, softcap=softcap)
        assert got.dtype == q.dtype and got.shape == q.shape
        np.testing.assert_allclose(got.to(torch.float32).numpy(),
                                   np.asarray(want, np.float32),
                                   atol=_tol(dtype), rtol=_tol(dtype))
    assert ops.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("S,H,KV,D,window,softcap,dtype", [
    (128, 4, 4, 64, None, None, "float32"),
    (256, 4, 2, 64, 64, None, "bfloat16"),
    (96, 4, 2, 80, None, None, "bfloat16"),
    (96, 4, 2, 80, 32, 30.0, "float32"),
    (80, 2, 1, 96, 48, None, "bfloat16"),
    (100, 4, 2, 100, 40, 30.0, "bfloat16"),
    (72, 2, 2, 67, None, 30.0, "float32"),
    (72, 2, 2, 67, 32, None, "bfloat16"),
    (64, 2, 1, 256, 24, 30.0, "bfloat16"),
    (64, 2, 1, 256, None, None, "float32"),
])
def test_flash_attention_plain_matches_pallas(S, H, KV, D, window, softcap,
                                              dtype):
    (jq, jk, jv), (q, k, v) = _qkv(2, S, H, KV, D, dtype, (12, S))
    want = pallas_flash(jq, jk, jv, causal=True, window=window,
                        softcap=softcap, bq=64, bk=64, interpret=True)
    got = ops.flash_attention(q, k, v, causal=True, window=window,
                              softcap=softcap)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32),
                               atol=_tol(dtype), rtol=_tol(dtype))


def test_flash_attention_rejects_bad_inputs(monkeypatch):
    q = torch.zeros(1, 8, 4, 32)
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros(1, 8, 3, 32),
                            torch.zeros(1, 8, 3, 32))
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros(1, 8, 2, 32),
                            torch.zeros(1, 8, 2, 16))
    # split across devices (meta, the dry run's, beside the CPU): no plain
    # fallback, no launch
    with pytest.raises(ValueError):
        ops.flash_attention(q.to("meta"), torch.zeros(1, 8, 2, 32),
                            torch.zeros(1, 8, 2, 32))
    # the CUDA kernel takes any head dim up to 256: a larger one is refused
    # before any launch, naming the limit (the CUDA branch, taken here on
    # CPU tensors, stops there)
    from repro_torch.kernels import _native
    monkeypatch.setattr(_native, "on_cpu", lambda *a, **k: False)
    qd = torch.zeros(1, 8, 2, 264, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="up to 256"):
        ops.flash_attention(qd, qd, qd)
    assert ops.launch_counts()["flash_attention"] == 0


# (B, S, H, KV, D, window, dtype): every flash_attention row of chip_smoke.py
FLASH_PLAN_ROWS = [
    (1, 64, 15, 5, 64, None, "bfloat16"), (1, 2048, 15, 5, 64, None,
                                           "bfloat16"),
    (1, 512, 24, 8, 64, None, "bfloat16"),
    (1, 1024, 32, 32, 80, None, "bfloat16"),
    (1, 1024, 32, 32, 80, None, "float32"),
    (1, 100, 15, 5, 64, None, "bfloat16"),
    (1, 1024, 15, 5, 64, 256, "float32"),
    (2, 200, 8, 2, 32, 64, "bfloat16"), (2, 130, 4, 4, 128, None, "bfloat16"),
    (1, 300, 8, 2, 100, 128, "bfloat16"), (1, 200, 4, 2, 67, 64, "bfloat16"),
    (1, 256, 4, 4, 256, None, "bfloat16"),
    (8, 256, 32, 4, 128, None, "bfloat16"),
    # the archs path's: gemma2-27b past its window, qwen3-32b's 64/8 heads
    (1, 4608, 32, 16, 128, 4096, "bfloat16"),
    (1, 512, 64, 8, 128, None, "bfloat16")]


@pytest.mark.parametrize("B,S,H,KV,D,window,dtype", FLASH_PLAN_ROWS)
def test_plan_flash(B, S, H, KV, D, window, dtype):
    """``plan_flash`` reads shapes (and masks) only and caches its answer,
    so a prefill can be captured in a CUDA graph; every cut fits the
    kernel: a compiled width holding D, at most 8 warps (16 query rows
    each, over ``heads`` x ``ksplit`` groups), shared memory within a
    block's 227 KB, the whole grid."""
    from repro_torch.kernels.attention import (FLASH_DP, FLASH_MAX_WARPS,
                                               flash_plans, plan_flash)

    dt = getattr(torch, dtype)
    p = plan_flash(B, S, H, KV, D, dt, True, window)
    assert plan_flash(B, S, H, KV, D, dt, True, window) is p
    assert p in flash_plans(B, S, H, KV, D, dt)
    assert p.dp == min(w for w in FLASH_DP[dt] if w >= D)
    assert p.smem <= 232448
    assert p.blocks == B * (H // p.heads) * -(-S // p.bq)
    if dtype == "float32":
        assert (p.bq, p.heads, p.ksplit, p.threads) == (64, 1, 1, 256)
    else:
        assert p.bq in (64, 128) and (H // KV) % p.heads == 0
        assert p.threads == 32 * p.heads * p.bq // 16 * p.ksplit
        assert p.threads <= 32 * FLASH_MAX_WARPS
        assert p.bk == (32 if p.dp > 128 else 64)


def test_plan_flash_decisions():
    """The cuts the design rests on: the long and granite prefills split
    each key stage over two warp groups; the cold 64-token prefill takes
    one 4-warp block a head; a batch with 8 query heads a kv head shares
    each K/V tile between two heads; D > 256 is refused."""
    from repro_torch.kernels.attention import plan_flash

    bf = torch.bfloat16
    for shape in [(1, 2048, 15, 5, 64), (1, 512, 24, 8, 64)]:
        p = plan_flash(*shape, bf)
        assert (p.bq, p.heads, p.ksplit) == (64, 1, 2)
    p = plan_flash(1, 64, 15, 5, 64, bf)
    assert (p.bq, p.heads, p.ksplit, p.threads) == (64, 1, 1, 128)
    assert plan_flash(8, 256, 32, 4, 128, bf).heads == 2
    with pytest.raises(ValueError, match="up to 256"):
        plan_flash(1, 64, 2, 1, 257, bf)
    with pytest.raises(ValueError, match="up to 256"):
        plan_flash(1, 64, 2, 1, 320, torch.float32)


# ---------------------------------------------------------------------------
# the graph's kernels
# ---------------------------------------------------------------------------
def test_transforms_give_reference_bytes(params):
    from repro.core import llm_graph as RLG

    rcfg, cfg, rp, pp = params
    rg, _ = ref_build_llm_graph(rcfg, rp)
    pg, _ = LG.build_llm_graph(cfg, pp)
    for rl, pl in zip(rg, pg):
        assert rl.spec.weight_shapes == pl.spec.weight_shapes
        for k, v in rl.weights.items():
            assert v.tobytes() == pl.weights[k].tobytes()
    pairs = [(RLG.TBlockBf16(), LG.TBlockBf16(), 1),
             (RLG.EmbedBf16(), LG.EmbedBf16(), 0),
             (RLG.HeadBf16(), LG.HeadBf16(), -1)]
    for rk, pk, i in pairs:
        rt = rk.transform(rg[i].weights, rg[i].spec)
        pt = pk.transform(pg[i].weights, pg[i].spec)
        assert sorted(rt) == sorted(pt)
        for k in rt:
            assert bf16.dtype_name(pt[k]) == str(rt[k].dtype) == "bfloat16"
            assert np.asarray(rt[k]).tobytes() == pt[k].tobytes()
    # rounding ties to even and NaN as ml_dtypes does, beyond these weights
    x = _f32(4096, key=(13,)) * np.float32(1e3)
    x[:3] = [np.nan, np.inf, -np.inf]
    assert bf16.from_float(x).tobytes() == np.asarray(
        jnp.asarray(x, jnp.bfloat16)).tobytes()


def test_forward_matches_graph_and_reference(params):
    """T.forward == the graph's kernels applied in a chain (both bf16),
    and both within the reference gate of the reference forward."""
    rcfg, cfg, rp, pp = params
    pg, toks = LG.build_llm_graph(cfg, pp)
    want, _, _ = RT.forward(rp, {"tokens": jnp.asarray(toks)}, rcfg)
    got, _, _ = T.forward(pp, {"tokens": torch.from_numpy(toks)}, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0.1,
                               rtol=0.05)
    y = torch.from_numpy(toks)
    for l, kern in zip(pg, [LG.EmbedDirect()]
                       + [LG.TBlockF32Direct()] * cfg.num_layers
                       + [LG.HeadDirect()]):
        y = kern.execute({k: torch.from_numpy(v) for k, v in
                          l.weights.items()}, y, l.spec)
    assert torch.equal(y, got)


def test_forward_local_global_softcaps_match_reference():
    """gemma2's pattern (even layers windowed, odd global), attention and
    final softcaps: a 40-token prompt crosses the reduced 32-token window."""
    rcfg = ref_get_config("gemma2-27b").reduced()
    cfg = get_config("gemma2-27b").reduced()
    assert cfg.local_global_pattern and cfg.sliding_window == 32
    rp = RT.init_params(jax.random.PRNGKey(1), rcfg)
    toks = _rng(14).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    want, _, _ = RT.forward(rp, {"tokens": jnp.asarray(toks)}, rcfg)
    got, aux, (_, mask) = T.forward(
        T.from_reference(jax.tree.map(np.asarray, rp)),
        {"tokens": torch.from_numpy(toks)}, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0.1,
                               rtol=0.05)
    assert float(aux) == 0.0 and tuple(mask.shape) == (2, 40)


# ---------------------------------------------------------------------------
# the engine on the LLM graph
# ---------------------------------------------------------------------------
def test_tiny_llm_graph_plan_identical_under_synthetic_profiles(tmp_path):
    rg, rx = ref_tiny_llm_graph(8)
    pg, px = LG.tiny_llm_graph(8)
    assert np.array_equal(rx, px)
    for r, p in zip(rg, pg):
        assert (r.spec.name, r.spec.op_type, r.spec.weight_shapes) == \
            (p.spec.name, p.spec.op_type, p.spec.weight_shapes)
        assert dataclasses.asdict(r.spec.config["cfg"]) == \
            dataclasses.asdict(p.spec.config["cfg"])
    ref = RefEngine(rg, tmp_path / "ref")
    ref.profiler_factory = RefSynthetic
    port = ColdEngine(pg, tmp_path / "port", device="cpu")
    port.profiler_factory = SyntheticProfiler
    rs = ref.decide(rx, n_little=3, calibrate_interference=False)
    ps = port.decide(px, n_little=3, calibrate_interference=False)
    assert port.plan.to_dict() == ref.plan.to_dict()
    assert ps["choices"] == {k: tuple(v) for k, v in rs["choices"].items()}
    for key in ("shape_classes", "profile_calls", "planned_cold_read_bytes",
                "prep_split", "est_makespan_s"):
        assert ps[key] == rs[key], key
    assert ps["shape_classes"] == 3  # embed, one for all 8 tblocks, lmhead
    assert port._sc_by_layer == ref._sc_by_layer
    # the profiles' transformed avatars say "bfloat16", never "uint16"
    assert port._transform_avatars.keys() == ref._transform_avatars.keys()
    for sc, kname in port._transform_avatars:
        rav = ref._transform_avatars.get((sc, kname))
        assert rav == port._transform_avatars[(sc, kname)]


@pytest.mark.parametrize("fmt", ["bundle", "super"])
def test_run_cold_matches_reference(tmp_path, params, fmt):
    ref, port, x, rs, ps = _engines(tmp_path, params, fmt)
    assert port.plan.to_dict() == ref.plan.to_dict()
    ops.reset_launch_counts()
    want = np.asarray(ref.run_cold(x).output)
    nnv12 = port.run_cold(x).output
    assert nnv12.dtype == torch.float32 and tuple(nnv12.shape) == (1, 64, 512)
    np.testing.assert_allclose(nnv12.numpy(), want, atol=0.1, rtol=0.05)
    seq = port.run_cold(x, mode="sequential").output
    assert float((nnv12 - seq).abs().max()) < 1e-5
    assert port.run_warm(x, repeats=1) > 0
    assert all(n == 0 for n in ops.launch_counts().values())
    assert not port.repairs.of_kind("kernel_demoted")


def _pinned(layers, kernel, cached, choice_cls):
    out = []
    for l in layers:
        name = kernel
        if kernel == "f32_direct" and l.spec.op_type != "tblock":
            name = "direct"
        out.append(choice_cls(name, cached))
    return out


def test_pinned_f32_direct_and_bf16_cast_are_identical(tmp_path, params):
    ref, port, x, _, _ = _engines(tmp_path, params, "super")
    outs = {}
    for kernel, cached in (("f32_direct", False), ("bf16_cast", True),
                           ("bf16_cast", False)):
        port.set_plan(replace(port.plan, choices=_pinned(
            port.layers, kernel, cached, Choice)))
        outs[kernel, cached] = port.run_cold(x).output
    ref.plan = replace(ref.plan, choices=_pinned(ref.layers, "f32_direct",
                                                 False, RefChoice))
    ref._runtimes.clear()
    want = np.asarray(ref.run_cold(x).output)
    first = outs["f32_direct", False]
    np.testing.assert_allclose(first.numpy(), want, atol=0.1, rtol=0.05)
    for out in outs.values():
        assert torch.equal(out, first)
    assert not port.repairs.of_kind("kernel_demoted")


def test_bf16_cache_halves_bytes_and_reads_across(tmp_path, params):
    """The bf16 cache decide() writes: half the raw bytes; each package's
    store opens in the other with equal bytes, dtype tags and CRCs."""
    from repro.checkpoint import LayerStore as RefStore
    from repro_torch.checkpoint import LayerStore

    ref, port, x, rs, ps = _engines(tmp_path, params, "super")
    assert ps["planned_cold_read_bytes"] == rs["planned_cold_read_bytes"]
    cached = [l.spec.name for l, c in zip(port.layers, port.plan.choices)
              if c.use_cache and c.kernel == "bf16_cast"]
    assert cached
    rfile = tmp_path / "ref" / "model.superbundle"
    pfile = tmp_path / "port" / "model.superbundle"
    assert rfile.read_bytes() == pfile.read_bytes()
    a = LayerStore(tmp_path / "ref", fmt="super")
    b = RefStore(tmp_path / "port", fmt="super")
    for name in cached:
        assert port.store.cached_bytes(name, "bf16_cast") * 2 == \
            port.store.raw_bytes(name)
        mine = a.read_cached(name, "bf16_cast")
        theirs = b.read_cached(name, "bf16_cast")
        assert sorted(mine) == sorted(theirs)
        for k in mine:
            assert bf16.dtype_name(mine[k]) == str(theirs[k].dtype) \
                == "bfloat16"
            assert mine[k].tobytes() == np.asarray(theirs[k]).tobytes()
        assert a.audit_cached(name, "bf16_cast")
        assert b.audit_cached(name, "bf16_cast")
