"""The port's lossy cold path (``allow_lossy=True``) against the JAX
package's, on the CPU at small sizes: the four quantization kernels'
plain versions (repro_torch.kernels.quant), the bf16-in f32-out matmul,
the lossy registry kernels (``LinearLowPrecision``, ``LinearInt8``,
``LinearInt4``; ``TBlockInt8/Int4``, ``HeadInt8/Int4``, ``_dequant``),
plans under ``SyntheticProfiler``, ``run_cold`` under pinned quantized
plans, and v4 stores with int8/int4 cache entries across packages.

Pallas kernels run with ``interpret=True``, as tests/test_quant_cache.py
runs them. Inputs are made from a seed with numpy and handed to both.

Tolerances:
* dequant (int8, int4): exact — one f32 multiply of exact values;
* fused dequant-matmul against the Pallas kernel: rtol = atol = 1e-5 — both
  apply the scale once after the contraction; against the oracle
  ``ref.matmul_dequant_*_ref``, which dequantizes first (one more rounding
  per weight, then K products summed): atol = 1e-6·K·max|x|·max|w|,
  rtol 1e-5 — the O(K·eps) gap behind the reference's own failing
  ``[2-256-256]`` case;
* bf16-in f32-out matmul, ``LinearLowPrecision``, ``LinearInt8/Int4``
  execute: 1e-4 (the same exact products summed in another order);
* a decoder block or the LM head in bf16: atol 0.05, rtol 0.05 (bf16
  outputs; the port's attention keeps the scores in f32 where the
  reference rounds them to bf16);
* ``run_cold`` logits under pinned int8/int4 plans: atol 0.1, rtol 0.05,
  the reference's own gate for this graph; a CNN with its head on
  int8/int4: 1e-4 (f32 throughout); on bf16: 2e-3, since the head rounds
  its f32 input to bf16 and inputs that differ in their last f32 bits
  (other summation orders in the convs) can round one bf16 step apart
  (2^-8 relative) before 256–1024 products are summed.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import quant as ref_quant
from repro.core import llm_graph as RLG
from repro.core import registry as RR
from repro.core.engine import ColdEngine as RefEngine
from repro.core.llm_graph import build_llm_graph as ref_build_llm_graph
from repro.core.llm_graph import tiny_llm_graph as ref_tiny_llm_graph
from repro.core.profiler import SyntheticProfiler as RefSynthetic
from repro.core.scheduler import Choice as RefChoice
from repro.kernels import quant as KQ
from repro.kernels import ref as R
from repro.models import transformer as RT
from repro.models.cnn import build_cnn as ref_build_cnn
from repro_torch import bf16, quant
from repro_torch.core import llm_graph as LG
from repro_torch.core import registry as PR
from repro_torch.core.engine import ColdEngine
from repro_torch.core.profiler import SyntheticProfiler
from repro_torch.core.scheduler import Choice
from repro_torch.kernels import ops
from repro_torch.kernels import quant as Q
from repro_torch.kernels.matmul import matmul_plain
from repro_torch.models import transformer as T
from repro_torch.models.cnn import CNN_NAMES, build_cnn

# one intra-op thread: the suite runs in parallel workers, and the engine's
# CorePool threads already run layers concurrently
torch.set_num_threads(1)

_SHAPES_MKN = [(4, 37, 16), (8, 64, 130), (3, 129, 7), (2, 256, 256)]


def _rng(*key):
    return np.random.default_rng(list(key))


def _t(a):
    """numpy (bf16-tagged or ml_dtypes bf16 too) -> CPU tensor, copied."""
    a = np.asarray(a)
    if str(a.dtype) == "bfloat16":
        a = a.view(np.uint16).view(bf16.BFLOAT16)
    return bf16.to_tensor(np.array(a))


@pytest.fixture(autouse=True)
def _zero_counts():
    ops.reset_launch_counts()
    yield
    # a CPU tensor never launches a CUDA kernel
    assert all(n == 0 for n in ops.launch_counts().values())


# ---------------------------------------------------------------------------
# kernels: plain versions against the Pallas kernels and the oracles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M,K,N", _SHAPES_MKN)
def test_dequant_matches_pallas_and_ref(M, K, N):
    a = _rng(1, K, N).standard_normal((K, N)).astype(np.float32) * 3.0
    q8, s8, _ = quant.quantize_int8(a)
    want = np.asarray(KQ.dequant_int8(jnp.asarray(q8), jnp.asarray(s8),
                                      interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(R.dequant_int8_ref(jnp.asarray(q8), jnp.asarray(s8))))
    for fn in (ops.dequant_int8, Q.dequant_int8_plain):
        got = fn(torch.from_numpy(q8), torch.from_numpy(s8))
        assert got.dtype == torch.float32 and tuple(got.shape) == (K, N)
        np.testing.assert_array_equal(got.numpy(), want)

    p4, s4 = quant.quantize_int4(a)
    want = np.asarray(KQ.dequant_int4(jnp.asarray(p4), jnp.asarray(s4), K,
                                      interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(R.dequant_int4_ref(jnp.asarray(p4),
                                            jnp.asarray(s4), K)))
    for fn in (ops.dequant_int4, Q.dequant_int4_plain):
        got = fn(torch.from_numpy(p4), torch.from_numpy(s4), K)
        assert got.dtype == torch.float32 and tuple(got.shape) == (K, N)
        np.testing.assert_array_equal(got.numpy(), want)
    # the nibble order and sign extension of repro.quant.unpack_int4
    np.testing.assert_array_equal(
        Q.unpack_int4_plain(torch.from_numpy(p4), K).numpy(),
        ref_quant.unpack_int4(p4, K))


@pytest.mark.parametrize("M,K,N", _SHAPES_MKN)
def test_matmul_dequant_matches_pallas_and_ref(M, K, N):
    rng = _rng(2, M, K, N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    a = rng.standard_normal((K, N)).astype(np.float32)
    q8, s8, _ = quant.quantize_int8(a)
    p4, s4 = quant.quantize_int4(a)
    cases = [
        (lambda: KQ.matmul_dequant_int8(jnp.asarray(x), jnp.asarray(q8),
                                        jnp.asarray(s8), interpret=True),
         lambda: R.matmul_dequant_int8_ref(jnp.asarray(x), jnp.asarray(q8),
                                           jnp.asarray(s8)),
         lambda fn: fn(torch.from_numpy(x), torch.from_numpy(q8),
                       torch.from_numpy(s8)),
         (ops.matmul_dequant_int8, Q.matmul_dequant_int8_plain)),
        (lambda: KQ.matmul_dequant_int4(jnp.asarray(x), jnp.asarray(p4),
                                        jnp.asarray(s4), K, interpret=True),
         lambda: R.matmul_dequant_int4_ref(jnp.asarray(x), jnp.asarray(p4),
                                           jnp.asarray(s4), K),
         lambda fn: fn(torch.from_numpy(x), torch.from_numpy(p4),
                       torch.from_numpy(s4), K),
         (ops.matmul_dequant_int4, Q.matmul_dequant_int4_plain)),
    ]
    atol_ref = 1e-6 * K * np.abs(x).max() * np.abs(a).max()
    for pallas, oracle, call, fns in cases:
        want, ref = np.asarray(pallas()), np.asarray(oracle())
        for fn in fns:
            got = call(fn)
            assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                       atol=atol_ref)


def test_matmul_dequant_bf16_input_keeps_its_dtype():
    rng = _rng(3)
    x = torch.from_numpy(rng.standard_normal((5, 33)).astype(np.float32))
    q8, s8, _ = quant.quantize_int8(
        rng.standard_normal((33, 20)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    got = ops.matmul_dequant_int8(xb, torch.from_numpy(q8),
                                  torch.from_numpy(s8))
    assert got.dtype == torch.bfloat16
    want = ((xb.float() @ torch.from_numpy(q8).float())
            * torch.from_numpy(s8)).to(torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("M,K,N", [(1, 256, 100), (3, 129, 7),
                                   (64, 129, 100)])
def test_matmul_dequant_int4_bf16_x_matches_pallas(M, K, N):
    """A bf16 x against the Pallas kernel (``interpret=True``) on the same
    packed bytes: bf16 out, the scale applied once to the f32 sum before
    the one rounding; within one bf16 step of the Pallas output (both sum
    exact products in f32, in other orders)."""
    rng = _rng(5, M, K, N)
    x = jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
    p4, s4 = quant.quantize_int4(
        rng.standard_normal((K, N)).astype(np.float32))
    want = KQ.matmul_dequant_int4(x, jnp.asarray(p4), jnp.asarray(s4), K,
                                  interpret=True)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want, np.float32)
    tx = _t(x)
    for fn in (ops.matmul_dequant_int4, Q.matmul_dequant_int4_plain):
        got = fn(tx, torch.from_numpy(p4), torch.from_numpy(s4), K)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (M, N)
        np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                                   rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("M,K,N", [(1, 256, 100), (3, 129, 7),
                                   (64, 960, 130)])
def test_matmul_dequant_int8_bf16_x_matches_pallas(M, K, N):
    """A bf16 x against the Pallas ``matmul_dequant_int8`` (``interpret=
    True``) on the same int8 bytes: bf16 out, the scale applied once to
    the f32 sum before the one rounding; within one bf16 step of the
    Pallas output (both sum exact products in f32, in other orders)."""
    rng = _rng(6, M, K, N)
    x = jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
    q8, s8, _ = quant.quantize_int8(
        rng.standard_normal((K, N)).astype(np.float32))
    want = KQ.matmul_dequant_int8(x, jnp.asarray(q8), jnp.asarray(s8),
                                  interpret=True)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want, np.float32)
    tx = _t(x)
    for fn in (ops.matmul_dequant_int8, Q.matmul_dequant_int8_plain):
        got = fn(tx, torch.from_numpy(q8), torch.from_numpy(s8))
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (M, N)
        np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                                   rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("M,K,N", [(1, 256, 100), (64, 960, 130),
                                   (3, 129, 7)])
def test_matmul_bf16_f32_out_matches_jnp_dot(M, K, N):
    rng = _rng(4, M, K, N)
    x = jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((K, N)), jnp.bfloat16)
    want = np.asarray(jnp.dot(x, w, preferred_element_type=jnp.float32))
    tx, tw = _t(x), _t(w)
    for got in (ops.matmul(tx, tw, out_dtype=torch.float32),
                matmul_plain(tx, tw, torch.float32)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    with pytest.raises(TypeError):
        ops.matmul(tx.float(), tw.float(), out_dtype=torch.bfloat16)


def test_wrappers_reject_bad_inputs():
    q = torch.zeros(8, 4, dtype=torch.int8)
    s = torch.ones(1, 4)
    with pytest.raises(ValueError):
        ops.dequant_int8(q, torch.ones(1, 5))
    with pytest.raises(ValueError):
        ops.dequant_int4(torch.zeros(3, 4, dtype=torch.uint8), s, K=8)
    with pytest.raises(ValueError):
        ops.matmul_dequant_int8(torch.zeros(2, 7), q, s)
    with pytest.raises(ValueError):
        ops.matmul_dequant_int4(torch.zeros(2, 8),
                                torch.zeros(4, 4, dtype=torch.uint8), s, K=7)
    # split across devices (meta, the dry run's, beside the CPU): no plain
    # fallback, no launch
    with pytest.raises(ValueError):
        ops.dequant_int8(q.to("meta"), s)


# ---------------------------------------------------------------------------
# the lossy registry kernels
# ---------------------------------------------------------------------------
def _same_arrays(rt, pt):
    assert sorted(rt) == sorted(pt)
    for k in rt:
        assert bf16.dtype_name(pt[k]) == str(np.asarray(rt[k]).dtype), k
        assert np.asarray(pt[k]).shape == np.asarray(rt[k]).shape, k
        assert np.asarray(rt[k]).tobytes() == np.asarray(pt[k]).tobytes(), k


@pytest.mark.parametrize("kernel", ["LinearLowPrecision", "LinearInt8",
                                    "LinearInt4"])
@pytest.mark.parametrize("lead,K,N", [((4,), 70, 33), ((2, 3), 129, 50),
                                      ((1,), 256, 100)])
def test_lossy_linear_kernels_match_reference(kernel, lead, K, N):
    rng = _rng(5, K, N, len(lead))
    args = ("l", "linear", {"in_features": K, "out_features": N},
            {"w": (K, N), "b": (N,)})
    raw = {"w": rng.standard_normal((K, N)).astype(np.float32),
           "b": rng.standard_normal(N).astype(np.float32)}
    x = rng.standard_normal((*lead, K)).astype(np.float32)
    rk, pk = getattr(RR, kernel)(), getattr(PR, kernel)()
    rspec, pspec = RR.LayerSpec(*args), PR.LayerSpec(*args)
    assert rk.name == pk.name
    rt, pt = rk.transform(raw, rspec), pk.transform(raw, pspec)
    _same_arrays(rt, pt)
    want = np.asarray(rk.execute({k: jnp.asarray(v) for k, v in rt.items()},
                                 jnp.asarray(x), rspec))
    got = pk.execute({k: _t(v) for k, v in pt.items()}, torch.from_numpy(x),
                     pspec)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def tiny():
    """``tiny_llm_graph(8)``'s configuration with the reference's params,
    built in both packages (port params by ``from_reference``)."""
    from repro.configs import get_config as ref_get_config
    from repro_torch.configs import get_config

    red = dict(num_layers=8, d_model=128, d_ff=256, num_heads=2,
               num_kv_heads=1, head_dim=64, vocab_size=512)
    rcfg = ref_get_config("smollm-360m").reduced(**red)
    cfg = get_config("smollm-360m").reduced(**red)
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    rg, rx = ref_build_llm_graph(rcfg, rp)
    pg, px = LG.build_llm_graph(cfg,
                                T.from_reference(jax.tree.map(np.asarray, rp)))
    assert np.array_equal(rx, px)
    return rg, pg, px


@pytest.mark.parametrize("kernel,index", [("TBlockInt8", 1), ("TBlockInt4", 1),
                                          ("HeadInt8", -1), ("HeadInt4", -1)])
def test_llm_lossy_kernels_match_reference(tiny, kernel, index):
    rg, pg, toks = tiny
    rl, pl = rg[index], pg[index]
    rk, pk = getattr(RLG, kernel)(), getattr(LG, kernel)()
    assert (rk.name, rk.op_type) == (pk.name, pk.op_type)
    rt = rk.transform(rl.weights, rl.spec)
    pt = pk.transform(pl.weights, pl.spec)
    _same_arrays(rt, pt)
    # _dequant: the same f32 weights, exactly
    rd = RLG._dequant({k: jnp.asarray(v) for k, v in rt.items()}, rl.spec)
    pd = LG._dequant({k: _t(v) for k, v in pt.items()}, pl.spec)
    assert sorted(rd) == sorted(pd)
    for k in rd:
        np.testing.assert_array_equal(pd[k].float().numpy(),
                                      np.asarray(rd[k], np.float32))
    x = _rng(6, index % 7).standard_normal((1, 16, 128)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(rk.execute({k: jnp.asarray(v) for k, v in rt.items()},
                                 xb, rl.spec), np.float32)
    got = pk.execute({k: _t(v) for k, v in pt.items()}, _t(xb), pl.spec)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.05,
                               rtol=0.05)


# ---------------------------------------------------------------------------
# plans under SyntheticProfiler with allow_lossy=True
# ---------------------------------------------------------------------------
def _assert_same_plan(ref, port, rs, ps):
    assert port.plan.to_dict() == ref.plan.to_dict()
    assert ps["choices"] == {k: tuple(v) for k, v in rs["choices"].items()}
    for key in ("shape_classes", "profile_calls", "planned_cold_read_bytes",
                "est_makespan_s"):
        assert ps[key] == rs[key], key


@pytest.mark.parametrize("allow", [None, ["int8", "bf16_cast"],
                                   ["int4", "bf16_cast"]])
def test_tiny_llm_lossy_plan_matches_reference(tmp_path, allow):
    rg, rx = ref_tiny_llm_graph(8)
    pg, px = LG.tiny_llm_graph(8)
    ref = RefEngine(rg, tmp_path / "ref", store_fmt="super", allow_lossy=True,
                    kernel_allowlist=allow)
    ref.profiler_factory = RefSynthetic
    port = ColdEngine(pg, tmp_path / "port", store_fmt="super",
                      allow_lossy=True, kernel_allowlist=allow, device="cpu")
    port.profiler_factory = SyntheticProfiler
    rs = ref.decide(rx, n_little=2, calibrate_interference=False)
    ps = port.decide(px, n_little=2, calibrate_interference=False)
    _assert_same_plan(ref, port, rs, ps)
    for l in pg:
        assert ([k.name for k in port._kernels_for(l.spec)]
                == [k.name for k in ref._kernels_for(
                    next(r for r in rg if r.spec.name == l.spec.name).spec)])
    assert port._transform_avatars == ref._transform_avatars
    if allow is not None:  # the reference's smoke gate: quantized majority
        picks = [c for l, c in zip(pg, port.plan.choices)
                 if l.spec.op_type in ("tblock", "lmhead")]
        assert sum(c.kernel == allow[0] and c.use_cache for c in picks) \
            > len(picks) // 2


@pytest.mark.parametrize("name", CNN_NAMES)
def test_cnn_lossy_plan_matches_reference(tmp_path, name):
    build = dict(image=17, width=0.25)
    rl, rx = ref_build_cnn(name, **build)
    pl, px = build_cnn(name, **build)
    ref = RefEngine(rl, tmp_path / "ref", allow_lossy=True)
    ref.profiler_factory = RefSynthetic
    port = ColdEngine(pl, tmp_path / "port", allow_lossy=True, device="cpu")
    port.profiler_factory = SyntheticProfiler
    rs = ref.decide(rx, n_little=2, calibrate_interference=False)
    ps = port.decide(px, n_little=2, calibrate_interference=False)
    _assert_same_plan(ref, port, rs, ps)


# ---------------------------------------------------------------------------
# run_cold under pinned quantized plans
# ---------------------------------------------------------------------------
def _pin(eng, choice_cls, pick):
    """Pinned choices (``pick(layer) -> (kernel, cached)``), with the cache
    entries of the cached ones written first."""
    out = []
    for l in eng.layers:
        kernel, cached = pick(l)
        if cached and not eng.store.has_cached(l.spec.name, kernel):
            kern = next(k for k in eng._kernels_for(l.spec)
                        if k.name == kernel)
            eng.store.write_cached(
                l.spec.name, kernel,
                kern.transform(eng.store.read_raw(l.spec.name), l.spec))
        out.append(choice_cls(kernel, cached))
    return out


def _set(eng, choices):
    if isinstance(eng, ColdEngine):
        eng.set_plan(replace(eng.plan, choices=choices))
    else:
        eng.plan = replace(eng.plan, choices=choices)
        eng._runtimes.clear()


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_llm_run_cold_pinned_quantized_matches_reference(tmp_path, tiny,
                                                         scheme):
    rg, pg, x = tiny
    engines = []
    for cls, graph, choice, kw, prof in (
            (RefEngine, rg, RefChoice, {}, RefSynthetic),
            (ColdEngine, pg, Choice, {"device": "cpu"}, SyntheticProfiler)):
        eng = cls(graph, tmp_path / cls.__module__, store_fmt="super",
                  allow_lossy=True, **kw)
        eng.profiler_factory = prof
        eng.decide(x, n_little=2, calibrate_interference=False)
        _set(eng, _pin(eng, choice, lambda l: (
            "bf16_cast" if l.spec.op_type == "embed" else scheme, True)))
        engines.append(eng)
    ref, port = engines
    want = np.asarray(ref.run_cold(x).output)
    got = port.run_cold(x).output
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=0.1, rtol=0.05)
    assert not port.repairs.counts()


@pytest.mark.parametrize("head,tol", [("int8", 1e-4), ("int4", 1e-4),
                                      ("bf16", 2e-3)])
def test_cnn_run_cold_lossy_head_matches_reference(tmp_path, head, tol):
    build = dict(image=17, width=0.25)
    rl, rx = ref_build_cnn("resnet18", **build)
    pl, px = build_cnn("resnet18", **build)
    engines = []
    for cls, graph, choice, kw, prof in (
            (RefEngine, rl, RefChoice, {}, RefSynthetic),
            (ColdEngine, pl, Choice, {"device": "cpu"}, SyntheticProfiler)):
        eng = cls(graph, tmp_path / cls.__module__, store_fmt="super",
                  allow_lossy=True, **kw)
        eng.profiler_factory = prof
        eng.decide(rx, n_little=2, calibrate_interference=False)
        decided = {l.spec.name: c for l, c in zip(eng.layers,
                                                  eng.plan.choices)}
        _set(eng, _pin(eng, choice, lambda l: (
            (head, True) if l.spec.op_type == "linear"
            else (decided[l.spec.name].kernel,
                  decided[l.spec.name].use_cache))))
        engines.append(eng)
    ref, port = engines
    assert port.plan.to_dict() == ref.plan.to_dict()
    want = np.asarray(ref.run_cold(rx).output)
    got = port.run_cold(px).output
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)
    assert not port.repairs.counts()


# ---------------------------------------------------------------------------
# v4 stores with quantized cache entries, across packages
# ---------------------------------------------------------------------------
def test_quantized_cache_reads_across_and_bytes_match_reference(tmp_path):
    """Three arms over tiny_llm_graph(8) in each package (bf16_cast only;
    int8 + bf16_cast; int4 + bf16_cast, as the reference's quantized
    benchmark runs them): the same plan, the same cold bytes served, and
    the reference's byte floors (int8 >= 1.8x, int4 >= 3x below bf16).
    Each package's int8/int4 entries open in the other with equal bytes
    and CRCs."""
    from repro.checkpoint import LayerStore as RefStore
    from repro_torch.checkpoint import LayerStore

    rg, rx = ref_tiny_llm_graph(8)
    pg, px = LG.tiny_llm_graph(8)
    served = {}
    for arm, allow in (("bf16", ["bf16_cast"]), ("int8", ["int8", "bf16_cast"]),
                       ("int4", ["int4", "bf16_cast"])):
        for pkg, cls, graph, x, kw, prof in (
                ("ref", RefEngine, rg, rx, {}, RefSynthetic),
                ("port", ColdEngine, pg, px, {"device": "cpu"},
                 SyntheticProfiler)):
            eng = cls(graph, tmp_path / pkg / arm, store_fmt="super",
                      allow_lossy=True, kernel_allowlist=allow, **kw)
            eng.profiler_factory = prof
            eng.decide(x, n_little=2, calibrate_interference=False)
            s0 = eng.store.bytes_served()
            eng.run_cold(x, n_little=2)
            served[pkg, arm] = eng.store.bytes_served() - s0
    for pkg in ("ref", "port"):
        assert served[pkg, "bf16"] / served[pkg, "int8"] >= 1.8
        assert served[pkg, "bf16"] / served[pkg, "int4"] >= 3.0
    assert {a: served["port", a] for a in ("bf16", "int8", "int4")} == \
        {a: served["ref", a] for a in ("bf16", "int8", "int4")}

    for arm in ("int8", "int4"):
        mine = LayerStore(tmp_path / "ref" / arm, fmt="super")
        theirs = RefStore(tmp_path / "port" / arm, fmt="super")
        back = RefStore(tmp_path / "ref" / arm, fmt="super")
        own = LayerStore(tmp_path / "port" / arm, fmt="super")
        names = [l.spec.name for l in pg if l.spec.op_type != "embed"
                 and own.has_cached(l.spec.name, arm)]
        assert names
        for name in names:
            # the reference's entry read by the port, and the reverse
            for a, b in ((mine.read_cached(name, arm),
                          back.read_cached(name, arm)),
                         (own.read_cached(name, arm),
                          theirs.read_cached(name, arm))):
                assert sorted(a) == sorted(b)
                for k in a:
                    assert bf16.dtype_name(a[k]) == str(np.asarray(b[k]).dtype)
                    assert np.asarray(a[k]).tobytes() == \
                        np.asarray(b[k]).tobytes()
            assert mine.audit_cached(name, arm)
            assert theirs.audit_cached(name, arm)
            assert own.cached_bytes(name, arm) == \
                back.cached_bytes(name, arm)
