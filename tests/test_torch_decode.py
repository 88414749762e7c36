"""The port's decode path (kernels.attention.decode_attention,
models.layers.attn_decode_step, models.transformer.init_decode_state /
decode_step) against the JAX package's, on the CPU at small size. The
reference makes the inputs and params (numpy seeds, ``jax.random``);
``transformer.from_reference`` carries params over.

Tolerances:
* ``decode_attention_plain`` against the Pallas ``decode_attention``
  (``interpret=True``): 1e-4, the reference sweep's own
  (``test_kernels.py``); a wrapped ring against the linear history it
  holds: 1e-6 (the same f32 sums over the same entries, in slot order);
* ``attn_decode_step`` in f32 against the reference's: 1e-5 (the same f32
  arithmetic, another summation order); in bf16: 0.05, the reference's
  own ring-cache bound (``test_decode_consistency.py``); the int8 cache
  entries written: equal;
* ``decode_step`` logits against the reference's, step by step: 1e-4 on
  f32 configs; 0.08 on bf16 ones, the reference's own bound for decode
  against forward (``test_decode_consistency.py``). With the int8 KV cache
  on an f32 config: 1e-2, because a projection that lies within its last
  bit of a rounding boundary quantizes one int8 step apart in the two
  packages (at most 1 step, in under 1 % of the entries, is held), and one
  such step moves the attention output by up to that entry's scale;
* the port's decode against its own forward: 0.08 (0.05 on the window
  ring), as the reference holds its own.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.kernels.attention import \
    decode_attention as pallas_decode  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.runtime_flags import FLAGS as REF_FLAGS  # noqa: E402
from repro.serving.server import BatchedServer as RefServer  # noqa: E402
from repro_torch import bf16  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.attention import decode_attention_plain  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.runtime_flags import FLAGS  # noqa: E402
from repro_torch.serving import BatchedServer  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def int8_kv():
    """``kv_cache_int8`` on in both packages, restored afterwards."""
    saved = dict(REF_FLAGS), dict(FLAGS)
    REF_FLAGS["kv_cache_int8"] = FLAGS["kv_cache_int8"] = True
    yield
    for flags, old in zip((REF_FLAGS, FLAGS), saved):
        flags.clear()
        flags.update(old)


def _rng(*key):
    return np.random.default_rng(list(key))


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return bf16.to_tensor(np.array(a))


# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas kernel (prefix form)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,H,KV,D", [(512, 8, 4, 64), (300, 4, 4, 32),
                                      (256, 8, 2, 128),
                                      # zamba2's head dim, and head dims
                                      # that are not a multiple of 8
                                      (200, 8, 8, 80), (150, 6, 3, 100),
                                      (130, 4, 2, 67)])
def test_decode_attention_plain_matches_pallas(S, H, KV, D):
    B = 3
    rng = _rng(S, H, KV, D)
    q = (rng.standard_normal((B, H, D)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((B, S, KV, D)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((B, S, KV, D)) * 0.3).astype(np.float32)
    length = rng.integers(1, S + 1, size=(B,)).astype(np.int32)
    want = pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(length), bs=128, interpret=True)
    # the prefix rule is the ring rule at pos = length - 1, W = S
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v),
                               torch.from_numpy(length - 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    assert ops.launch_counts()["decode_attention"] == 0


@pytest.mark.parametrize("window", [None, 8])
def test_ring_cache_equals_linear_history(window):
    """A ring of W slots written at pos % W for positions 0..pos attends
    like a linear cache of the last min(W, window) positions."""
    B, W, H, KV, D, pos = 2, 16, 4, 2, 32, 37
    rng = _rng(W, pos, window or 0)
    hist_k = torch.from_numpy(
        rng.standard_normal((B, pos + 1, KV, D)).astype(np.float32))
    hist_v = torch.from_numpy(
        rng.standard_normal((B, pos + 1, KV, D)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32))
    ring_k, ring_v = torch.zeros(B, W, KV, D), torch.zeros(B, W, KV, D)
    for e in range(pos + 1):
        ring_k[:, e % W], ring_v[:, e % W] = hist_k[:, e], hist_v[:, e]
    n = min(W, window or W)
    lin_k = hist_k[:, pos + 1 - n:].contiguous()
    lin_v = hist_v[:, pos + 1 - n:].contiguous()
    got = decode_attention_plain(q, ring_k, ring_v,
                                 torch.full((B,), pos, dtype=torch.int32),
                                 window=window)
    want = decode_attention_plain(q, lin_k, lin_v,
                                  torch.full((B,), n - 1, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-6)


# (B, W, H, KV, D): every decode_attention row of chip_smoke.py
DECODE_PLANNER_ROWS = [
    (3, 512, 8, 4, 64), (3, 300, 4, 4, 32), (3, 256, 8, 2, 128),
    (1, 82, 15, 5, 64), (1, 512, 15, 5, 64), (1, 4096, 15, 5, 64),
    (4, 82, 15, 5, 64), (4, 512, 15, 5, 64), (4, 4096, 15, 5, 64),
    (2, 32, 15, 5, 64), (2, 1024, 32, 16, 128), (1, 512, 24, 8, 64),
    (4, 4096, 24, 8, 64), (1, 4096, 32, 32, 80), (4, 512, 32, 32, 80),
    (2, 512, 32, 32, 80), (2, 600, 8, 2, 100), (2, 600, 6, 3, 67),
    (1, 1024, 8, 1, 256)]


@pytest.mark.parametrize("shape", DECODE_PLANNER_ROWS,
                         ids=["x".join(map(str, s)) for s in
                              DECODE_PLANNER_ROWS])
def test_plan_decode(shape):
    import inspect

    from repro_torch.kernels.attention import plan_decode
    from repro_torch.kernels.matmul import SMS

    B, W, H, KV, D = shape
    p = plan_decode(B, W, H, KV, D)
    # shapes only: no pos, so a decode step can be captured in a graph
    assert list(inspect.signature(plan_decode).parameters) == [
        "B", "W", "H", "KV", "D"]
    g = H // KV
    assert 1 <= p.hg <= 4 and p.hg * p.hgroups >= g
    assert p.hg * (p.hgroups - 1) < g      # no empty head group
    assert p.lpr in (4, 8, 16, 32) and 8 * p.lpr >= D
    assert p.lpr == 4 or 4 * p.lpr < D     # the fewest lanes that hold D
    assert p.tile == 4 * (32 // p.lpr) * 4 and p.tiles == -(-W // p.tile)
    # whole tiles a split; the splits cover W, none empty
    assert p.chunk % p.tile == 0 and p.chunk <= max(p.tile, 256)
    assert (p.split - 1) * p.chunk < W <= p.split * p.chunk
    assert p.blocks == B * KV * p.hgroups * p.split
    # the blocks fill the card, or W gives each split one tile
    assert p.blocks >= SMS or p.split == p.tiles


def test_plan_decode_refuses_head_dims_above_256():
    from repro_torch.kernels.attention import plan_decode

    assert plan_decode(1, 8, 2, 1, 256).lpr == 32
    with pytest.raises(ValueError, match="256"):
        plan_decode(1, 8, 2, 1, 257)


def test_decode_attention_wrapper_checks():
    q, k = torch.zeros(2, 4, 64), torch.zeros(2, 8, 2, 64)
    pos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.decode_attention(q, k, torch.zeros(2, 8, 3, 64), pos)
    with pytest.raises(ValueError):
        ops.decode_attention(q, k, k, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.decode_attention(q, k.to(torch.int8), k.to(torch.int8), pos,
                             k_scale=torch.ones(2, 8, 2))
    # split across devices (meta, the dry run's, beside the CPU): no plain
    # fallback, no launch
    with pytest.raises(ValueError):
        ops.decode_attention(q.to("meta"), k, k, pos)


# ---------------------------------------------------------------------------
# attn_decode_step: ring, window, softcap and int8 arms
# ---------------------------------------------------------------------------
ARMS = {  # name: (W, pos, window, softcap, int8)
    "prefix": (16, 9, None, None, False),
    "ring_window": (16, 37, 8, None, False),
    "softcap": (16, 12, None, 30.0, False),
    "int8_ring": (16, 21, 12, None, True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_attn_decode_step_matches_reference(arm, dtype):
    _attn_decode_step_case(arm, dtype, 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_attn_decode_step_d80_matches_reference(arm, dtype):
    """zamba2-2.7b's head dim 80 (the CUDA kernel takes any D up to 256)."""
    _attn_decode_step_case(arm, dtype, 80)


def _attn_decode_step_case(arm, dtype, hd):
    W, pos, window, softcap, quant = ARMS[arm]
    kw = dict(num_heads=4, num_kv_heads=2, d_model=128, dtype=dtype,
              attn_softcap=softcap, head_dim=hd)
    rcfg = ref_get_config("smollm-360m").reduced(**kw)
    cfg = get_config("smollm-360m").reduced(**kw)
    B, d, H, KV = 2, 128, 4, 2
    rng = _rng(len(arm), W, pos)
    p = {"wq": rng.standard_normal((d, H * hd)) / np.sqrt(d),
         "wk": rng.standard_normal((d, KV * hd)) / np.sqrt(d),
         "wv": rng.standard_normal((d, KV * hd)) / np.sqrt(d),
         "wo": rng.standard_normal((H * hd, d)) / np.sqrt(H * hd)}
    x = rng.standard_normal((B, 1, d))
    rp = {k: jnp.asarray(v, dtype) for k, v in p.items()}
    rx = jnp.asarray(x, dtype)
    if quant:
        ck = rng.integers(-127, 128, size=(B, W, KV, hd)).astype(np.int8)
        cv = rng.integers(-127, 128, size=(B, W, KV, hd)).astype(np.int8)
        ks = (rng.random((B, W, KV)) * 0.02 + 1e-3).astype(np.float32)
        vs = (rng.random((B, W, KV)) * 0.02 + 1e-3).astype(np.float32)
        rout, rc = RL.attn_decode_step(
            rp, rx, jnp.asarray(ck), jnp.asarray(cv), jnp.int32(pos), rcfg,
            window=window, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        out, pc = L.attn_decode_step(
            {k: _t(v) for k, v in rp.items()}, _t(rx), torch.from_numpy(ck),
            torch.from_numpy(cv), pos, cfg, window=window,
            k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
        for a, b in zip(pc[:2], rc[:2]):   # the int8 entries: equal
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(pc[2:], rc[2:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    else:
        ck = rng.standard_normal((B, W, KV, hd)) * 0.5
        cv = rng.standard_normal((B, W, KV, hd)) * 0.5
        rck, rcv = jnp.asarray(ck, dtype), jnp.asarray(cv, dtype)
        rout, rc = RL.attn_decode_step(rp, rx, rck, rcv, jnp.int32(pos), rcfg,
                                       window=window)
        out, pc = L.attn_decode_step(
            {k: _t(v) for k, v in rp.items()}, _t(rx), _t(rck), _t(rcv), pos,
            cfg, window=window)
        tol = 1e-5 if dtype == "float32" else 0.05
        for a, b in zip(pc, rc):
            np.testing.assert_allclose(_np(a.float()), _np(b), atol=tol,
                                       rtol=tol)
    tol = 1e-5 if dtype == "float32" else 0.05
    np.testing.assert_allclose(_np(out.float()), _np(rout), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# decode_step against the reference's, step by step
# ---------------------------------------------------------------------------
CASES = {  # name: (arch, overrides, sliding window, positions, int8 cache)
    "smollm": ("smollm-360m", {}, None, 12, False),
    "gemma2": ("gemma2-27b", {}, None, 12, False),
    # the local layers' ring (8 entries) wraps within the 12 positions
    "gemma2_local_global": ("gemma2-27b", {"sliding_window": 8}, None, 12,
                            False),
    "window8_ring": ("smollm-360m", {}, 8, 24, False),
    "int8_kv": ("qwen3-32b", {}, None, 12, True),
}


def _case_cfgs(name, dtype):
    arch, over, win, _, _ = CASES[name]
    rcfg = ref_get_config(arch).reduced(dtype=dtype, **over)
    cfg = get_config(arch).reduced(dtype=dtype, **over)
    if win:
        rcfg, cfg = rcfg.with_sliding_window(win), cfg.with_sliding_window(win)
    return rcfg, cfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_step_matches_reference(case, dtype, request):
    if CASES[case][4]:
        request.getfixturevalue("int8_kv")
    rcfg, cfg = _case_cfgs(case, dtype)
    S = CASES[case][3]
    rp = RT.init_params(jax.random.PRNGKey(1), rcfg)
    pp = T.from_reference(jax.tree.map(np.asarray, rp))
    B = 2
    toks = _rng(S, B).integers(0, cfg.vocab_size, size=(B, S)).astype(
        np.int32)
    rstate = RT.init_decode_state(rcfg, B, S)
    state = T.init_decode_state(cfg, B, S, device="cpu")
    rstep = jax.jit(lambda p, s, b, pos: RT.decode_step(p, s, b, pos, rcfg))
    quant = CASES[case][4]
    tol = (0.08 if dtype == "bfloat16" else 1e-2 if quant else 1e-4)
    for t in range(S):
        rl, rstate = rstep(rp, rstate, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                           jnp.int32(t))
        lg, state = T.decode_step(
            pp, state, {"tokens": torch.from_numpy(toks[:, t:t + 1])}, t, cfg)
        assert lg.shape == (B, 1, cfg.vocab_size) and lg.dtype == torch.float32
        np.testing.assert_allclose(lg.numpy(), np.asarray(rl), atol=tol,
                                   rtol=tol)
    if quant:
        assert state["k"].dtype == torch.int8
        assert state["k_scale"].dtype == torch.float32
    if quant and dtype == "float32":
        for key in ("k", "v"):
            d = np.abs(state[key].numpy().astype(np.int32)
                       - np.asarray(rstate[key]).astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() < 0.01


@pytest.mark.parametrize("case,bound", [("smollm", 0.08),
                                        ("gemma2_local_global", 0.08),
                                        ("window8_ring", 0.05)])
def test_decode_matches_own_forward(case, bound):
    _, cfg = _case_cfgs(case, "bfloat16")
    S = CASES[case][3]
    params = T.init_params(cfg, torch.Generator().manual_seed(2))
    B = 2
    toks = torch.from_numpy(_rng(S, 7).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int64))
    logits, _, _ = T.forward(params, {"tokens": toks}, cfg)
    state = T.init_decode_state(cfg, B, S, device="cpu")
    if CASES[case][2]:
        assert state["k"].shape[2] == CASES[case][2]   # ring == window
    outs = []
    for t in range(S):
        lg, state = T.decode_step(params, state,
                                  {"tokens": toks[:, t:t + 1]}, t, cfg)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    assert float((dec - logits).abs().max()) < bound


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_decode_state_matches_reference(case, request):
    if CASES[case][4]:
        request.getfixturevalue("int8_kv")
    rcfg, cfg = _case_cfgs(case, "bfloat16")
    rs = RT.init_decode_state(rcfg, 3, 40)
    ps = T.init_decode_state(cfg, 3, 40, device="cpu")
    assert sorted(rs) == sorted(ps)
    for k in rs:
        assert tuple(ps[k].shape) == rs[k].shape
        assert bf16.dtype_name(ps[k].dtype) == str(rs[k].dtype)
        assert not ps[k].any()
    # the serving KV reservation counts the same bytes in both packages
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    pp = T.from_reference(jax.tree.map(np.asarray, rp))
    assert (BatchedServer(pp, cfg, max_batch=3, max_len=40,
                          device="cpu").kv_bytes
            == RefServer(rp, rcfg, max_batch=3, max_len=40).kv_bytes)


@pytest.mark.parametrize("field", ["family", "input_mode"])
def test_decode_rejects_other_families(field):
    """Every family and input mode of the configs is ported; an unknown
    one raises ``ValueError`` from ``forward`` and ``init_decode_state``,
    the reference's refusal (its ``init_decode_state`` reads the family
    only; the port checks both up front)."""
    rcfg = dataclasses.replace(ref_get_config("smollm-360m").reduced(),
                               **{field: "unknown"})
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              **{field: "unknown"})
    toks = np.zeros((1, 4), np.int32)
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    with pytest.raises(ValueError, match="unknown"):
        RT.forward(rp, {"tokens": jnp.asarray(toks)}, rcfg)
    if field == "family":
        with pytest.raises(ValueError, match="unknown"):
            RT.init_decode_state(rcfg, 1, 8)
    with pytest.raises(ValueError, match="unknown"):
        T.forward(T.from_reference(jax.tree.map(np.asarray, rp)),
                  {"tokens": torch.from_numpy(toks)}, cfg)
    with pytest.raises(ValueError, match="unknown"):
        T.init_decode_state(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        T.init_params(cfg, torch.Generator().manual_seed(0))
