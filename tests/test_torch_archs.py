"""The four archs whose query width differs from d_model —
qwen3-moe-30b-a3b (E 128, top-8, ``qk_norm``), mistral-nemo-12b, gemma2-27b
(local/global pairs, softcaps, tied head) and qwen3-32b (``qk_norm``, 64/8
heads) — against the JAX package's, on the CPU at small size, and a
rehearsal of ``chip_smoke.py``'s ``archs_path`` at that size.

``ArchConfig.reduced()`` sets head_dim 64 with at most 4 heads on d_model
256, so heads x head_dim = d_model there; the configs below keep each
arch's ratio of query width to d_model (qwen3-moe 2x, mistral-nemo 0.8x,
gemma2 0.89x, qwen3-32b 1.6x), its GQA ratio where 4 heads allow it and
its features. The reference makes the params (``RT.init_params(
PRNGKey(1))``) and ``transformer.from_reference`` carries them over;
tokens come from numpy seeds.

Tolerances: f32 1e-4 atol and rtol; bf16 the LLM gate (atol 0.1, rtol
0.05, ``test_llm_graph.py``). A bf16 run rounds upstream of the f32
router elsewhere than the reference, which can flip a near-tie between
the k-th and (k+1)-th expert; so, as ``test_torch_moe.py`` holds granite,
a row of qwen3-moe's bf16 logits (or a token's cache rows) may leave the
gate only where the port's router had such a near-tie in some layer, and
at most a tenth of the rows may.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]

# arch: (reduced-config overrides, prompt length). gemma2's 40-token
# prompt runs past its 32-token window, so the local layers' mask binds
ARCHS = {
    "qwen3-moe-30b-a3b": (dict(d_model=128, num_heads=8, num_kv_heads=1,
                               head_dim=32, num_experts=16, top_k=8,
                               d_ff=64), 16),
    "mistral-nemo-12b": (dict(d_model=160, num_heads=4, num_kv_heads=1,
                              head_dim=32, d_ff=448), 16),
    "gemma2-27b": (dict(d_model=144, num_heads=4, num_kv_heads=2,
                        head_dim=32, num_layers=4), 40),
    "qwen3-32b": (dict(d_model=160, num_heads=8, num_kv_heads=1,
                       head_dim=32), 16),
}
DTYPES = ["float32", "bfloat16"]
B = 2
F32_TOL = 1e-4
LLM_ATOL, LLM_RTOL = 0.1, 0.05
TIE = 5e-3   # test_torch_moe.py's near-tie between router probabilities


def reduced(arch, dtype="float32", **extra):
    """(the reference's, the port's) reduced config of ``arch``."""
    over = dict(ARCHS[arch][0], dtype=dtype, **extra)
    return (ref_get_config(arch).reduced(**over),
            get_config(arch).reduced(**over))


def _params(rcfg):
    rp = RT.init_params(jax.random.PRNGKey(1), rcfg)
    return rp, T.from_reference(jax.tree.map(np.asarray, rp))


def _tokens(cfg, S, seed):
    return np.random.default_rng([S, seed]).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


@pytest.fixture
def router_gaps(monkeypatch):
    """Each ``route`` call's gap between the k-th and (k+1)-th expert
    probability, one (T,) tensor a call, in call order."""
    gaps = []
    route = M.route

    def recording(xf, router, cfg):
        probs, top_p, top_e = route(xf, router, cfg)
        s = torch.sort(probs, dim=-1, descending=True).values
        gaps.append(s[:, cfg.top_k - 1] - s[:, cfg.top_k])
        return probs, top_p, top_e

    monkeypatch.setattr(M, "route", recording)
    return gaps


def _assert_close(got, want, dtype, tie_gap=None):
    """(rows, ...) arrays: f32 within 1e-4; bf16 within the LLM gate on
    every row, or, given the rows' router gaps, on every row but those of
    a near-tie (at most a tenth)."""
    got = np.asarray(got, np.float32).reshape(len(got), -1)
    want = np.asarray(want, np.float32).reshape(got.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
        return
    out = ~(np.abs(got - want) <= LLM_ATOL + LLM_RTOL * np.abs(want)).all(1)
    if tie_gap is None:
        assert not out.any(), (f"rows {np.flatnonzero(out)} leave the LLM "
                               f"gate (max|d| {np.abs(got - want).max()})")
        return
    assert out.mean() <= 0.1, f"{out.sum()} of {len(out)} rows off the gate"
    assert (tie_gap[out] < TIE).all(), (
        f"rows {np.flatnonzero(out)} leave the gate without a near-tie in "
        f"their routing (gaps {tie_gap[out]})")


def _gaps(gaps, n_calls, cfg, rows):
    """The smallest gap of each of ``rows`` tokens over the route calls,
    or None for a dense arch."""
    if not cfg.is_moe:
        return None
    assert len(gaps) == n_calls
    return torch.stack(gaps).reshape(n_calls, rows).min(0).values.numpy()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reduced_configs_keep_the_arch(arch):
    """The reduced config keeps the full arch's query width against
    d_model (within the rounding of a 32-wide head), its features and, but
    for qwen3-moe, whose 32/4 heads become 8/1, its GQA ratio up to
    rounding; and, unlike ``reduced()``'s default, its heads x head_dim
    differ from d_model."""
    full = get_config(arch)
    _, cfg = reduced(arch)
    ratio = full.num_heads * full.head_dim / full.d_model
    got = cfg.num_heads * cfg.head_dim / cfg.d_model
    assert cfg.num_heads * cfg.head_dim != cfg.d_model
    assert abs(got - ratio) / ratio < 0.02, (got, ratio)
    assert cfg.num_heads % cfg.num_kv_heads == 0
    for f in ("family", "qk_norm", "attn_softcap", "final_softcap",
              "local_global_pattern", "tie_embeddings", "top_k"):
        assert getattr(cfg, f) == getattr(full, f), f
    assert cfg.is_moe == full.is_moe
    if cfg.is_moe:
        assert cfg.num_experts > cfg.top_k
    if full.sliding_window:
        assert cfg.sliding_window < ARCHS[arch][1]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_matches_reference(arch, dtype, router_gaps):
    rcfg, cfg = reduced(arch, dtype)
    rp, pp = _params(rcfg)
    S = ARCHS[arch][1]
    toks = _tokens(cfg, S, 1)
    rl, raux, _ = RT.forward(rp, {"tokens": jnp.asarray(toks)}, rcfg)
    with torch.no_grad():
        pl, paux, _ = T.forward(pp, {"tokens": torch.from_numpy(toks)}, cfg)
    assert pl.shape == (B, S, cfg.vocab_size) and pl.dtype == torch.float32
    gap = _gaps(router_gaps, cfg.num_layers, cfg, B * S)
    _assert_close(pl.numpy().reshape(B * S, -1),
                  np.asarray(rl, np.float32).reshape(B * S, -1), dtype, gap)
    if cfg.is_moe:
        np.testing.assert_allclose(float(paux), float(raux),
                                   rtol=1e-5 if dtype == "float32" else 1e-2)


# name: (arch, overrides beside the reduced config's); gemma2 with an
# 8-entry window, so that its local layers' ring wraps within the steps
DECODE_CASES = {a: (a, {}) for a in ARCHS}
DECODE_CASES["gemma2-27b-window8"] = ("gemma2-27b", {"sliding_window": 8})
STEPS = 12


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_steps_match_reference(case, dtype, router_gaps):
    arch, over = DECODE_CASES[case]
    rcfg, cfg = reduced(arch, dtype, **over)
    rp, pp = _params(rcfg)
    toks = _tokens(cfg, STEPS, 2)
    rstate = RT.init_decode_state(rcfg, B, STEPS)
    state = T.init_decode_state(cfg, B, STEPS, device="cpu")
    assert sorted(state) == sorted(rstate)
    for k in rstate:
        assert tuple(state[k].shape) == rstate[k].shape, k
    if cfg.local_global_pattern:
        assert state["k_local"].shape[2] == min(cfg.sliding_window, STEPS)
    rstep = jax.jit(lambda p, s, b, pos: RT.decode_step(p, s, b, pos, rcfg))
    got, want = [], []
    with torch.no_grad():
        for t in range(STEPS):
            rl, rstate = rstep(rp, rstate,
                               {"tokens": jnp.asarray(toks[:, t:t + 1])},
                               jnp.int32(t))
            lg, state = T.decode_step(
                pp, state, {"tokens": torch.from_numpy(toks[:, t:t + 1])}, t,
                cfg)
            assert lg.shape == (B, 1, cfg.vocab_size)
            got.append(lg.numpy()[:, 0])
            want.append(np.asarray(rl, np.float32)[:, 0])
    gap = None
    if cfg.is_moe:   # (steps x layers, B) -> each step's smallest
        assert len(router_gaps) == STEPS * cfg.num_layers
        gap = torch.stack(router_gaps).reshape(
            STEPS, cfg.num_layers, B).min(1).values.numpy().reshape(-1)
    _assert_close(np.stack(got).reshape(STEPS * B, -1),
                  np.stack(want).reshape(STEPS * B, -1), dtype, gap)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_cache_matches_reference(arch, dtype, router_gaps):
    """``forward(collect_cache=True)``'s tree, leaf for leaf (paths, shapes,
    dtypes), each leaf's (B, S) token rows within the gate of the
    reference's (qwen3-moe bf16: but near-ties, as the logits)."""
    rcfg, cfg = reduced(arch, dtype)
    rp, pp = _params(rcfg)
    S = ARCHS[arch][1]
    toks = _tokens(cfg, S, 3)
    _, _, (rcache, _) = RT.forward(rp, {"tokens": jnp.asarray(toks)}, rcfg,
                                   collect_cache=True)
    with torch.no_grad():
        _, _, (cache, _) = T.forward(pp, {"tokens": torch.from_numpy(toks)},
                                     cfg, collect_cache=True)
    want = jax.tree_util.tree_flatten_with_path(rcache)[0]
    got = jax.tree_util.tree_flatten_with_path(cache)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    assert sorted(cache) == (["global", "local"] if cfg.local_global_pattern
                             else ["kv"])
    gap = _gaps(router_gaps, cfg.num_layers, cfg, B * S)

    def rows(a):   # (L, B, S, KV, hd) -> (B * S, L * KV * hd)
        return np.moveaxis(np.asarray(a, np.float32), 0, 2).reshape(B * S,
                                                                     -1)

    for (path, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), path
        _assert_close(rows(g.float().numpy()), rows(w), dtype, gap)


# ---------------------------------------------------------------------------
# chip_smoke.py's archs_path, rehearsed on the CPU at the sizes above
# ---------------------------------------------------------------------------
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def counted_plain(monkeypatch):
    """The CPU wrappers of the path's kernels counting a launch where the
    card's would, so that the path's launch gates hold on the CPU."""
    from repro_torch.kernels import attention as KA
    from repro_torch.kernels import gmm as KG
    from repro_torch.kernels import matmul as KM
    from repro_torch.kernels import ops

    def counting(name, fn, counter, key):
        def wrapped(*a, **kw):
            k = key(*a) if callable(key) else key
            counter[k] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(ops, name, wrapped)

    counting("matmul", ops.matmul, KM.launches,
             lambda x, w: "matmul_bf16" if x.dtype == torch.bfloat16
             else "matmul")
    counting("flash_attention", ops.flash_attention, KA.launches,
             "flash_attention")
    counting("decode_attention", ops.decode_attention, KA.launches,
             "decode_attention")
    counting("gmm_blocks", ops.gmm_blocks, KG.launches, "gmm_blocks")


def test_archs_path_rehearsal(monkeypatch, counted_plain):
    """``archs_path`` on ``torch.device("cpu")`` with the four configs
    reduced as above: every gate runs (the kernels' runs against the
    all-plain ones, routing agreement, the prefill cache, the f32 arms,
    the batched mix against the plain run, the graph against the eager
    server, the launch gates) and passes; its returned launch counts are
    the gates' sums."""
    import repro_torch.configs as C

    cs = _chip_smoke()
    get = C.get_config

    def small(name):
        return get(name).reduced(**ARCHS[name][0]) if name in ARCHS \
            else get(name)

    monkeypatch.setattr(C, "get_config", small)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    # the card's table at the sizes above: gemma2 at its 4 layers (two
    # pairs), the others at 2; 8 decode steps; the f32 arms at 2 layers
    plan = [(a, 4 if a == "gemma2-27b" else 2, ARCHS[a][1], 8,
             2 if f32 else 0) for a, _, _, _, f32 in cs.ARCHS_RUN]
    monkeypatch.setattr(cs, "ARCHS_RUN", plan)
    counts = cs.archs_path(torch.device("cpu"))
    # each kernel's launches: forwards, decode steps (by steps, then the
    # kernels' run of the batched mix) and f32 forwards; the moe arch's
    # router counts as the f32 matmul, its attention's four projections
    # and head as the bf16 one
    mix = mix_steps(cs.BATCH_SHAPES, 4)
    want = dict.fromkeys(("flash_attention", "decode_attention", "matmul",
                          "matmul_bf16", "gmm_blocks"), 0)
    for a, L, _, Sd, f32 in plan:
        moe = a == "qwen3-moe-30b-a3b"
        n = Sd + mix
        want["flash_attention"] += L + f32
        want["decode_attention"] += L * n
        if moe:
            want["gmm_blocks"] += 3 * L * (1 + n) + 3 * f32
            want["matmul"] += L * (1 + n) + 5 * f32 + 1
            want["matmul_bf16"] += (4 * L + 1) * (1 + n)
        else:
            want["matmul_bf16"] += (7 * L + 1) * (1 + n)
            want["matmul"] += (7 * f32 + 1) if f32 else 0
    assert counts == want


def mix_steps(shapes, slots: int) -> int:
    """``decode_step`` calls of ``BatchedServer``'s schedule for requests
    (prompt length, new tokens) through ``slots``: each prompt token
    replayed at admission (which picks the first new token), then one
    tick a step for the live slots."""
    queue, live, steps = list(shapes), [], 0
    while queue or live:
        while queue and len(live) < slots:
            n, m = queue.pop(0)
            steps += n
            live.append(m - 1)
        steps += 1
        live = [r - 1 for r in live if r > 1]
    return steps


def test_near_ties_names_the_flipped_tokens():
    """``chip_smoke.near_ties``: where two runs' top-k first differ, the
    flipped tokens' k-th/(k+1)-th logit gaps against how far the second
    run's logits moved; a token flipped by a move wider than its gap is
    counted as a near-tie."""
    cs = _chip_smoke()
    g = torch.Generator().manual_seed(0)
    T_, E, k = 64, 16, 8
    logits = torch.randn(T_, E, generator=g)
    # token 5: the 8th and 9th experts 1e-4 apart, then swapped by a move
    # of 2e-4 in the second run
    order = logits[5].argsort(descending=True)
    logits[5, order[k]] = logits[5, order[k - 1]] - 1e-4
    moved = logits.clone()
    moved[5, order[k]] += 2e-4
    p1, p2 = torch.softmax(logits, -1), torch.softmax(moved, -1)
    def top(p):
        return torch.sort(p, dim=-1, descending=True,
                          stable=True).indices[:, :k]

    same, other = top(p1), top(p2)
    assert (same != other).any(-1).sum() == 1
    msg = cs.near_ties([same, same], [same, other], [p1, p1], [p1, p2], k)
    assert msg.startswith("first differing layer 1: 1 of 64 tokens")
    assert msg.endswith("gap <= move for 1/1")
    assert cs.near_ties([same], [same], [p1], [p1], k) == \
        "the routings never differ"
