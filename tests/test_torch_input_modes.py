"""The port's ``embeddings`` and ``vlm`` input modes (musicgen-medium, the
audio family over frame embeddings with an untied head; internvl2-76b, the
vlm family with patch embeddings in front of the text tokens) in
``models.transformer`` against the JAX package's, on the CPU at small size
(reduced configs: 2 layers, d_model 256, 4/2 heads of 64; internvl2's 8
prefix embeddings). The reference makes the params (``jax.random``) and
``transformer.from_reference`` carries them over; inputs come from numpy
seeds.

Tolerances:
* ``forward`` and ``decode_step`` logits: 1e-4 on f32 configs; atol 0.1,
  rtol 0.05 on bf16 ones, the reference's gate for LLM logits
  (``test_llm_graph.py``); the loss mask: equal;
* the KV caches after every step: 1e-5 in f32, the LLM gate in bf16 (an
  entry is a bf16 projection of a hidden state that carries the upstream
  roundings);
* the vlm forward against the same model fed the concatenated embeddings:
  equal (the same arithmetic);
* the port's decode against its own forward: 0.08, the reference's own
  bound (``test_decode_consistency.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch import bf16  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

torch.set_num_threads(1)
ARCHS = ["musicgen-medium", "internvl2-76b"]


def _rng(*key):
    return np.random.default_rng(list(key))


def _np(a):
    return np.asarray(a, np.float32)


def _from_ref(tree):
    return T.from_reference(jax.tree.map(np.asarray, tree))


def _cfgs(arch, dtype, **over):
    return (ref_get_config(arch).reduced(dtype=dtype, **over),
            get_config(arch).reduced(dtype=dtype, **over))


def _tol(dtype):
    return dict(atol=1e-4, rtol=1e-4) if dtype == "float32" \
        else dict(atol=0.1, rtol=0.05)


def _inputs(cfg, B, S, seed=0):
    """(the reference's batch, the port's): ``S`` frame embeddings for
    ``embeddings``; ``num_prefix_embeds`` patch embeddings and ``S`` text
    tokens for ``vlm``."""
    rng = _rng(B, S, seed)
    if cfg.input_mode == "embeddings":
        e = (rng.standard_normal((B, S, cfg.d_model)) * 0.5).astype(
            np.float32)
        return {"embeds": jnp.asarray(e)}, {"embeds": torch.from_numpy(e)}
    pre = (rng.standard_normal((B, cfg.num_prefix_embeds, cfg.d_model))
           * 0.02).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return ({"prefix_embeds": jnp.asarray(pre), "tokens": jnp.asarray(toks)},
            {"prefix_embeds": torch.from_numpy(pre),
             "tokens": torch.from_numpy(toks)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,over", [
    ("musicgen-medium", {}),
    # an embeddings model takes ``lm_head`` even when the config ties it
    ("musicgen-medium", {"tie_embeddings": True}),
    ("internvl2-76b", {})], ids=["musicgen", "musicgen_tied", "internvl2"])
def test_init_params_tree_matches_reference(arch, over, dtype):
    rcfg, cfg = _cfgs(arch, dtype, **over)
    want = jax.eval_shape(lambda k: RT.init_params(k, rcfg),
                          jax.random.PRNGKey(0))
    got = T.init_params(cfg, torch.Generator().manual_seed(0))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert tuple(g.shape) == w.shape, path
        assert bf16.dtype_name(g.dtype) == str(w.dtype), path
    assert ("embed" in got) == (cfg.input_mode == "vlm")
    assert tuple(got["lm_head"].shape) == (cfg.d_model, cfg.vocab_size)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype):
    rcfg, cfg = _cfgs(arch, dtype)
    rp = RT.init_params(jax.random.PRNGKey(1), rcfg)
    pp = _from_ref(rp)
    rb, pb = _inputs(cfg, 2, 12)
    before = ops.launch_counts()
    rl, raux, (_, rmask) = RT.forward(rp, rb, rcfg)
    pl, paux, (_, pmask) = T.forward(pp, pb, cfg)
    assert ops.launch_counts() == before   # the CPU runs the plain versions
    P = cfg.num_prefix_embeds if cfg.input_mode == "vlm" else 0
    assert pl.shape == (2, P + 12, cfg.vocab_size)
    assert pl.dtype == torch.float32 and float(paux) == float(raux) == 0.0
    np.testing.assert_array_equal(pmask.numpy(), _np(rmask))
    assert float(pmask[:, :P].sum()) == 0.0 and bool((pmask[:, P:] == 1).all())
    np.testing.assert_allclose(pl.numpy(), _np(rl), **_tol(dtype))


def test_vlm_positions_run_over_prefix_and_text():
    """The vlm forward is the same model fed the concatenated embeddings:
    RoPE positions 0..P+T-1 over prefix and text, not 0..T-1 over the
    text."""
    _, cfg = _cfgs("internvl2-76b", "float32")
    params = T.init_params(cfg, torch.Generator().manual_seed(3))
    _, pb = _inputs(cfg, 2, 6, seed=1)
    got, _, _ = T.forward(params, pb, cfg)
    x = torch.cat([pb["prefix_embeds"], params["embed"][pb["tokens"]]], 1)
    emb = dataclasses.replace(cfg, input_mode="embeddings")
    want, _, _ = T.forward(params, {"embeds": x}, emb)
    assert torch.equal(got, want)
    # the text alone, at positions 0..T-1, gives other logits
    text, _, _ = T.forward(params, {"embeds": x[:, cfg.num_prefix_embeds:]},
                           emb)
    assert not torch.allclose(text, got[:, cfg.num_prefix_embeds:],
                              atol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_decode_state_matches_reference(arch):
    rcfg, cfg = _cfgs(arch, "bfloat16")
    rs = RT.init_decode_state(rcfg, 3, 40)
    ps = T.init_decode_state(cfg, 3, 40, device="cpu")
    assert sorted(ps) == sorted(rs) == ["k", "v"]
    for k in rs:
        assert tuple(ps[k].shape) == rs[k].shape
        assert bf16.dtype_name(ps[k].dtype) == str(rs[k].dtype)
        assert not ps[k].any()
    assert (sum(t.nbytes for t in ps.values())
            == sum(int(a.nbytes) for a in rs.values()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch, dtype):
    """Frame embeddings (B, 1, d) a step for musicgen, which has no
    ``embed``; text tokens for internvl2. Logits and the KV caches after
    every step."""
    rcfg, cfg = _cfgs(arch, dtype)
    rp = RT.init_params(jax.random.PRNGKey(1), rcfg)
    pp = _from_ref(rp)
    B, S = 2, 10
    rb, pb = _inputs(cfg, B, S, seed=2)
    key = "embeds" if cfg.input_mode == "embeddings" else "tokens"
    rstate = RT.init_decode_state(rcfg, B, S)
    state = T.init_decode_state(cfg, B, S, device="cpu")
    rstep = jax.jit(lambda p, s, b, pos: RT.decode_step(p, s, b, pos, rcfg))
    stol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else _tol(dtype)
    before = ops.launch_counts()
    for t in range(S):
        rl, rstate = rstep(rp, rstate, {key: rb[key][:, t:t + 1]},
                           jnp.int32(t))
        lg, state = T.decode_step(pp, state, {key: pb[key][:, t:t + 1]}, t,
                                  cfg)
        assert lg.shape == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(lg.numpy(), _np(rl), **_tol(dtype))
        for k in rstate:
            np.testing.assert_allclose(state[k].float().numpy(),
                                       _np(rstate[k]), **stol,
                                       err_msg=f"{k} after step {t}")
    assert ops.launch_counts() == before


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_forward(arch):
    """The twin of the reference's ``test_decode_matches_forward`` (bf16,
    the port's own weights, 16 steps). A vlm step takes text tokens only,
    so its forward runs with an empty prefix."""
    _, cfg = _cfgs(arch, "bfloat16")
    params = T.init_params(cfg, torch.Generator().manual_seed(1))
    B, S = 2, 16
    _, pb = _inputs(cfg, B, S, seed=3)
    if cfg.input_mode == "vlm":
        pb["prefix_embeds"] = pb["prefix_embeds"][:, :0]
    logits, _, _ = T.forward(params, pb, cfg)
    key = "embeds" if cfg.input_mode == "embeddings" else "tokens"
    state = T.init_decode_state(cfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, state = T.decode_step(params, state, {key: pb[key][:, t:t + 1]},
                                  t, cfg)
        outs.append(lg[:, 0])
    assert float((torch.stack(outs, dim=1) - logits).abs().max()) < 0.08


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_defaults_to_the_card(arch):
    """``init_decode_state`` defaults to "cuda", the port's rule for entry
    points, and raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default does not raise")
    _, cfg = _cfgs(arch, "float32")
    with pytest.raises(RuntimeError):
        T.init_decode_state(cfg, 1, 8)
