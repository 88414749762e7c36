"""The port's hybrid family (zamba2: groups of mamba blocks, each followed
by one shared attention block) in ``models.transformer`` against the JAX
package's, on the CPU at small size. Every case runs 4 layers in groups of
``shared_attn_every`` 2 (G = 2, so a mix-up of a group's shared cache with
another's shows), ``ssm_chunk`` 8; one case has zamba2's head dim 80, one a
sliding window whose ring wraps. The reference makes the params
(``jax.random``) and ``transformer.from_reference`` carries them over;
inputs come from numpy seeds.

Tolerances:
* ``forward`` and ``decode_step`` logits: 1e-4 on f32 configs; atol 0.1,
  rtol 0.05 on bf16 ones, the reference's gate for LLM logits
  (``test_llm_graph.py``); the loss mask: equal;
* the decode states after every step (conv and SSM states, the shared KV
  caches): 1e-5 in f32 (``test_torch_ssm.py``'s mixer bound); in bf16 the
  LLM gate, since a cache entry is a bf16 projection of a hidden state
  that already carries the upstream layers' roundings (one entry in
  thousands sits a few bf16 steps apart);
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
from repro.serving.server import BatchedServer as RefServer  # noqa: E402
from repro_torch import bf16  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import BatchedServer  # noqa: E402

torch.set_num_threads(1)
ARCH = "zamba2-2.7b"
# name: config overrides beside the reduced zamba2's
CASES = {"hd64": {}, "hd80": {"head_dim": 80},
         "window6": {"sliding_window": 6}}


def _rng(*key):
    return np.random.default_rng(list(key))


def _np(a):
    return np.asarray(a, np.float32)


def _from_ref(tree):
    return T.from_reference(jax.tree.map(np.asarray, tree))


def _cfgs(dtype, case="hd64"):
    kw = dict(num_layers=4, shared_attn_every=2, ssm_chunk=8, dtype=dtype,
              **CASES[case])
    return (ref_get_config(ARCH).reduced(**kw),
            get_config(ARCH).reduced(**kw))


def _tol(dtype):
    return dict(atol=1e-4, rtol=1e-4) if dtype == "float32" \
        else dict(atol=0.1, rtol=0.05)


def _same_tree(want, got):
    """The same paths, shapes and dtypes (``want`` may be abstract)."""
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert tuple(g.shape) == w.shape, path
        assert bf16.dtype_name(g.dtype) == str(w.dtype), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_tree_matches_reference(dtype):
    """Stacked mamba ``blocks`` (L, ...) and one unstacked ``shared``
    attention block, tied head: the reference's tree, shapes and dtypes."""
    rcfg, cfg = _cfgs(dtype, "hd80")
    want = jax.eval_shape(lambda k: RT.init_params(k, rcfg),
                          jax.random.PRNGKey(0))
    got = T.init_params(cfg, torch.Generator().manual_seed(0))
    _same_tree(want, got)
    assert sorted(got) == ["blocks", "embed", "final_norm", "shared"]
    assert tuple(got["shared"]["attn"]["wq"].shape) == (
        cfg.d_model, cfg.num_heads * 80)
    assert tuple(got["blocks"]["mamba"]["in_x"].shape)[0] == cfg.num_layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_reference(case, dtype):
    rcfg, cfg = _cfgs(dtype, case)
    rp = RT.init_params(jax.random.PRNGKey(1), rcfg)
    pp = _from_ref(rp)
    toks = _rng(4, 16).integers(0, cfg.vocab_size, size=(2, 16)).astype(
        np.int32)
    before = ops.launch_counts()
    rl, raux, (_, rmask) = RT.forward(rp, {"tokens": jnp.asarray(toks)}, rcfg)
    pl, paux, (_, pmask) = T.forward(pp, {"tokens": torch.from_numpy(toks)},
                                     cfg)
    assert ops.launch_counts() == before   # the CPU runs the plain versions
    assert pl.shape == (2, 16, cfg.vocab_size) and pl.dtype == torch.float32
    assert float(paux) == float(raux) == 0.0
    np.testing.assert_array_equal(pmask.numpy(), _np(rmask))
    np.testing.assert_allclose(pl.numpy(), _np(rl), **_tol(dtype))


def test_forward_applies_the_shared_block_once_a_group():
    """G = 2: the shared block's attention runs twice a forward, after
    mamba layers 1 and 3, with the same weights."""
    _, cfg = _cfgs("float32")
    params = T.init_params(cfg, torch.Generator().manual_seed(2))
    calls = []
    attn, mamba = T._attn_block_seq, T._mamba_block_seq

    def rec_attn(bp, *a, **k):
        calls.append(("attn", bp["attn"]["wq"].data_ptr()))
        return attn(bp, *a, **k)

    def rec_mamba(bp, *a, **k):
        calls.append(("mamba", bp["ln1"].data_ptr()))
        return mamba(bp, *a, **k)

    T._attn_block_seq, T._mamba_block_seq = rec_attn, rec_mamba
    try:
        T.forward(params, {"tokens": torch.zeros((1, 8), dtype=torch.int64)},
                  cfg)
    finally:
        T._attn_block_seq, T._mamba_block_seq = attn, mamba
    assert [k for k, _ in calls] == ["mamba", "mamba", "attn"] * 2
    wq = params["shared"]["attn"]["wq"].data_ptr()
    assert [p for k, p in calls if k == "attn"] == [wq, wq]
    ln1 = params["blocks"]["ln1"]
    assert [p for k, p in calls if k == "mamba"] == [
        ln1[i].data_ptr() for i in range(4)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_decode_state_matches_reference(case):
    """(G, every, ...) mamba states and (G, B, W, KV, hd) shared caches;
    the serving reservation counts the same bytes in both packages."""
    rcfg, cfg = _cfgs("bfloat16", case)
    rs = RT.init_decode_state(rcfg, 3, 40)
    ps = T.init_decode_state(cfg, 3, 40, device="cpu")
    assert sorted(ps) == sorted(rs) == ["conv_B", "conv_C", "conv_x",
                                        "shared_k", "shared_v", "ssm"]
    for k in rs:
        assert tuple(ps[k].shape) == rs[k].shape, k
        assert bf16.dtype_name(ps[k].dtype) == str(rs[k].dtype), k
        assert not ps[k].any()
    W = min(cfg.sliding_window or 40, 40)
    assert tuple(ps["shared_k"].shape) == (2, 3, W, cfg.num_kv_heads,
                                           cfg.head_dim)
    assert tuple(ps["ssm"].shape)[:3] == (2, 2, 3)
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    srv = BatchedServer(_from_ref(rp), cfg, max_batch=3, max_len=40,
                        device="cpu")
    assert srv.kv_bytes == RefServer(rp, rcfg, max_batch=3,
                                     max_len=40).kv_bytes
    assert srv.kv_bytes == sum(t.nbytes for t in ps.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_step_matches_reference(case, dtype):
    """Logits and every state tensor after each step (the window case's
    6-entry ring wraps within the 12 positions)."""
    rcfg, cfg = _cfgs(dtype, case)
    rp = RT.init_params(jax.random.PRNGKey(1), rcfg)
    pp = _from_ref(rp)
    B, S = 2, 12
    toks = _rng(S, B, 5).integers(0, cfg.vocab_size, size=(B, S)).astype(
        np.int32)
    rstate = RT.init_decode_state(rcfg, B, S)
    state = T.init_decode_state(cfg, B, S, device="cpu")
    rstep = jax.jit(lambda p, s, b, pos: RT.decode_step(p, s, b, pos, rcfg))
    stol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else _tol(dtype)
    before = ops.launch_counts()
    for t in range(S):
        rl, rstate = rstep(rp, rstate,
                           {"tokens": jnp.asarray(toks[:, t:t + 1])},
                           jnp.int32(t))
        lg, state = T.decode_step(
            pp, state, {"tokens": torch.from_numpy(toks[:, t:t + 1])}, t, cfg)
        assert lg.shape == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(lg.numpy(), _np(rl), **_tol(dtype))
        for k in rstate:
            np.testing.assert_allclose(state[k].float().numpy(),
                                       _np(rstate[k]), **stol,
                                       err_msg=f"{k} after step {t}")
    assert ops.launch_counts() == before
    # each group's application wrote its own cache
    assert not torch.equal(state["shared_k"][0], state["shared_k"][1])


def test_decode_matches_own_forward():
    """The twin of the reference's ``test_decode_matches_forward`` for
    zamba2 (bf16, the port's own weights, chunk 8 over 16 tokens, G 2)."""
    _, cfg = _cfgs("bfloat16", "hd80")
    params = T.init_params(cfg, torch.Generator().manual_seed(1))
    B, S = 2, 16
    toks = torch.from_numpy(_rng(16, 9).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int64))
    logits, _, _ = T.forward(params, {"tokens": toks}, cfg)
    state = T.init_decode_state(cfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, state = T.decode_step(params, state,
                                  {"tokens": toks[:, t:t + 1]}, t, cfg)
        outs.append(lg[:, 0])
    assert float((torch.stack(outs, dim=1) - logits).abs().max()) < 0.08


def test_groups_must_divide_the_layers():
    _, cfg = _cfgs("float32")
    bad = dataclasses.replace(cfg, num_layers=5)
    with pytest.raises(ValueError):
        T.init_params(bad, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        T.init_decode_state(bad, 1, 8, device="cpu")


def test_hybrid_decode_state_defaults_to_the_card():
    """``init_decode_state`` defaults to "cuda", the port's rule for entry
    points, and raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default does not raise")
    _, cfg = _cfgs("float32")
    with pytest.raises(RuntimeError):
        T.init_decode_state(cfg, 1, 8)
