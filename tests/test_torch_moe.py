"""The port's MoE slice (``kernels.gmm.gmm_blocks``, ``models.moe``, the moe
branch of ``models.transformer``) against the JAX package's, on the CPU at
small size. Inputs come from numpy seeds; the reference makes the params
(``jax.random``) and ``transformer.from_reference`` carries them over.

Tolerances:
* ``gmm_blocks_plain`` against the Pallas ``gmm_blocks``
  (``interpret=True``) and ``ref.gmm_ref``: the reference sweep's own,
  atol 5e-4·sqrt(d) and rtol 5e-4 in f32, 5e-2·sqrt(d) and 5e-2 in bf16
  (``test_kernels.py``); the grouped-FFN stage in f32: 1e-4, as there;
* the grouped FFN, ``_local_moe`` and ``moe_apply`` in f32: 1e-5 (the same
  f32 arithmetic, other summation orders); in bf16: 2e-2 with the same
  routing (a bf16 ulp is 2^-8 of a value, and the SiLU rounds once in the
  port where the reference rounds its sigmoid and its product);
* ``forward`` and ``decode_step`` logits: 1e-4 on f32 configs; on bf16
  ones atol 0.1, rtol 0.05, the reference's gate for LLM logits
  (``test_llm_graph.py``); the aux loss 1e-5 in f32 and 1e-2 in bf16;
* the port's decode against its own forward: 0.08, the reference's own
  bound (``test_decode_consistency.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro.kernels.gmm import gmm_blocks as pallas_gmm  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch import bf16  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.gmm import gmm_blocks_plain  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

torch.set_num_threads(1)
ARCH = "granite-moe-3b-a800m"


def _rng(*key):
    return np.random.default_rng(list(key))


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return bf16.to_tensor(np.array(a))


def _tol(dtype):
    return 5e-2 if dtype == "bfloat16" else 5e-4


# ---------------------------------------------------------------------------
# gmm_blocks: the plain version against the Pallas kernel and the oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("E,C,d,n", [(4, 64, 32, 48), (8, 128, 128, 128),
                                     (3, 40, 20, 9)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_blocks_plain_matches_pallas(E, C, d, n, dtype):
    rng = _rng(E, C, d, n)
    x = jnp.asarray(rng.standard_normal((E, C, d)) * 0.3, dtype)
    w = jnp.asarray(rng.standard_normal((E, d, n)) * 0.3, dtype)
    want = pallas_gmm(x, w, bc=32, bn=32, bk=32, interpret=True)
    oracle = R.gmm_ref(x, w)
    before = ops.launch_counts()["gmm_blocks"]
    got = ops.gmm_blocks(_t(x), _t(w))
    assert ops.launch_counts()["gmm_blocks"] == before  # CPU: plain version
    assert got.shape == (E, C, n) and bf16.dtype_name(got.dtype) == dtype
    tol = _tol(dtype)
    for ref in (want, oracle):
        np.testing.assert_allclose(_np(got.float()), _np(ref),
                                   atol=tol * np.sqrt(d), rtol=tol)


def test_gmm_blocks_plain_matches_grouped_ffn_stage():
    """One projection of ``_gffn_blocks``' expert stage, as the reference's
    ``test_gmm_matches_grouped_ffn_stage`` holds the Pallas kernel."""
    rng = _rng(4, 32)
    E, C, d, ff = 4, 32, 16, 24
    x = rng.standard_normal((E, C, d)).astype(np.float32)
    w = rng.standard_normal((E, d, ff)).astype(np.float32)
    want = pallas_gmm(jnp.asarray(x), jnp.asarray(w), bc=16, bn=16, bk=16,
                      interpret=True)
    got = gmm_blocks_plain(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.einsum("ecd,edn->ecn", x, w),
                               atol=1e-4)


def test_gmm_blocks_wrapper_checks():
    x, w = torch.zeros(2, 8, 4), torch.zeros(2, 5, 3)
    with pytest.raises(ValueError):
        ops.gmm_blocks(x, w)                      # d mismatch
    with pytest.raises(ValueError):
        ops.gmm_blocks(x, torch.zeros(3, 4, 3))   # E mismatch
    assert ops.gmm_blocks(x, torch.zeros(2, 4, 3)).shape == (2, 8, 3)


@pytest.mark.parametrize("E,C,d,n,sizes", [
    (4, 64, 32, 48, (0, 64, 17, 1)), (3, 40, 20, 9, (40, 0, 0)),
    (5, 8, 128, 128, (1, 0, 8, 3, 2))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_blocks_group_sizes_match_pallas(E, C, d, n, sizes, dtype):
    """With group sizes, the rows r < size equal the Pallas kernel's (at the
    sweep's tolerance) and every other row is exactly zero, an expert with
    no rows included."""
    rng = _rng(7, E, C, d, n)
    x = jnp.asarray(rng.standard_normal((E, C, d)) * 0.3, dtype)
    w = jnp.asarray(rng.standard_normal((E, d, n)) * 0.3, dtype)
    want = _np(pallas_gmm(x, w, bc=32, bn=32, bk=32, interpret=True))
    gs = torch.tensor(sizes, dtype=torch.int32)
    for got in (ops.gmm_blocks(_t(x), _t(w), gs),
                gmm_blocks_plain(_t(x), _t(w), gs)):
        assert got.shape == (E, C, n) and bf16.dtype_name(got.dtype) == dtype
        got = _np(got.float())
        tol = _tol(dtype)
        for e, size in enumerate(sizes):
            np.testing.assert_allclose(got[e, :size], want[e, :size],
                                       atol=tol * np.sqrt(d), rtol=tol)
            assert not got[e, size:].any()
    # without group sizes: the Pallas kernel's function, every row
    np.testing.assert_allclose(_np(gmm_blocks_plain(_t(x), _t(w)).float()),
                               want, atol=_tol(dtype) * np.sqrt(d),
                               rtol=_tol(dtype))


@pytest.mark.parametrize("C,sizes", [(8, (0, 3, 8, 1, 8, 0)),
                                     (26, (26, 0, 11, 26, 1, 5))])
def test_gmm_blocks_plain_f32_group_sizes_match_ref(C, sizes):
    """The f32 entry's function at a narrow granite-like shape (6 experts,
    d 96 -> n 32, the 3:1 of d_model 1536 to d_ff 512; C 8 as at decode
    and a prefill-like C 26): with group sizes 0, partial and full, the
    rows r < size equal ``ref.gmm_ref`` at the sweep's f32 tolerance and
    every other row is exactly zero."""
    E, d, n = len(sizes), 96, 32
    rng = _rng(11, C, d, n)
    x = rng.standard_normal((E, C, d)).astype(np.float32)
    w = (rng.standard_normal((E, d, n)) * d ** -0.5).astype(np.float32)
    want = _np(R.gmm_ref(jnp.asarray(x), jnp.asarray(w)))
    gs = torch.tensor(sizes, dtype=torch.int32)
    for got in (ops.gmm_blocks(torch.from_numpy(x), torch.from_numpy(w), gs),
                gmm_blocks_plain(torch.from_numpy(x), torch.from_numpy(w),
                                 gs)):
        assert got.shape == (E, C, n) and got.dtype == torch.float32
        got = got.numpy()
        for e, size in enumerate(sizes):
            np.testing.assert_allclose(got[e, :size], want[e, :size],
                                       atol=_tol("float32") * np.sqrt(d),
                                       rtol=_tol("float32"))
            assert not got[e, size:].any()


def test_gmm_blocks_group_sizes_checks():
    x, w = torch.zeros(2, 8, 4), torch.zeros(2, 4, 3)
    with pytest.raises(ValueError):
        ops.gmm_blocks(x, w, torch.zeros(3, dtype=torch.int32))
    # rows past the sizes are zero even where the product is not finite
    w_inf = torch.full((2, 4, 3), float("inf"))
    y = ops.gmm_blocks(torch.ones(2, 8, 4), w_inf,
                       torch.tensor([0, 2], dtype=torch.int32))
    assert not y[0].any() and not y[1, 2:].any()
    assert torch.isinf(y[1, :2]).all()


def test_gffn_blocks_passes_group_sizes(monkeypatch):
    """``_gffn_blocks`` hands its group sizes (int32) to every
    ``gmm_blocks`` launch, and its output is the reference's."""
    rng = _rng(8)
    E, d, ff, C = 4, 8, 16, 8
    sizes = np.array([3, 0, 8, 5])
    xs = rng.standard_normal((int(sizes.sum()), d)).astype(np.float32)
    wg, wu, wd = _expert_weights(rng, E, d, ff)
    seen = []
    real = ops.gmm_blocks

    def spy(x, w, group_sizes=None):
        seen.append(group_sizes)
        return real(x, w, group_sizes)

    monkeypatch.setattr(ops, "gmm_blocks", spy)
    offsets = np.cumsum(sizes) - sizes
    xs_pad = np.pad(xs, ((0, C), (0, 0)))
    got = M._gffn_blocks(torch.from_numpy(xs_pad), torch.from_numpy(offsets),
                         torch.from_numpy(sizes), torch.from_numpy(wg),
                         torch.from_numpy(wu), torch.from_numpy(wd), C)
    want = RM._gffn_blocks(jnp.asarray(xs_pad), jnp.asarray(offsets),
                           jnp.asarray(sizes, jnp.int32), jnp.asarray(wg),
                           jnp.asarray(wu), jnp.asarray(wd), C)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)
    assert len(seen) == 3
    for gs in seen:
        assert gs.dtype == torch.int32 and gs.tolist() == sizes.tolist()


# ---------------------------------------------------------------------------
# grouped FFN and routing
# ---------------------------------------------------------------------------
def _expert_weights(rng, E, d, ff, scale=0.2):
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in ((E, d, ff), (E, d, ff), (E, ff, d))]


@pytest.mark.parametrize("seed", range(6))
def test_grouped_ffn_matches_reference(seed):
    """Random group sizes, capacity at or above the largest group (the
    twin of ``test_grouped_ffn_matches_ragged``) and, for odd seeds, below
    it (tokens dropped)."""
    rng = _rng(seed)
    E, d, ff = 4, 8, 16
    sizes = rng.multinomial(32, np.ones(E) / E)
    C = max(8, int(np.ceil(sizes.max() / 8.0)) * 8)
    if seed % 2:
        C = 8
    xs = rng.standard_normal((int(sizes.sum()), d)).astype(np.float32)
    wg, wu, wd = _expert_weights(rng, E, d, ff)
    want = RM._grouped_ffn(jnp.asarray(xs), jnp.asarray(sizes, jnp.int32),
                           jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wd),
                           C)
    got = M._grouped_ffn(torch.from_numpy(xs), torch.from_numpy(sizes),
                         torch.from_numpy(wg), torch.from_numpy(wu),
                         torch.from_numpy(wd), C)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)


def test_moe_capacity_drops_tokens():
    """With capacity below the largest group, the tokens past C contribute
    0 (the twin of the reference's ``test_moe_capacity_drops_tokens``)."""
    E, d, ff = 2, 4, 8
    gs = torch.tensor([12, 0])
    xs = torch.ones((12, d))
    w = torch.full((E, d, ff), 0.1), torch.full((E, d, ff), 0.1)
    y = M._grouped_ffn(xs, gs, *w, torch.full((E, ff, d), 0.1), 8)
    assert float(y[:8].abs().min()) > 0
    assert float(y[8:].abs().max()) == 0.0
    want = RM._grouped_ffn(jnp.ones((12, d)), jnp.array([12, 0], jnp.int32),
                           jnp.full((E, d, ff), 0.1), jnp.full((E, d, ff), 0.1),
                           jnp.full((E, ff, d), 0.1), 8)
    np.testing.assert_allclose(y.numpy(), _np(want), atol=1e-6)


def test_capacity_matches_reference_formula():
    cfg = get_config(ARCH)
    # granite at decode (4 slots) and at a 512-token prefill
    assert M.capacity(4, cfg) == 8
    assert M.capacity(512, cfg) == 208
    assert M.capacity(1, cfg.reduced()) == 8


def _from_ref(tree):
    return T.from_reference(jax.tree.map(np.asarray, tree))


def _moe_inputs(dtype, tokens=24, seed=0):
    rcfg = ref_get_config(ARCH).reduced(dtype=dtype)
    cfg = get_config(ARCH).reduced(dtype=dtype)
    rp = RM.moe_init(jax.random.PRNGKey(seed), rcfg)
    x = jnp.asarray(_rng(seed, tokens).standard_normal(
        (tokens, rcfg.d_model)), dtype)
    return rcfg, cfg, rp, _from_ref(rp), x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_local_moe_matches_reference(dtype):
    rcfg, cfg, rp, pp, x = _moe_inputs(dtype)
    args = ("router", "w_gate", "w_up", "w_down")
    y_r, aux_r = RM._local_moe(x, *(rp[k] for k in args), rcfg)
    y, aux = M._local_moe(_t(x), *(pp[k] for k in args), cfg)
    assert y.dtype == pp["w_gate"].dtype and aux.dtype == torch.float32
    # the same routing: the top k experts in the same (descending) order
    probs = jax.nn.softmax(x.astype(jnp.float32) @ rp["router"], axis=-1)
    _, top_e_r = jax.lax.top_k(probs, rcfg.top_k)
    _, _, top_e = M.route(_t(x), pp["router"], cfg)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(top_e_r))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(y.float()), _np(y_r), atol=tol, rtol=tol)
    np.testing.assert_allclose(float(aux), float(aux_r), rtol=1e-5)


def test_route_breaks_ties_by_lower_index():
    """Equal probabilities: the lower expert index first, as lax.top_k."""
    cfg = get_config(ARCH).reduced()                     # E 4, k 2
    router = torch.zeros((cfg.d_model, cfg.num_experts))
    router[:, 3] = 1.0                                   # expert 3 wins
    x = torch.ones((2, cfg.d_model))
    _, top_p, top_e = M.route(x, router, cfg)
    assert top_e.tolist() == [[3, 0], [3, 0]]
    _, want = jax.lax.top_k(jax.nn.softmax(
        jnp.ones((2, cfg.d_model)) @ jnp.asarray(router.numpy()), -1), 2)
    assert np.asarray(want).tolist() == top_e.tolist()
    assert torch.allclose(top_p.sum(-1), torch.ones(2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_matches_reference_in_token_blocks(dtype, monkeypatch):
    """(B, S, d) through ``moe_apply``, with the token block cut to 12 in
    both packages so that 3·8 tokens route as two sequential blocks."""
    rcfg, cfg, rp, pp, _ = _moe_inputs(dtype)
    x = jnp.asarray(_rng(5).standard_normal((3, 8, rcfg.d_model)), dtype)
    monkeypatch.setattr(RM, "MOE_TOKEN_BLOCK", 12)
    monkeypatch.setattr(M, "MOE_TOKEN_BLOCK", 12)
    y_r, aux_r = RM.moe_apply(rp, x, rcfg)
    y, aux = M.moe_apply(pp, _t(x), cfg)
    assert y.shape == (3, 8, rcfg.d_model)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(y.float()), _np(y_r), atol=tol, rtol=tol)
    np.testing.assert_allclose(float(aux), float(aux_r), rtol=1e-5)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
def _cfgs(dtype, **over):
    return (ref_get_config(ARCH).reduced(dtype=dtype, **over),
            get_config(ARCH).reduced(dtype=dtype, **over))


def test_init_params_tree_matches_reference():
    rcfg, cfg = _cfgs("bfloat16")
    want = jax.eval_shape(lambda k: RT.init_params(k, rcfg),
                          jax.random.PRNGKey(0))
    got = T.init_params(cfg, torch.Generator().manual_seed(0))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert tuple(g.shape) == w.shape, path
        assert bf16.dtype_name(g.dtype) == str(w.dtype), path
    assert "moe" in got["blocks"] and "mlp" not in got["blocks"]


# a bf16 run rounds upstream of the f32 router elsewhere than the reference,
# which can flip a near-tie between the k-th and the (k+1)-th expert: that
# token then takes another expert's FFN, far outside any logits gate. So a
# row of bf16 logits may leave the gate only where the port's router had
# such a near-tie (the k-th and (k+1)-th probability within TIE) in some
# layer, and at most a tenth of the rows may; every other row is held to
# the gate.
TIE = 5e-3


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


def _assert_logits(got, want, dtype, tie_gap):
    """(rows, V) logits: 1e-4 in f32; in bf16 the LLM gate on every row but
    those whose routing had a near-tie (``tie_gap`` (rows,), see TIE)."""
    got = got.reshape(-1, got.shape[-1])
    want = want.reshape(got.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        return
    out = ~(np.abs(got - want) <= 0.1 + 0.05 * np.abs(want)).all(axis=1)
    assert out.mean() <= 0.1, f"{out.sum()} of {len(out)} rows off the gate"
    assert (tie_gap[out] < TIE).all(), (
        f"rows {np.flatnonzero(out)} leave the gate without a near-tie in "
        f"their routing (gaps {tie_gap[out]})")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype, router_gaps):
    rcfg, cfg = _cfgs(dtype)
    rp = RT.init_params(jax.random.PRNGKey(1), rcfg)
    pp = _from_ref(rp)
    toks = _rng(2, 16).integers(0, cfg.vocab_size, size=(2, 16)).astype(
        np.int32)
    rl, raux, _ = RT.forward(rp, {"tokens": jnp.asarray(toks)}, rcfg)
    pl, paux, (_, mask) = T.forward(pp, {"tokens": torch.from_numpy(toks)},
                                    cfg)
    assert pl.shape == (2, 16, cfg.vocab_size) and pl.dtype == torch.float32
    assert mask.shape == (2, 16)
    assert len(router_gaps) == cfg.num_layers          # one route a layer
    gap = torch.stack(router_gaps).min(dim=0).values.numpy()
    _assert_logits(pl.numpy(), _np(rl), dtype, gap)
    np.testing.assert_allclose(float(paux), float(raux),
                               rtol=1e-5 if dtype == "float32" else 1e-2)
    assert float(paux) > 0   # two MoE layers' load-balance losses


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(dtype, router_gaps):
    rcfg, cfg = _cfgs(dtype)
    rp = RT.init_params(jax.random.PRNGKey(1), rcfg)
    pp = _from_ref(rp)
    B, S = 2, 12
    toks = _rng(S, B).integers(0, cfg.vocab_size, size=(B, S)).astype(
        np.int32)
    rstate = RT.init_decode_state(rcfg, B, S)
    state = T.init_decode_state(cfg, B, S, device="cpu")
    assert sorted(state) == sorted(rstate) == ["k", "v"]
    rstep = jax.jit(lambda p, s, b, pos: RT.decode_step(p, s, b, pos, rcfg))
    got, want = [], []
    for t in range(S):
        rl, rstate = rstep(rp, rstate,
                           {"tokens": jnp.asarray(toks[:, t:t + 1])},
                           jnp.int32(t))
        lg, state = T.decode_step(
            pp, state, {"tokens": torch.from_numpy(toks[:, t:t + 1])}, t, cfg)
        assert lg.shape == (B, 1, cfg.vocab_size)
        got.append(lg.numpy()[:, 0])
        want.append(_np(rl)[:, 0])
    assert len(router_gaps) == S * cfg.num_layers
    gap = torch.stack(router_gaps).reshape(S, cfg.num_layers, B).min(
        dim=1).values.numpy()                          # (S, B)
    _assert_logits(np.stack(got), np.stack(want), dtype, gap.reshape(-1))


def test_decode_step_int8_cache_matches_reference():
    """The int8-KV arm of the moe decode body (f32 config; tolerance as
    ``test_torch_decode``'s int8 case: 1e-2)."""
    from repro.models.runtime_flags import FLAGS as REF_FLAGS
    from repro_torch.models.runtime_flags import FLAGS

    saved = dict(REF_FLAGS), dict(FLAGS)
    REF_FLAGS["kv_cache_int8"] = FLAGS["kv_cache_int8"] = True
    try:
        rcfg, cfg = _cfgs("float32")
        rp = RT.init_params(jax.random.PRNGKey(4), rcfg)
        pp = _from_ref(rp)
        B, S = 2, 8
        toks = _rng(9).integers(0, cfg.vocab_size, size=(B, S)).astype(
            np.int32)
        rstate = RT.init_decode_state(rcfg, B, S)
        state = T.init_decode_state(cfg, B, S, device="cpu")
        assert state["k"].dtype == torch.int8
        rstep = jax.jit(lambda p, s, b, pos: RT.decode_step(p, s, b, pos,
                                                            rcfg))
        for t in range(S):
            rl, rstate = rstep(rp, rstate,
                               {"tokens": jnp.asarray(toks[:, t:t + 1])},
                               jnp.int32(t))
            lg, state = T.decode_step(
                pp, state, {"tokens": torch.from_numpy(toks[:, t:t + 1])}, t,
                cfg)
            np.testing.assert_allclose(lg.numpy(), _np(rl), atol=1e-2,
                                       rtol=1e-2)
    finally:
        for flags, old in zip((REF_FLAGS, FLAGS), saved):
            flags.clear()
            flags.update(old)


def test_decode_matches_own_forward():
    """The twin of the reference's ``test_decode_matches_forward`` for
    granite (bf16, the port's own weights)."""
    _, cfg = _cfgs("bfloat16")
    params = T.init_params(cfg, torch.Generator().manual_seed(1))
    B, S = 2, 16
    toks = torch.from_numpy(_rng(16, 7).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int64))
    logits, _, _ = T.forward(params, {"tokens": toks}, cfg)
    state = T.init_decode_state(cfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, state = T.decode_step(params, state,
                                  {"tokens": toks[:, t:t + 1]}, t, cfg)
        outs.append(lg[:, 0])
    assert float((torch.stack(outs, dim=1) - logits).abs().max()) < 0.08
