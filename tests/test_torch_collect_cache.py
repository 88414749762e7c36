"""The prefill cache of the port's ``forward(collect_cache=True)`` against
the JAX package's, on the CPU at small size, for every cache structure:
``{"kv": (k, v)}`` (smollm, granite, internvl2's vlm mode),
``{"local": ..., "global": ...}`` (gemma2's pairs), ``{"mamba": ((conv_x,
conv_B, conv_C), ssm)}`` (mamba2) and the hybrid's (G, every, ...) mamba
states with ``"shared_kv"`` (zamba2 at 4 layers, two groups). The
reference makes the params (``jax.random``) and
``transformer.from_reference`` carries them over; inputs come from numpy
seeds. f32 configs throughout.

Gates: each cache leaf within 1e-4 of max|ref| of the reference's (the
f32 forward bound of ``test_torch_hybrid.py``); collecting leaves the
logits the same bits; remat with a ``remat_group`` of 2 gives the same
cache bits; the cache within 1e-4 of max|state| of the state that S
``decode_step``s leave (K/V rows 0..S-1, the conv and SSM states).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

torch.set_num_threads(1)
B, S = 2, 16
# name: (arch, reduced-config overrides beside dtype f32)
CASES = {
    "smollm": ("smollm-360m", {}),
    "granite": ("granite-moe-3b-a800m", {}),
    "gemma2": ("gemma2-27b", {"num_layers": 4}),
    "mamba2": ("mamba2-2.7b", {"ssm_chunk": 8}),
    "zamba2": ("zamba2-2.7b", {"num_layers": 4, "ssm_chunk": 8}),
    "internvl2": ("internvl2-76b", {}),
}
TOL = 1e-4


def _cfgs(case):
    arch, over = CASES[case]
    kw = dict(dtype="float32", **over)
    return ref_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


def _batch(cfg, seed=0):
    """numpy inputs of the config's input mode."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "vlm":
        P = cfg.num_prefix_embeds
        return {"tokens": rng.integers(0, cfg.vocab_size, (B, S - P),
                                       dtype=np.int32),
                "prefix_embeds": rng.standard_normal(
                    (B, P, cfg.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S),
                                   dtype=np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def runs():
    """Per case: (port cfg, port params, port batch, the reference's
    cache as numpy leaves with paths)."""
    out = {}

    def get(case):
        if case not in out:
            rcfg, cfg = _cfgs(case)
            rparams = RT.init_params(jax.random.PRNGKey(3), rcfg)
            batch = _batch(cfg)
            _, _, (rcache, _) = RT.forward(
                rparams, {k: jnp.asarray(v) for k, v in batch.items()}, rcfg,
                collect_cache=True)
            params = T.from_reference(jax.tree.map(np.asarray, rparams))
            out[case] = (cfg, params, _torch_batch(batch),
                         jax.tree_util.tree_flatten_with_path(rcache)[0])
        return out[case]

    return get


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    d = np.abs(got.detach().numpy().astype(np.float32) - want).max()
    return float(d / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", sorted(CASES))
def test_cache_matches_reference(case, runs):
    """The reference's tree, leaf for leaf (paths, shapes, dtypes), each
    leaf within 1e-4 of its max|ref|; the logits unchanged by collecting,
    bit for bit."""
    cfg, params, batch, want = runs(case)
    with torch.no_grad():
        logits, _, (cache, _) = T.forward(params, batch, cfg,
                                          collect_cache=True)
        plain, _, (none, _) = T.forward(params, batch, cfg)
    assert none is None
    assert torch.equal(logits, plain)
    got = _flat(cache)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), path
        assert _rel(g, w) <= TOL, (jax.tree_util.keystr(path), _rel(g, w))


@pytest.mark.parametrize("case", ["smollm", "gemma2", "mamba2", "zamba2"])
def test_cache_under_remat_is_the_same(case, runs):
    """Under grad with remat in groups of 2 (gemma2: its pairs; ssm a
    block; hybrid a group) the cache and the logits are the same bits as
    without remat."""
    cfg, params, batch, _ = runs(case)
    with torch.no_grad():
        logits, _, (cache, _) = T.forward(params, batch, cfg,
                                          collect_cache=True)
    ps = {k: v for k, v in params.items()}
    with torch.enable_grad():
        rl, _, (rc, _) = T.forward(ps, batch, cfg, remat=True, remat_group=2,
                                   collect_cache=True)
    assert torch.equal(rl.detach(), logits)
    for (path, a), (_, b) in zip(_flat(rc), _flat(cache)):
        assert torch.equal(a.detach(), b), jax.tree_util.keystr(path)


def _decoded_state(cfg, params, batch):
    """The decode state after S ``decode_step``s over the batch's
    tokens."""
    state = T.init_decode_state(cfg, B, S, device="cpu")
    with torch.no_grad():
        for t in range(S):
            _, state = T.decode_step(params, state,
                                     {"tokens": batch["tokens"][:, t:t + 1]},
                                     t, cfg)
    return state


def _pairs(cfg, cache, state):
    """(name, cache leaf, the decode state's counterpart) of every leaf;
    K/V rows 0..S-1 of the decode caches."""
    rows = slice(0, S)
    if cfg.family in ("ssm", "hybrid"):
        (cx, cB, cC), ssm = cache["mamba"]
        out = [("conv_x", cx, state["conv_x"]), ("conv_B", cB, state["conv_B"]),
               ("conv_C", cC, state["conv_C"]), ("ssm", ssm, state["ssm"])]
        if cfg.family == "hybrid":
            k, v = cache["shared_kv"]
            out += [("shared_k", k, state["shared_k"][:, :, rows]),
                    ("shared_v", v, state["shared_v"][:, :, rows])]
        return out
    if cfg.local_global_pattern:
        (kl, vl), (kg, vg) = cache["local"], cache["global"]
        return [("k_local", kl, state["k_local"][:, :, rows]),
                ("v_local", vl, state["v_local"][:, :, rows]),
                ("k_global", kg, state["k_global"][:, :, rows]),
                ("v_global", vg, state["v_global"][:, :, rows])]
    k, v = cache["kv"]
    return [("k", k, state["k"][:, :, rows]), ("v", v, state["v"][:, :, rows])]


@pytest.mark.parametrize("case", ["smollm", "granite", "gemma2", "mamba2",
                                  "zamba2"])
def test_cache_equals_state_after_decode(case, runs):
    """The prefill cache seeds decode at position S: each leaf within 1e-4
    of max|state| of what S decode steps leave (gemma2's local window, 32,
    holds all S = 16 rows)."""
    cfg, params, batch, _ = runs(case)
    with torch.no_grad():
        _, _, (cache, _) = T.forward(params, batch, cfg, collect_cache=True)
    state = _decoded_state(cfg, params, batch)
    for name, c, s in _pairs(cfg, cache, state):
        assert c.shape == s.shape, name
        d = (c - s).abs().max() / max(s.abs().max().item(), 1e-30)
        assert d <= TOL, (name, float(d))
