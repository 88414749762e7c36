"""The port's training path for the dense body (``models.transformer.
loss_fn`` and ``remat``, ``optim``, ``data``, ``train``,
``checkpoint.save_pytree``/``load_pytree``, ``launch.train``) against the
JAX package's, on the CPU at small size (reduced configs: 2 layers,
d_model 256, vocab 512; inputs and gradients from numpy seeds, the
reference's params carried over with ``from_reference``).

Tolerances:
* ``loss_fn``'s value: 1e-5 relative; every gradient leaf, the params and
  the f32 moments after train steps: 1e-4 of the leaf's max|ref| (f32
  configs: the same f32 arithmetic in another order);
* ``adamw_update`` on identical gradients: 1e-6 of max|ref| on f32
  leaves and moments, one bf16 ulp of max|ref| on bf16 params.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data import SyntheticPipeline as RefPipeline  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.optim import adamw as RA  # noqa: E402
from repro.train import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch import optim as PA  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticPipeline  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

torch.set_num_threads(1)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _rel(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _cfgs(arch, **over):
    over.setdefault("dtype", "float32")
    return ref_get_config(arch).reduced(**over), \
        get_config(arch).reduced(**over)


def _params(rcfg, seed=0):
    """(the reference's params, the port's copy of them)."""
    rp = RT.init_params(jax.random.PRNGKey(seed), rcfg)
    return rp, T.from_reference(jax.tree.map(np.asarray, rp))


def _batch(cfg, B, S, seed=0):
    """(the reference's batch, the port's) for ``cfg``'s input mode."""
    rng = np.random.default_rng([B, S, seed])
    out = {}
    if cfg.input_mode == "embeddings":
        out["embeds"] = (rng.standard_normal((B, S, cfg.d_model))
                         * 0.5).astype(np.float32)
        out["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    if cfg.input_mode == "vlm":
        out["prefix_embeds"] = (rng.standard_normal(
            (B, cfg.num_prefix_embeds, cfg.d_model)) * 0.02).astype(
                np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _leaf_rels(got_tree, ref_tree):
    """(keystr, rel) per leaf, checking the two trees' keys agree."""
    ref = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    got = pytree.flatten_with_path(got_tree)
    assert [k for k, _ in got] == [jax.tree_util.keystr(p) for p, _ in ref]
    return [(k, _rel(_np(g), np.asarray(r, np.float32)))
            for (k, g), (_, r) in zip(got, ref)]


# ---------------------------------------------------------------------------
# loss_fn
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["smollm-360m", "musicgen-medium",
                                  "internvl2-76b", "gemma2-27b"])
def test_loss_fn_and_grads_match_reference(arch):
    """``loss_fn``'s value and metrics, and every gradient leaf of
    ``torch.autograd.grad``, against ``jax.value_and_grad`` of the
    reference's ``loss_fn`` in f32: the three input modes (tokens,
    embeddings, vlm with its prefix) and gemma2's local/global pairs with
    both softcaps, with remat (per block, per pair) and without."""
    rcfg, cfg = _cfgs(arch)
    rp, pp = _params(rcfg)
    rb, pb = _batch(cfg, 2, 24)
    (rl, rm), rg = jax.jit(jax.value_and_grad(
        lambda p, b: RT.loss_fn(p, b, rcfg), has_aux=True))(rp, rb)
    leaves = pytree.leaves(pp)
    for p in leaves:
        p.requires_grad_(True)
    for remat in (False, True):
        total, m = T.loss_fn(pp, pb, cfg, remat=remat)
        assert abs(total.item() - float(rl)) <= 1e-5 * abs(float(rl))
        assert abs(m["loss"].item() - float(rm["loss"])) <= \
            1e-5 * abs(float(rm["loss"]))
        assert float(m["aux_loss"]) == float(rm["aux_loss"]) == 0.0
        grads = pytree.unflatten(pp, torch.autograd.grad(total, leaves))
        for key, rel in _leaf_rels(grads, rg):
            assert rel <= 1e-4, (key, rel)


def test_remat_grads_bitwise_equal():
    """``remat`` per block and per group of two blocks gives the same
    loss and gradient bits as no remat (the same kernels replayed)."""
    _, cfg = _cfgs("smollm-360m", num_layers=4)
    pp = T.init_params(cfg, torch.Generator().manual_seed(0))
    _, pb = _batch(cfg, 2, 16, seed=1)
    leaves = pytree.leaves(pp)
    for p in leaves:
        p.requires_grad_(True)
    runs = []
    for remat, group in ((False, 1), (True, 1), (True, 2), (True, 3)):
        total, _ = T.loss_fn(pp, pb, cfg, remat=remat, remat_group=group)
        runs.append([total] + list(torch.autograd.grad(total, leaves)))
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


def test_remat_units():
    _, cfg = _cfgs("smollm-360m", num_layers=6)
    assert T._remat_unit(cfg, 1) == 1
    assert T._remat_unit(cfg, 3) == 3
    assert T._remat_unit(cfg, 4) == 1        # does not divide: per block
    _, g2 = _cfgs("gemma2-27b")
    assert T._remat_unit(g2, 4) == 2         # (local, global) pairs


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_loss_fn_gives_grads_for_ssm_and_hybrid(arch):
    """ssm and hybrid train (``ssd_scan``'s backward, ``ssd_scan_bwd``):
    under grad, with and without remat, ``loss_fn`` returns a loss whose
    gradient reaches every leaf, finite, the same bits either way (their
    values against the reference: ``test_torch_ssm_train.py``)."""
    _, cfg = _cfgs(arch)
    pp = T.init_params(cfg, torch.Generator().manual_seed(0))
    leaves = pytree.leaves(pp)
    for p in leaves:
        p.requires_grad_(True)
    _, pb = _batch(cfg, 1, 32)
    runs = []
    for remat in (False, True):
        total, _ = T.loss_fn(pp, pb, cfg, remat=remat)
        grads = torch.autograd.grad(total, leaves)
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        assert all(g.abs().max() > 0 for g in grads)
        runs.append([total] + list(grads))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ---------------------------------------------------------------------------
# optim
# ---------------------------------------------------------------------------
def _opt_tree(rng):
    return {"w": (rng.standard_normal((8, 16)) * 0.1).astype(np.float32),
            "blocks": {"ln": np.zeros(32, np.float32),
                       "wb": (rng.standard_normal((16, 4)) * 0.1).astype(
                           np.float32)}}


def test_adamw_matches_reference():
    """Five ``adamw_update`` steps on the same gradients (some clipped,
    some not) with f32 and bf16 leaves, under ``cosine_lr``: params, f32
    moments, step, grad norm and lr against the reference's."""
    rng = np.random.default_rng(4)
    base = _opt_tree(rng)

    def ref_leaf(path, a):
        return jnp.asarray(a, jnp.bfloat16 if path == ("blocks", "wb")
                           else jnp.float32)

    rp = {"w": ref_leaf(("w",), base["w"]),
          "blocks": {k: ref_leaf(("blocks", k), v)
                     for k, v in base["blocks"].items()}}
    pp = T.from_reference(jax.tree.map(np.asarray, rp))
    assert pp["blocks"]["wb"].dtype == torch.bfloat16
    rs, ps = RA.adamw_init(rp), PA.adamw_init(pp)
    rlr, plr = RA.cosine_lr(1e-2, 2, 5), PA.cosine_lr(1e-2, 2, 5)
    for step in range(5):
        scale = 10.0 if step % 2 else 0.01   # clipped, then not
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale)
                         .astype(np.float32), base)
        rg = jax.tree.map(jnp.asarray, g)
        pg = jax.tree.map(torch.from_numpy, g)
        rp, rs, rm = RA.adamw_update(rg, rs, rp, lr=rlr, clip_norm=1.0)
        pp, ps, pm = PA.adamw_update(pg, ps, pp, lr=plr, clip_norm=1.0)
        assert int(ps.step) == int(rs.step) == step + 1
        assert ps.step.dtype == torch.int32
        for k in ("grad_norm", "lr"):
            assert abs(float(pm[k]) - float(rm[k])) <= 1e-6 * abs(
                float(rm[k]))
        for key, rel in _leaf_rels(ps.m, rs.m) + _leaf_rels(ps.v, rs.v):
            assert rel <= 1e-6, (step, key, rel)
        for key, rel in _leaf_rels(pp, rp):
            tol = 2 ** -7 if "wb" in key else 1e-6
            assert rel <= tol, (step, key, rel)
        assert pp["blocks"]["wb"].dtype == torch.bfloat16


def test_cosine_lr_and_global_norm_match_reference():
    rlr, plr = RA.cosine_lr(3e-4, 10, 100), PA.cosine_lr(3e-4, 10, 100)
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        want = float(rlr(jnp.asarray(s, jnp.int32)))
        got = float(plr(torch.tensor(s, dtype=torch.int32)))
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-12)
    tree = _opt_tree(np.random.default_rng(9))
    want = float(RA.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(PA.global_norm(jax.tree.map(torch.from_numpy, tree)))
    assert abs(got - want) <= 1e-6 * want


def test_adamw_state_from_reference():
    rp, pp = _params(_cfgs("smollm-360m")[0])
    rs = RA.adamw_init(rp)
    rs = rs._replace(step=jnp.asarray(7, jnp.int32),
                     m=jax.tree.map(lambda a: a + 0.5, rs.m))
    ps = PA.from_reference(jax.tree.map(np.asarray, rs))
    assert isinstance(ps, PA.AdamWState) and int(ps.step) == 7
    assert [k for k, _ in pytree.flatten_with_path(ps)] == [
        jax.tree_util.keystr(p)
        for p, _ in jax.tree_util.tree_flatten_with_path(rs)[0]]
    assert float(ps.m["embed"][0, 0]) == 0.5


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    """Three ``make_train_step`` steps (remat on and off) against the
    reference's jitted step on the same data (``SyntheticPipeline``, the
    microbatched layout at 2): params, f32 moments and metrics after each
    step within 1e-4 of max|ref|. At the default schedule (lr 3e-4, 100
    warmup steps): AdamW scales a gradient element g by 1/(|g| + eps), so
    an element of |g| ~ eps = 1e-8 (1e-6 of this model's largest), whose
    f32 gradient differs in its leading digits between the packages, moves
    by up to lr_t in either; lr_t <= 9e-6 keeps that under the gate, and
    ``test_adamw_matches_reference`` holds the update at lr 1e-2 on equal
    gradients."""
    rcfg, cfg = _cfgs("smollm-360m", vocab_size=256)
    kw = dict(lr=3e-4, warmup=100, total_steps=1000,
              num_microbatches=microbatches)
    ref_step = jax.jit(ref_make_train_step(rcfg, remat=False, **kw))
    rpipe = RefPipeline(rcfg, 4, 16, microbatches=microbatches, seed=5)
    ppipe = SyntheticPipeline(cfg, 4, 16, microbatches=microbatches, seed=5,
                              device="cpu")
    rp0, _ = _params(rcfg, seed=1)
    rp, rs = rp0, RA.adamw_init(rp0)
    ref_hist = []
    for i in range(3):
        rp, rs, rm = ref_step(rp, rs, rpipe.batch_at(i))
        ref_hist.append((rp, rs, rm))
    for remat in (False, True):
        pp = T.from_reference(jax.tree.map(np.asarray, rp0))
        ps = PA.adamw_init(pp)
        step = make_train_step(cfg, remat=remat, **kw)
        ids = [id(p) for p in pytree.leaves(pp)]
        for i, (rp, rs, rm) in enumerate(ref_hist):
            pp, ps, pm = step(pp, ps, ppipe.batch_at(i))
            assert [id(p) for p in pytree.leaves(pp)] == ids   # in place
            for k in ("loss", "grad_norm", "lr"):
                assert abs(float(pm[k]) - float(rm[k])) <= 1e-4 * abs(
                    float(rm[k])), (i, k)
            for key, rel in (_leaf_rels(pp, rp) + _leaf_rels(ps.m, rs.m)
                             + _leaf_rels(ps.v, rs.v)):
                assert rel <= 1e-4, (remat, i, key, rel)
        for p, p0 in zip(pytree.leaves(pp), jax.tree.leaves(rp0)):
            assert not np.array_equal(_np(p), np.asarray(p0))    # moved


def test_microbatched_grads_equal_full_batch():
    """Two microbatches of 2 give the full batch of 4's gradient (the
    first moment after one step is (1 - b1) · the clipped gradient) and
    the mean of their losses."""
    _, cfg = _cfgs("smollm-360m", vocab_size=256)
    pipe = SyntheticPipeline(cfg, 4, 16, microbatches=2, seed=2,
                             device="cpu")
    mb = pipe.batch_at(0)
    full = {k: v.reshape(4, *v.shape[2:]) for k, v in mb.items()}
    outs = []
    for n, batch in ((2, mb), (1, full)):
        pp = T.init_params(cfg, torch.Generator().manual_seed(3))
        step = make_train_step(cfg, num_microbatches=n, remat=False)
        _, ps, m = step(pp, PA.adamw_init(pp), batch)
        outs.append((ps.m, m))
    (m2, met2), (m1, met1) = outs
    for a, b in zip(pytree.leaves(m2), pytree.leaves(m1)):
        assert _rel(_np(a), _np(b)) <= 1e-5
    assert abs(float(met2["loss"]) - float(met1["loss"])) <= 1e-5
