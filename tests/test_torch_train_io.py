"""The port's training data, checkpoints and launcher (``data.
SyntheticPipeline``, ``checkpoint.save_pytree``/``load_pytree``,
``launch.train``) against the JAX package's, on the CPU at small size
(reduced configs). The pipeline's bytes and the checkpoints' files and
leaves are compared bitwise; checkpoints cross the packages in both
directions.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import load_pytree as ref_load_pytree  # noqa: E402
from repro.checkpoint import save_pytree as ref_save_pytree  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data import SyntheticPipeline as RefPipeline  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.optim import adamw as RA  # noqa: E402
from repro_torch import optim as PA  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.checkpoint import load_pytree, save_pytree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticPipeline  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

torch.set_num_threads(1)


def _cfgs(arch, **over):
    over.setdefault("dtype", "float32")
    return ref_get_config(arch).reduced(**over), \
        get_config(arch).reduced(**over)


def _params(rcfg, seed=0):
    """(the reference's params, the port's copy of them)."""
    rp = RT.init_params(jax.random.PRNGKey(seed), rcfg)
    return rp, T.from_reference(jax.tree.map(np.asarray, rp))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,microbatches", [
    ("smollm-360m", 1), ("smollm-360m", 2), ("musicgen-medium", 2),
    ("internvl2-76b", 1)])
def test_pipeline_bytes_equal_reference(arch, microbatches):
    """``batch_at`` gives the reference's bytes: tokens and labels int32,
    embeddings rounded to the config dtype (bf16 here), in the
    microbatched layout."""
    rcfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    assert cfg.dtype == "bfloat16"
    rb = RefPipeline(rcfg, 4, 24, microbatches=microbatches,
                     seed=3).batch_at(7)
    pb = SyntheticPipeline(cfg, 4, 24, microbatches=microbatches, seed=3,
                           device="cpu").batch_at(7)
    assert sorted(rb) == sorted(pb)
    for k in rb:
        r = np.asarray(rb[k])
        p = pb[k]
        assert tuple(p.shape) == r.shape
        if p.dtype == torch.bfloat16:
            assert np.array_equal(p.view(torch.int16).numpy(),
                                  r.view(np.int16))
        else:
            assert p.dtype == torch.int32 and np.array_equal(p.numpy(), r)


def test_pipeline_default_device_is_the_card():
    _, cfg = _cfgs("smollm-360m")
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        SyntheticPipeline(cfg, 2, 8)


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------
def _ckpt_trees():
    """(the reference's params and AdamW state, the port's copy)."""
    rcfg, _ = _cfgs("smollm-360m", dtype="bfloat16")
    rp, pp = _params(rcfg, seed=2)
    rs = RA.adamw_init(rp)
    rs = rs._replace(step=jnp.asarray(3, jnp.int32),
                     m=jax.tree.map(lambda a: a + 0.25, rs.m))
    return (rp, rs), (pp, PA.from_reference(jax.tree.map(np.asarray, rs)))


def _assert_trees_equal(port_tree, ref_tree):
    ref = jax.tree.leaves(ref_tree)
    got = pytree.leaves(port_tree)
    assert len(ref) == len(got)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        if g.dtype == torch.bfloat16:
            assert np.array_equal(g.view(torch.int16).numpy(),
                                  r.view(np.int16))
        else:
            assert np.array_equal(g.numpy(), r) and str(g.dtype)[6:] == \
                str(r.dtype)


def test_checkpoint_port_to_reference_and_back(tmp_path):
    """The port's ``save_pytree`` of params and AdamW state writes the
    reference's ``index.json`` leaves and files; the reference's
    ``load_pytree`` reads them back bitwise, and so does the port's."""
    (rp, rs), (pp, ps) = _ckpt_trees()
    save_pytree(tmp_path / "port", (pp, ps))
    ref_save_pytree(tmp_path / "ref", (rp, rs))
    port_idx = json.loads((tmp_path / "port" / "index.json").read_text())
    ref_idx = json.loads((tmp_path / "ref" / "index.json").read_text())
    assert port_idx["leaves"] == ref_idx["leaves"]
    assert any(e["dtype"] == "bfloat16" for e in port_idx["leaves"])
    for e in ref_idx["leaves"]:
        assert np.array_equal(np.load(tmp_path / "port" / e["file"]),
                              np.load(tmp_path / "ref" / e["file"]))
    back_ref = ref_load_pytree(tmp_path / "port", (rp, rs))
    _assert_trees_equal((pp, ps), back_ref)
    back = load_pytree(tmp_path / "port", (pp, ps))
    _assert_trees_equal(back, (rp, rs))
    assert isinstance(back[1], PA.AdamWState)


def test_checkpoint_reference_to_port(tmp_path):
    (rp, rs), (pp, ps) = _ckpt_trees()
    ref_save_pytree(tmp_path / "ref", {"params": rp, "opt": rs})
    like = {"params": pytree.tree_map(torch.zeros_like, pp),
            "opt": pytree.tree_map(torch.zeros_like, ps)}
    back = load_pytree(tmp_path / "ref", like)
    _assert_trees_equal(back, {"params": rp, "opt": rs})
    assert back["params"]["embed"].dtype == torch.bfloat16


def test_checkpoint_bf16_numpy_leaf_and_structured_dtype(tmp_path):
    """A bf16 leaf as the port's numpy bit patterns round-trips like a
    tensor; a structured dtype raises ``TypeError``; a tree of another size
    is refused."""
    from repro_torch import bf16

    vals = torch.randn(4, 5).to(torch.bfloat16)
    save_pytree(tmp_path / "a", {"w": bf16.to_numpy(vals)})
    back = load_pytree(tmp_path / "a", {"w": torch.zeros(4, 5,
                                                         dtype=torch.bfloat16)})
    assert torch.equal(back["w"], vals)
    idx = json.loads((tmp_path / "a" / "index.json").read_text())
    assert idx["leaves"] == [{"key": "['w']", "file": "leaf_00000.npy",
                              "dtype": "bfloat16"}]
    bad = np.zeros(3, dtype=np.dtype([("a", np.int32), ("b", np.float32)]))
    with pytest.raises(TypeError, match="unsupported dtype"):
        save_pytree(tmp_path / "b", {"bad": bad})
    with pytest.raises(ValueError):
        load_pytree(tmp_path / "a", {"w": vals, "x": vals})


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_launch_train_on_cpu(capsys, tmp_path):
    """``python -m repro_torch.launch.train --device cpu --reduced --steps
    5`` trains with a falling loss and writes a checkpoint the port loads;
    the default device (the card) raises without one."""
    from repro_torch.launch import train as LT

    final = LT.main(["--device", "cpu", "--reduced", "--steps", "5",
                     "--batch", "4", "--seq", "64", "--lr", "3e-3",
                     "--ckpt-every", "5", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    losses = [float(l.split()[3]) for l in out.splitlines()
              if l.startswith("step")]
    assert len(losses) == 5 and losses[-1] == pytest.approx(final, abs=1e-4)
    assert losses[-1] < losses[0]
    assert (tmp_path / "step_5" / "index.json").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            LT.main(["--reduced", "--steps", "1"])
