"""The port's sharding tables (``models.sharding``), launch specs and
presets against the JAX package's, for all ten assigned archs at full
width. The reference's trees come from ``jax.eval_shape``; the port's are
tensors on the ``meta`` device (``launch.specs``), built without drawing a
weight. Tables are compared on the reference's 16 x 16 and 2 x 16 x 16
meshes and on one card's (1, 1), spec for spec (a spec is the tuple of
its per-dim axes), with the same leaf paths.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import INPUT_SHAPES as REF_SHAPES  # noqa: E402
from repro.configs.base import ShapeConfig as RefShapeConfig  # noqa: E402
from repro.launch import presets as RPRE  # noqa: E402
from repro.launch import specs as RS  # noqa: E402
from repro.models import sharding as RSH  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import presets as PRE  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.models import sharding as SH  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "1x1": {"data": 1, "model": 1}}
# the prefill cache's shape: a cut of prefill_32k's sequence (the tables
# read only B, S and the head dims; S stays a multiple of 16 and of every
# ssm chunk)
CACHE_SHAPE = ShapeConfig("prefill_cache", 1024, 32, "prefill")


@functools.lru_cache(maxsize=None)
def _ref_cfg(arch, shape_name="prefill_32k"):
    return RPRE.config_for(arch, shape_name)


@functools.lru_cache(maxsize=None)
def _cfg(arch, shape_name="prefill_32k"):
    return PRE.config_for(arch, shape_name)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return RS.params_shape(_ref_cfg(arch))


@functools.lru_cache(maxsize=None)
def _params(arch):
    return S.params_shape(_cfg(arch))


@functools.lru_cache(maxsize=None)
def _ref_cache(arch):
    cfg = _ref_cfg(arch)
    shape = RefShapeConfig("prefill_cache", CACHE_SHAPE.seq_len,
                           CACHE_SHAPE.global_batch, "prefill")

    def prefill(params, batch):
        return RT.forward(params, batch, cfg, collect_cache=True)[2][0]

    return jax.eval_shape(prefill, _ref_params(arch),
                          RS.input_specs(cfg, shape))


@functools.lru_cache(maxsize=None)
def _cache(arch):
    cfg = _cfg(arch)
    with torch.no_grad():
        return T.forward(_params(arch), S.input_specs(cfg, CACHE_SHAPE), cfg,
                         collect_cache=True)[2][0]


def _ref_flat(tree):
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, SH.PartitionSpec))[0]


def _same_specs(want, got):
    w, g = _ref_flat(want), _flat(got)
    assert [jax.tree_util.keystr(p) for p, _ in w] == \
        [jax.tree_util.keystr(p) for p, _ in g]
    for (path, a), (_, b) in zip(w, g):
        assert isinstance(b, SH.PartitionSpec), path
        assert tuple(a) == tuple(b), (jax.tree_util.keystr(path), a, b)


def _same_shapes(want, got):
    """The same paths, shapes and dtypes; the port's leaves on meta."""
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(p) for p, _ in w] == \
        [jax.tree_util.keystr(p) for p, _ in g]
    for (path, a), (_, b) in zip(w, g):
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype).replace("torch.", "") == str(a.dtype), path
        assert b.device.type == "meta", path


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_match_reference(arch, mesh):
    ms = MESHES[mesh]
    _same_specs(RSH.param_specs(_ref_params(arch), _ref_cfg(arch), ms),
                SH.param_specs(_params(arch), _cfg(arch), ms))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b",
                                  "smollm-360m", "zamba2-2.7b"])
def test_param_specs_under_an_expert_parallel_strategy(arch):
    """One strategy override, experts over ``model``: the same tables."""
    ms = MESHES["16x16"]
    ref = {**RSH.default_strategy(), "exp": "model"}
    port = {**SH.default_strategy(), "exp": "model"}
    assert ref == port
    want = RSH.param_specs(_ref_params(arch), _ref_cfg(arch), ms, ref)
    got = SH.param_specs(_params(arch), _cfg(arch), ms, port)
    _same_specs(want, got)
    cfg = _cfg(arch)
    if cfg.is_moe and cfg.num_experts % 16 == 0:
        assert got["blocks"]["moe"]["w_up"][1] == "model"


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_decode_state_specs_match_reference(arch, mesh, shape):
    ms, sc = MESHES[mesh], INPUT_SHAPES[shape]
    rcfg, cfg = _ref_cfg(arch, shape), _cfg(arch, shape)
    want = RS.decode_state_shape(rcfg, sc.global_batch, sc.seq_len)
    got = S.decode_state_shape(cfg, sc.global_batch, sc.seq_len)
    _same_shapes(want, got)
    _same_specs(RSH.decode_state_specs(want, rcfg, ms),
                SH.decode_state_specs(got, cfg, ms))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_prefill_cache_specs_match_reference(arch, mesh):
    """The reference's own tables, hybrid's quirk included (its 6-D ssm
    and 5-D conv leaves read at the ssm family's dim positions)."""
    ms = MESHES[mesh]
    want, got = _ref_cache(arch), _cache(arch)
    _same_shapes(want, got)
    _same_specs(RSH.prefill_cache_specs(want, _ref_cfg(arch), ms),
                SH.prefill_cache_specs(got, _cfg(arch), ms))


def test_prefill_cache_specs_keep_the_hybrid_quirk():
    """zamba2's 5-D conv states get ``P(None, ...)`` and its 6-D ssm state
    ``P(None, None, None, 'model')`` on 16 x 16, as the reference's do."""
    got = SH.prefill_cache_specs(_cache("zamba2-2.7b"),
                                 _cfg("zamba2-2.7b"), MESHES["16x16"])
    (cx, cB, cC), ssm = got["mamba"]
    assert tuple(ssm) == (None, None, None, "model")
    for c in (cx, cB, cC):
        assert len(c) == 5 and c[0] is None
    assert tuple(SH.P(None, (), ("data",))) == (None, None, "data")


@pytest.mark.parametrize("micro", [1, 16])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_batch_specs_match_reference(arch, mesh, micro):
    ms = MESHES[mesh]
    for name in INPUT_SHAPES:
        sc, rsc = INPUT_SHAPES[name], REF_SHAPES[name]
        m = micro if sc.kind == "train" else 1
        rb = RS.input_specs(_ref_cfg(arch, name), rsc, microbatches=m)
        b = S.input_specs(_cfg(arch, name), sc, microbatches=m)
        _same_shapes(rb, b)
        _same_specs(RSH.batch_specs(rb, ms, microbatched=m > 1),
                    SH.batch_specs(b, ms, microbatched=m > 1))


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_params_shape_matches_reference(arch):
    """``init_params``' tree on meta, shapes and dtypes of the
    reference's ``eval_shape``, nothing drawn."""
    _same_shapes(_ref_params(arch), _params(arch))


def test_presets_match_reference():
    assert PRE.TRAIN_MICROBATCHES == RPRE.TRAIN_MICROBATCHES
    assert PRE.TRAIN_REMAT_GROUP == RPRE.TRAIN_REMAT_GROUP
    assert PRE.NEEDS_SW_FOR_LONG == RPRE.NEEDS_SW_FOR_LONG
    for arch in ASSIGNED_ARCHS:
        for shape in INPUT_SHAPES:
            a, b = RPRE.config_for(arch, shape), PRE.config_for(arch, shape)
            assert (a.name, a.sliding_window, a.num_layers) == \
                (b.name, b.sliding_window, b.num_layers)


def test_meshes():
    assert M.make_production_mesh() == {"data": 16, "model": 16}
    assert M.make_production_mesh(multi_pod=True) == {
        "pod": 2, "data": 16, "model": 16}
    assert M.make_host_mesh(device="cpu") == {"data": 1, "model": 1}
    assert M.mesh_shape_dict(M.make_host_mesh(device="meta")) == \
        MESHES["1x1"]
    assert (M.PEAK_FLOPS_BF16, M.PEAK_FLOPS_F32, M.HBM_BW) == \
        (989e12, 67e12, 3.35e12)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            M.make_host_mesh()


# twins of tests/test_substrates.py's sharding tests
def test_param_specs_divisibility_fallback():
    cfg = _cfg("smollm-360m")  # 15 heads, 5 kv heads: not 16-divisible
    specs = SH.param_specs(_params("smollm-360m"), cfg,
                           {"data": 16, "model": 16}, SH.default_strategy())
    assert specs["blocks"]["attn"]["wq"][-1] is None
    assert specs["blocks"]["mlp"]["w_gate"][-1] == "model"
    assert specs["embed"][0] == "model"


def test_param_specs_structure_matches_params():
    for arch in ["qwen3-moe-30b-a3b", "mamba2-2.7b", "zamba2-2.7b"]:
        cfg = _cfg(arch)
        params = _params(arch)
        specs = SH.param_specs(params, cfg, {"data": 16, "model": 16})
        leaves = jax.tree_util.tree_leaves(params)
        spec_leaves = jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, SH.PartitionSpec))
        assert len(leaves) == len(spec_leaves)
        for leaf, spec in zip(leaves, spec_leaves):
            assert len(spec) <= len(leaf.shape), (leaf.shape, spec)


def test_per_device_bytes_divides_each_dim():
    x = torch.empty((4, 48, 100), dtype=torch.bfloat16, device="meta")
    spec = SH.P(None, ("pod", "data"), "model")
    assert SH.per_device_bytes(
        {"x": x}, {"x": spec}, {"pod": 2, "data": 16, "model": 16}) == \
        2 * 4 * 2 * int(np.ceil(100 / 16))


def test_constrain_batch_is_the_identity():
    x = torch.zeros(4, 3)
    assert SH.constrain_batch(x) is x
