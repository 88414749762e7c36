"""Sharding rules: map every parameter, batch leaf and cache to a
PartitionSpec — the port of ``repro/models/sharding.py``, without jax.

The tables are the reference's: logical dimension kinds are resolved per
leaf from the parameter name, then mapped to mesh axes by a *strategy*
table. The baseline strategy is megatron-style tensor parallelism on the
``model`` axis plus FSDP (ZeRO-3-like) sharding of the other matrix
dimension over the batch axes; alternative strategies override single
kind→axis entries (e.g. expert-parallel MoE, ``{"exp": "model"}``).
Divisibility is checked per leaf: a dim that does not divide evenly over
its axes falls back to replication (smollm's 15 query heads, granite's
49155 vocab on a 16-way model axis).

A mesh here is its shape, a dict of axis name to size (``launch.mesh``):
one H100 is ``{"data": 1, "model": 1}``, and the tables for the reference's
16 x 16 and 2 x 16 x 16 TPU meshes are plain arithmetic over the same
shapes. ``PartitionSpec`` is a tuple of per-dim axes (None, a name, or a
tuple of names), the entries of jax's ``PartitionSpec``. The trees are
the port's pytrees (``repro_torch.pytree``): nested dicts and tuples whose
leaves carry ``.shape`` (tensors on any device, ``meta`` included), walked
by dict key as the reference walks ``DictKey``s. Applying specs to
devices (``to_named``) waits for a machine with several GPUs.

The reference's quirks are kept so the tables agree: ``prefill_cache_specs``
reads every mamba leaf with the ssm family's dim positions, so hybrid's
6-D (G, every, B, H, P, N) ssm state and 5-D (G, every, B, K-1, C) conv
states get specs from the wrong dims (zamba2 on a 16 x 16 mesh: its conv
states ``P(None, ...)``, its ssm state ``P(None, None, None, 'model')``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.pytree import _is_namedtuple, leaves

Axis = Any  # None | str | tuple[str, ...]


class PartitionSpec(tuple):
    """Per-dim mesh axes of one leaf, ``PartitionSpec(None, "model")``;
    equal to the tuple of its entries (``tuple(jax_spec)``). As jax
    normalizes them, a one-axis tuple entry is that axis and an empty one
    is None."""

    def __new__(cls, *axes: Axis) -> "PartitionSpec":
        return super().__new__(cls, tuple(
            (a[0] if len(a) == 1 else a or None)
            if isinstance(a, tuple) else a for a in axes))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


# name -> logical kinds of the trailing dims (leading stack dims padded None)
_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "embed": ("vocab", "dm"),
    "lm_head": ("dm", "vocab"),
    "wq": ("dm", "q_heads"),
    "wk": ("dm", "kv_heads"),
    "wv": ("dm", "kv_heads"),
    "wo": ("q_heads", "dm"),
    "q_norm": (None,),
    "k_norm": (None,),
    "ln1": (None,),
    "ln2": (None,),
    "final_norm": (None,),
    "router": ("dm", None),
    # dense mlp (2D) and moe experts (3D) share names; disambiguated by ndim
    "w_gate": ("dm", "ff"),
    "w_up": ("dm", "ff"),
    "w_down": ("ff", "dm"),
    "w_gate@moe": ("exp", "dm", "ff"),
    "w_up@moe": ("exp", "dm", "ff"),
    "w_down@moe": ("exp", "ff", "dm"),
    # mamba
    "in_x": ("dm", "inner"),
    "in_z": ("dm", "inner"),
    "in_B": ("dm", None),
    "in_C": ("dm", None),
    "in_dt": ("dm", "sheads"),
    "conv_x": (None, "inner"),
    "conv_B": (None, None),
    "conv_C": (None, None),
    "A_log": ("sheads",),
    "D": ("sheads",),
    "dt_bias": ("sheads",),
    "gate_norm": ("inner",),
    "out": ("inner", "dm"),
}


def default_strategy(
    *,
    fsdp_axes: Optional[Tuple[str, ...]] = ("data",),
    model_axis: str = "model",
) -> Dict[str, Axis]:
    return {
        "dm": fsdp_axes,
        "vocab": model_axis,
        "q_heads": model_axis,
        "kv_heads": model_axis,
        "ff": model_axis,
        "exp": None,
        "inner": model_axis,
        "sheads": model_axis,
    }


def _axis_size(mesh_shape: Dict[str, int], axis: Axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, str):
        return mesh_shape.get(axis, 1)
    return math.prod(mesh_shape.get(a, 1) for a in axis)


def _head_aligned(kind: Optional[str], cfg: ArchConfig, dim: int,
                  shards: int) -> bool:
    """Sharding must not split a head for head-structured dims."""
    if shards <= 1:
        return True
    if dim % shards != 0:
        return False
    heads = {
        "q_heads": cfg.num_heads,
        "kv_heads": cfg.num_kv_heads,
        "inner": cfg.ssm_heads if cfg.ssm_state else 0,
        "sheads": cfg.ssm_heads if cfg.ssm_state else 0,
    }.get(kind)
    if heads:
        return heads % shards == 0
    return True


def spec_for(
    name: str,
    shape: Tuple[int, ...],
    cfg: ArchConfig,
    mesh_shape: Dict[str, int],
    strategy: Dict[str, Axis],
    *,
    in_moe: bool = False,
) -> PartitionSpec:
    key = (f"{name}@moe" if in_moe and f"{name}@moe" in _RULES
           and len(shape) >= 3 else name)
    kinds = _RULES.get(key)
    if kinds is None:
        return P()
    pad = len(shape) - len(kinds)
    assert pad >= 0, (name, shape, kinds)
    axes: list[Axis] = [None] * pad
    for kind, dim in zip(kinds, shape[pad:]):
        ax = strategy.get(kind) if kind else None
        if ax is not None:
            size = _axis_size(mesh_shape, ax)
            if not _head_aligned(kind, cfg, dim, size):
                ax = None
        axes.append(ax)
    return P(*axes)


def _map_with_names(fn: Callable[[Tuple[str, ...], Any], Any],
                   tree: Any, names: Tuple[str, ...] = ()) -> Any:
    """``fn(dict keys on the path, leaf)`` over a pytree of dicts, tuples,
    lists and NamedTuples, in the same structure; ``None`` stays ``None``
    (the reference's ``tree_map_with_path`` keyed by ``DictKey``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_names(fn, v, names + (k,))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*[_map_with_names(fn, v, names) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_names(fn, v, names) for v in tree)
    return fn(names, tree)


def _shape(x) -> Tuple[int, ...]:
    return tuple(int(d) for d in x.shape)


def param_specs(
    params_shape: Any,
    cfg: ArchConfig,
    mesh_shape: Dict[str, int],
    strategy: Optional[Dict[str, Axis]] = None,
) -> Any:
    """PartitionSpec tree matching ``launch.specs.params_shape``'s tree."""
    strategy = strategy or default_strategy()

    def leaf(names, x):
        return spec_for(names[-1] if names else None, _shape(x), cfg,
                        mesh_shape, strategy, in_moe="moe" in names)

    return _map_with_names(leaf, params_shape)


# ---------------------------------------------------------------------------
# activations / batch / decode state
# ---------------------------------------------------------------------------
def batch_axes(mesh_shape: Dict[str, int]) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_shape)


def batch_specs(batch_shape: Any, mesh_shape: Dict[str, int], *,
                microbatched: bool = False) -> Any:
    """Batch dim sharded over the data axes. With ``microbatched`` the
    leaves are (n_micro, B/n_micro, ...) and the *second* dim is the batch
    dim."""
    db = batch_axes(mesh_shape)
    bdim = 1 if microbatched else 0

    def leaf(_, x):
        shape = _shape(x)
        ax = db if shape[bdim] % _axis_size(mesh_shape, db) == 0 else None
        axes = [None] * len(shape)
        axes[bdim] = ax
        return P(*axes)

    return _map_with_names(leaf, batch_shape)


def decode_state_specs(state_shape: Any, cfg: ArchConfig,
                       mesh_shape: Dict[str, int],
                       model_axis: str = "model") -> Any:
    """Decode caches: batch over data axes when divisible, else the
    sequence / window dim is sharded over (data×model) flash-decoding
    style."""
    db = batch_axes(mesh_shape)
    dsize = _axis_size(mesh_shape, db)
    msize = _axis_size(mesh_shape, model_axis)

    def leaf(names, x):
        name, shape = names[-1], _shape(x)
        if name in ("k_scale", "v_scale"):
            # (L, B, W, KV): shard like the int8 cache minus the head-dim
            _, B, W, KV = shape
            if B % dsize == 0 and dsize > 1:
                seq_ax = model_axis if W % msize == 0 else None
                return P(None, db, seq_ax, None)
            seq_shards = (*db, model_axis)
            if W % _axis_size(mesh_shape, seq_shards) == 0:
                return P(None, None, seq_shards, None)
            return P(None, None, None, None)
        if name in ("k", "v", "k_local", "v_local", "k_global", "v_global",
                    "shared_k", "shared_v"):
            # (L, B, W, KV, hd)
            _, B, W, KV, hd = shape
            if B % dsize == 0 and dsize > 1:
                seq_ax = model_axis if W % msize == 0 else None
                return P(None, db, seq_ax, None, None)
            seq_shards = (*db, model_axis)
            if W % _axis_size(mesh_shape, seq_shards) == 0:
                return P(None, None, seq_shards, None, None)
            return P(None, None, None, None, None)
        if name == "ssm":
            # (L|G[,every], B, H, P, N)
            B, H = shape[-4], shape[-3]
            bax = db if B % dsize == 0 and dsize > 1 else None
            hax = model_axis if H % msize == 0 else None
            return P(*([None] * (len(shape) - 4)), bax, hax, None, None)
        if name.startswith("conv_"):
            # (L[,every], B, K-1, C)
            B, C = shape[-3], shape[-1]
            bax = db if B % dsize == 0 and dsize > 1 else None
            cax = model_axis if C % msize == 0 else None
            return P(*([None] * (len(shape) - 3)), bax, None, cax)
        return P(*([None] * len(shape)))

    return _map_with_names(leaf, state_shape)


def prefill_cache_specs(cache_shape: Any, cfg: ArchConfig,
                        mesh_shape: Dict[str, int],
                        model_axis: str = "model") -> Any:
    """Specs for the cache tree of ``forward(collect_cache=True)``.

    KV leaves are (L, B, S, KV, hd); mamba conv states (L, B, K-1, C); ssm
    states (L, B, H, P, N). KV is sharded batch-over-data and
    seq-over-model (flash-decoding layout). Hybrid's (G, every, ...)
    mamba leaves are read at the same dim positions, as the reference
    reads them (the module docstring)."""
    db = batch_axes(mesh_shape)
    dsize = _axis_size(mesh_shape, db)
    msize = _axis_size(mesh_shape, model_axis)

    def leaf(names, x):
        shape = _shape(x)
        if names and names[0] == "mamba":
            if len(shape) == 5:  # ssm state (L,B,H,P,N)
                B, H = shape[1], shape[2]
                return P(None,
                         db if B % dsize == 0 and dsize > 1 else None,
                         model_axis if H % msize == 0 else None, None, None)
            # conv state (L,B,K-1,C)
            B, C = shape[1], shape[3]
            return P(None,
                     db if B % dsize == 0 and dsize > 1 else None,
                     None, model_axis if C % msize == 0 else None)
        # kv: (L, B, S, KV, hd)
        B, S = shape[1], shape[2]
        bax = db if B % dsize == 0 and dsize > 1 else None
        sax = model_axis if S % msize == 0 else None
        return P(None, bax, sax, None, None)

    return _map_with_names(leaf, cache_shape)


def constrain_batch(x):
    """The reference re-anchors the batch dim's sharding here inside a
    mesh; one card has no mesh, so ``x`` comes back unchanged, as the
    reference's does outside one."""
    return x


def per_device_bytes(shapes: Any, specs: Any,
                     mesh_shape: Dict[str, int]) -> int:
    """Bytes one device holds of the leaves of ``shapes`` (tensors with
    ``.shape`` and ``.dtype``) laid out by ``specs`` on a mesh of
    ``mesh_shape``: each dim divided by the size of its axes."""
    total = 0
    for x, spec in zip(leaves(shapes), _spec_leaves(specs)):
        n = x.element_size() if hasattr(x, "element_size") else 1
        for i, dim in enumerate(_shape(x)):
            ax = spec[i] if i < len(spec) else None
            n *= -(-dim // _axis_size(mesh_shape, ax))
        total += n
    return total


def _spec_leaves(specs: Any) -> list:
    """The PartitionSpecs of a spec tree in ``pytree.leaves``' order."""
    out = []

    def walk(t):
        if t is None:
            return
        if isinstance(t, PartitionSpec):
            out.append(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)

    walk(specs)
    return out
