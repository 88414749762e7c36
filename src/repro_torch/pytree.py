"""Pytrees of the port: nested dicts (and NamedTuples, lists, tuples) of
tensors, walked in JAX's order — dict keys sorted, NamedTuple fields and
sequence items in order — with JAX's ``keystr`` paths (``['blocks']['ln1']``
for dict keys, ``.m`` for NamedTuple fields, ``[0]`` for sequence items).
``None`` holds no leaf, as in JAX. The optimizer walks params, grads and
moments in this order, and ``checkpoint.io.save_pytree`` names and numbers
its files by it, so checkpoints of either package load in the other.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(t: Any) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def flatten_with_path(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(keystr, leaf)] in JAX's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_path(tree[k], f"{prefix}[{k!r}]")
        return out
    if _is_namedtuple(tree):
        out = []
        for f in tree._fields:
            out += flatten_with_path(getattr(tree, f), f"{prefix}.{f}")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, t in enumerate(tree):
            out += flatten_with_path(t, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like: Any, new_leaves: List[Any]) -> Any:
    """``like``'s structure with ``new_leaves`` (in JAX's order) as its
    leaves."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            done = {k: build(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*[build(getattr(t, f)) for f in t._fields])
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    cols = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("tree_map: trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def treedef_str(tree: Any) -> str:
    """The structure of ``tree`` with ``*`` for each leaf: the port's own
    ``treedef`` string (the reference's loader does not read it)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {treedef_str(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return (f"{type(tree).__name__}("
                + ", ".join(f"{f}={treedef_str(getattr(tree, f))}"
                            for f in tree._fields) + ")")
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(treedef_str(t) for t in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"
