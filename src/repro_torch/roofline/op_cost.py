"""A step's cost counted op by op as it runs — the counterpart of
``repro/roofline/hlo_cost.py``, which walks a compiled program's HLO.

``OpCounter`` is a ``TorchDispatchMode``: every aten op that runs inside
it, on meta, CPU or CUDA tensors, is counted when it is dispatched, so the
count needs no compiled program and no trip counts (a Python loop over
layers runs each layer's ops once). The rules are ``hlo_cost``'s:

  flops        : 2·|out|·K for ``mm``, ``bmm``, ``addmm``, ``baddbmm``,
                 ``mv`` and ``dot`` (K the contracted extent; ``linear``
                 and ``matmul`` reach the mode as these), 2·|out|·(C_in /
                 groups · the window) for convolutions, |out| for
                 elementwise ops (``pointwise``), reductions and casts;
                 transcendentals (exp, log, tanh, sigmoid, sqrt, rsqrt,
                 pow, silu, softplus, ...) also counted apart;
  hbm bytes    : the operands plus the results of each op, each tensor by
                 the elements its strides reach (an expanded operand
                 counts once); gathers (``embedding``, ``index``) count
                 their result twice and the indices, scatters (and
                 ``index_copy_``, a decode step's ring write at a device
                 index) three times their update and the indices, as
                 ``hlo_cost`` counts slicing ops; view
                 ops (``view``, ``reshape`` without a copy, ``transpose``,
                 ``expand``, ``slice``, ``select``, ...) and allocations
                 cost nothing, as ``bitcast`` and ``get-tuple-element``
                 do there;
  kernels      : a hand-written kernel's wrapper reports its own cost
                 (``kernels._native.costed``: the FLOPs of its function,
                 each input read once and each output written once), which
                 stands for everything inside it; the aten ops it issues
                 (its plain version on the CPU, its outputs and scratch on
                 the card) are not counted again, as ``hlo_cost`` does not
                 count a fusion's internals; where a plain version
                 returns a strided result on the CPU, the copy that makes
                 it contiguous (``clone``, as ``reshape`` or
                 ``contiguous`` issue it) costs nothing: the kernel writes
                 that output contiguous, and the card runs no such copy;
  peak memory  : the high-water mark of live storage bytes: each output
                 storage counts once, from the op that creates it until it
                 is freed (a weak reference to the storage), plus the
                 storages ``track``ed before the step (its arguments).

So a meta dry run and a CPU or CUDA run of the same step count the same
FLOPs and bytes. ``f32_carry_artifact_bytes`` has no counterpart: it
subtracts XLA-on-CPU copies of bf16 loop carries from a compiled CPU
program's memory, and no compiler stands between this count and the
step. One card has no collectives, so nothing here counts wire bytes.
"""
from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import _native
from repro_torch.pytree import leaves

_MATMULS = {"mm", "bmm", "addmm", "baddbmm", "mv", "dot"}
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log2", "log1p", "tanh", "sigmoid",
    "sqrt", "rsqrt", "pow", "sin", "cos", "silu", "softplus", "erf", "gelu",
    "_softmax", "_log_softmax", "logsumexp", "tanh_backward",
    "sigmoid_backward", "silu_backward", "softplus_backward",
}
# not tagged pointwise or reduction in aten, but elementwise or reducing
_ELEMENTWISE = {
    "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "cumsum", "cumprod", "sort", "topk",
    "argsort", "logsumexp",
}
_GATHERS = {"embedding", "index", "index_select", "gather"}
_SCATTERS = {"index_add", "index_add_", "index_put", "index_put_",
             "scatter", "scatter_", "scatter_add", "scatter_add_",
             "embedding_dense_backward", "index_copy", "index_copy_"}
# scatters whose update is the argument at this position, whatever its
# dtype: a decode step's ring write at a device index (``index_copy_`` of
# a bf16, f32 or int8 cache entry), ``hlo_cost``'s dynamic-update-slice
_UPDATE_ARG = {"index_copy": 3, "index_copy_": 3}
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_local_scalar_dense", "lift_fresh",
         "set_", "resize_", "record_stream"}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t``'s strides reach: a dim of stride 0
    (``expand``) is read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree, out=None) -> List[torch.Tensor]:
    """The tensors of an op's arguments or results (tuples, lists and
    dicts of them); a walk of its own, cheaper than a general pytree
    flatten on every op."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            _tensors(t, out)
    elif isinstance(tree, dict):
        for t in tree.values():
            _tensors(t, out)
    return out


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _layout(t: torch.Tensor) -> Tuple:
    return t.storage_offset(), tuple(t.shape), t.stride()


@dataclass
class OpCost:
    """Totals of one counted step (per device: one card)."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    transcendentals: float = 0.0
    flop_contrib: Dict[str, float] = field(default_factory=dict)
    hbm_contrib: Dict[str, float] = field(default_factory=dict)
    kernels: Dict[str, List[float]] = field(default_factory=dict)
    ops: int = 0
    arg_bytes: float = 0.0
    peak_bytes: float = 0.0

    def top_hbm(self, n=10):
        return sorted(self.hbm_contrib.items(), key=lambda kv: -kv[1])[:n]

    def top_flops(self, n=10):
        return sorted(self.flop_contrib.items(), key=lambda kv: -kv[1])[:n]

    def add(self, key: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.hbm_bytes += nbytes
        if flops:
            self.flop_contrib[key] = self.flop_contrib.get(key, 0.0) + flops
        if nbytes:
            self.hbm_contrib[key] = self.hbm_contrib.get(key, 0.0) + nbytes

    def totals(self) -> Tuple[float, float, float]:
        return self.flops, self.hbm_bytes, self.transcendentals


class OpCounter(TorchDispatchMode):
    """Counts the aten ops and kernel calls that run while it is entered
    (``with OpCounter() as c: step(...)``; ``c.cost`` holds the totals).
    ``track(tree)`` adds the storages of a tree's tensors (the step's
    arguments) to the live bytes before the step runs."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self._live: Dict[int, Tuple[weakref.ref, int]] = {}
        self._live_bytes = 0
        # storage -> the (offset, shape, strides) of the strided CPU
        # outputs of kernel wrappers on it
        self._strided: Dict[int, set] = {}
        # re-entrant: a storage freed by the garbage collector while an
        # op's outputs are being held calls back into _freed
        self._lock = threading.RLock()

    # -- memory ----------------------------------------------------------
    def _freed(self, key: int) -> None:
        with self._lock:
            entry = self._live.pop(key, None)
            self._strided.pop(key, None)
            if entry is not None:
                self._live_bytes -= entry[1]

    def _hold(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = s._cdata
        with self._lock:
            if key in self._live:
                return
            nbytes = s.nbytes()
            self._live[key] = (weakref.ref(
                s, lambda _, key=key: self._freed(key)), nbytes)
            self._live_bytes += nbytes
            self.cost.peak_bytes = max(self.cost.peak_bytes,
                                       self._live_bytes)

    def track(self, tree: Any) -> None:
        """Count the storages of ``tree``'s tensors as live (each storage
        once) and as the step's argument bytes."""
        before = self._live_bytes
        for t in leaves(tree):
            if isinstance(t, torch.Tensor):
                self._hold(t)
        self.cost.arg_bytes += self._live_bytes - before

    # -- kernels ---------------------------------------------------------
    def _kernel(self, name: str, flops: float, nbytes: float,
                out: Any) -> None:
        with self._lock:
            for t in _tensors(out):
                if t.device.type == "cpu" and not t.is_contiguous():
                    self._strided.setdefault(_storage_key(t), set()).add(
                        _layout(t))
            self.cost.add(f"kernel {name}", flops, nbytes)
            k = self.cost.kernels.setdefault(name, [0, 0.0, 0.0])
            k[0] += 1
            k[1] += flops
            k[2] += nbytes

    def __enter__(self):
        _native.cost_sinks.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _native.cost_sinks.remove(self._kernel)

    # -- aten ops --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self._hold(t)
        if not _native.inside_kernel():
            self._count(func, args, kwargs, outs)
        return out

    def _count(self, func, args, kwargs, outs) -> None:
        name, kind, may_alias, transcendental = _classify(func)
        if kind == "free" or not outs:
            return
        ins = _tensors((args, kwargs))
        if (name == "clone" and self._strided and outs[0].is_contiguous()
                and _layout(ins[0]) in self._strided.get(
                    _storage_key(ins[0]), ())):
            return  # the kernel's output is contiguous already
        if may_alias:
            keys = {_storage_key(t) for t in ins}
            if all(_storage_key(t) in keys for t in outs):
                return  # a view: no traffic
        out_elems = sum(t.numel() for t in outs)
        out_b = sum(tensor_bytes(t) for t in outs)
        if kind == "gather":
            idx = [t for t in ins if not t.is_floating_point()]
            nbytes = 2 * out_b + sum(tensor_bytes(t) for t in idx)
        elif kind == "scatter":
            if name in _UPDATE_ARG:
                upd = [args[_UPDATE_ARG[name]]]
                idx = [t for t in ins[1:] if t is not upd[0]]
            else:
                upd = [t for t in ins[1:] if t.is_floating_point()]
                idx = [t for t in ins[1:] if not t.is_floating_point()]
            nbytes = (3 * sum(tensor_bytes(t) for t in upd)
                      + sum(tensor_bytes(t) for t in idx))
        else:
            nbytes = out_b + sum(tensor_bytes(t) for t in ins)
        flops = 0.0
        if kind == "matmul":
            a = args[1] if name in ("addmm", "baddbmm") else args[0]
            flops = 2.0 * out_elems * a.shape[-1]
        elif kind == "conv":
            w = args[1]
            flops = 2.0 * out_elems * (w.numel() // max(w.shape[0], 1))
        elif kind == "elementwise" or (
                kind == "cast" and ins and outs[0].dtype != ins[0].dtype):
            flops = float(out_elems)
        with self._lock:
            self.cost.ops += 1
            if transcendental:
                self.cost.transcendentals += out_elems
            self.cost.add(f"{name} {outs[0].dtype}".replace("torch.", ""),
                          flops, nbytes)


# op overload -> (name, kind, may alias an input, transcendental)
_CLASSES: Dict[Any, Tuple[str, str, bool, bool]] = {}


def _classify(func) -> Tuple[str, str, bool, bool]:
    """How ``_count`` treats an op, from its name, tags and schema, once
    an overload. An op that writes none of its arguments and whose schema
    lets a result alias an input (view ops, ``detach``, ``alias``; and
    ``_unsafe_view``) costs nothing where its results share an input's
    storage."""
    info = _CLASSES.get(func)
    if info is None:
        name = func.overloadpacket.__name__
        schema = func._schema
        writes = any(a.alias_info is not None and a.alias_info.is_write
                     for a in schema.arguments)
        may_alias = not writes and (
            name == "_unsafe_view"
            or any(r.alias_info is not None for r in schema.returns))
        if name in _FREE:
            kind = "free"
        elif name in _MATMULS:
            kind = "matmul"
        elif name == "convolution":
            kind = "conv"
        elif name in _GATHERS:
            kind = "gather"
        elif name in _SCATTERS:
            kind = "scatter"
        elif name == "_to_copy":
            kind = "cast"
        elif (name in _ELEMENTWISE or torch.Tag.pointwise in func.tags
              or torch.Tag.reduction in func.tags):
            kind = "elementwise"
        else:
            kind = "move"
        info = (name, kind, may_alias, name in _TRANSCENDENTAL)
        _CLASSES[func] = info
    return info
