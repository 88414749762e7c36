"""CNN model zoo for the paper-faithful experiments (Table 4 models).

The port of ``repro/models/cnn.py``: the same scaled CNN chains expressed
as ColdEngine layer graphs (conv2d / linear / stateless units). Weights
come from ``np.random.default_rng(seed)`` in the same draw order, so a
model built here is bit-identical to the JAX package's for the same
arguments; the stateless units are torch functions on NHWC tensors.
``from_reference`` converts a layer list built by the JAX package.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.engine import LayerDef
from repro_torch.core.registry import LayerSpec


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2/s2 VALID max pool on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1) \
        .contiguous()


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x, dim=(1, 2))


# stateless unit kind -> torch fn; the kind is read from the unit's name
STATELESS_FNS: Dict[str, Callable] = {
    "relu": relu, "pool": max_pool2, "gap": global_avg_pool,
}


def stateless_kind(name: str) -> str:
    if name.endswith("_gap"):
        return "gap"
    if "pool" in name:
        return "pool"
    if "relu" in name:
        return "relu"
    raise KeyError(f"no stateless fn for unit {name!r}")


def _conv(name, cin, cout, k, stride, rng) -> LayerDef:
    w = (rng.standard_normal((cout, cin, k, k)) / np.sqrt(cin * k * k)).astype(np.float32)
    b = np.zeros((cout,), np.float32)
    return LayerDef(
        spec=LayerSpec(
            name=name, op_type="conv2d",
            config={"kernel": k, "stride": stride, "padding": "SAME",
                    "in_channels": cin, "out_channels": cout},
            weight_shapes={"w": w.shape, "b": b.shape},
        ),
        weights={"w": w, "b": b},
    )


def _relu(name) -> LayerDef:
    return LayerDef(spec=LayerSpec(name=name, op_type="stateless"), fn=relu)


def _gap_linear(name, cin, classes, rng) -> List[LayerDef]:
    gap = LayerDef(
        spec=LayerSpec(name=f"{name}_gap", op_type="stateless"),
        fn=global_avg_pool,
    )
    w = (rng.standard_normal((cin, classes)) / np.sqrt(cin)).astype(np.float32)
    b = np.zeros((classes,), np.float32)
    fc = LayerDef(
        spec=LayerSpec(
            name=f"{name}_fc", op_type="linear",
            config={"in_features": cin, "out_features": classes},
            weight_shapes={"w": w.shape, "b": b.shape},
        ),
        weights={"w": w, "b": b},
    )
    return [gap, fc]


def build_cnn(name: str, *, image: int = 64, classes: int = 100,
              width: float = 1.0, seed: int = 0) -> Tuple[List[LayerDef], np.ndarray]:
    """Returns (layers, example_input NHWC)."""
    rng = np.random.default_rng(seed)
    W = lambda c: max(8, int(c * width))
    layers: List[LayerDef] = []

    if name in ("resnet18", "resnet50"):
        depths = {"resnet18": [2, 2, 2], "resnet50": [3, 4, 5]}[name]
        chans = [W(64), W(128), W(256)]
        layers.append(_conv("stem", 3, chans[0], 3, 1, rng))
        layers.append(_relu("stem_relu"))
        cin = chans[0]
        for si, (d, c) in enumerate(zip(depths, chans)):
            for bi in range(d):
                stride = 2 if (bi == 0 and si > 0) else 1
                layers.append(_conv(f"s{si}b{bi}_conv1", cin, c, 3, stride, rng))
                layers.append(_relu(f"s{si}b{bi}_relu1"))
                layers.append(_conv(f"s{si}b{bi}_conv2", c, c, 3, 1, rng))
                layers.append(_relu(f"s{si}b{bi}_relu2"))
                cin = c
        layers += _gap_linear("head", cin, classes, rng)
    elif name == "mobilenet":
        cfg = [(W(32), 1), (W(64), 1), (W(128), 2), (W(128), 1), (W(256), 2)]
        cin = 3
        for i, (c, s) in enumerate(cfg):
            layers.append(_conv(f"conv{i}", cin, c, 3, s, rng))
            layers.append(_relu(f"relu{i}"))
            cin = c
        layers += _gap_linear("head", cin, classes, rng)
    elif name == "squeezenet":
        layers.append(_conv("stem", 3, W(64), 3, 2, rng))
        layers.append(_relu("stem_relu"))
        cin = W(64)
        for i, c in enumerate([W(64), W(128), W(128)]):
            layers.append(_conv(f"squeeze{i}", cin, max(8, c // 4), 1, 1, rng))
            layers.append(_relu(f"srelu{i}"))
            layers.append(_conv(f"expand{i}", max(8, c // 4), c, 3, 1, rng))
            layers.append(_relu(f"erelu{i}"))
            cin = c
        layers += _gap_linear("head", cin, classes, rng)
    elif name == "alexnet":
        specs = [(W(64), 5, 2), (W(192), 3, 2), (W(384), 3, 1),
                 (W(256), 3, 1), (W(256), 3, 1)]
        cin = 3
        for i, (c, k, s) in enumerate(specs):
            layers.append(_conv(f"conv{i}", cin, c, min(k, 3) if k > 3 else k, s, rng))
            layers.append(_relu(f"relu{i}"))
            cin = c
        layers += _gap_linear("head", cin, classes, rng)
    else:
        raise KeyError(name)

    x = rng.standard_normal((1, image, image, 3)).astype(np.float32)
    return layers, x


CNN_NAMES = ["resnet18", "resnet50", "mobilenet", "squeezenet", "alexnet"]


def from_reference(ref_layers: Sequence[Any]) -> List[LayerDef]:
    """The port's layer list for a JAX-package ``List[LayerDef]``: the same
    ``LayerSpec`` fields, the same numpy weights, and each stateless unit
    mapped by its name to the port's torch fn (relu, max-pool, GAP)."""
    out: List[LayerDef] = []
    for l in ref_layers:
        s = l.spec
        spec = LayerSpec(name=s.name, op_type=s.op_type,
                         config=dict(s.config),
                         weight_shapes={k: tuple(v)
                                        for k, v in s.weight_shapes.items()})
        fn = (STATELESS_FNS[stateless_kind(s.name)]
              if s.op_type == "stateless" else None)
        out.append(LayerDef(spec=spec,
                            weights={k: np.asarray(v)
                                     for k, v in l.weights.items()},
                            fn=fn))
    return out
