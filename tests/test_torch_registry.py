"""The port's registry (repro_torch.core.registry) against the JAX package's,
kernel by kernel, on the CPU.

For every lossless registry kernel: ``transform`` gives the same bytes,
``execute`` gives the same output (atol=1e-4, f32), and the shape-class keys
hash identically — on odd and even spatial sizes, stride 1 and 2 (SAME
padding is asymmetric in XLA at stride 2), and K not a multiple of 128.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import registry as RR
from repro_torch.core import registry as PR

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would oversubscribe the host
torch.set_num_threads(1)


def _rng(*key):
    return np.random.default_rng(list(key))


def _specs(mod, spec_args):
    return mod.LayerSpec(*spec_args)


def _pair(kernel_name):
    return getattr(RR, kernel_name)(), getattr(PR, kernel_name)()


def _check(kernel_name, spec_args, raw, x, atol=1e-4):
    rk, pk = _pair(kernel_name)
    rspec, pspec = _specs(RR, spec_args), _specs(PR, spec_args)
    assert rk.name == pk.name and rk.supports(rspec) == pk.supports(pspec)
    rt, pt = rk.transform(raw, rspec), pk.transform(raw, pspec)
    assert sorted(rt) == sorted(pt)
    for k in rt:
        assert rt[k].dtype == pt[k].dtype and rt[k].shape == pt[k].shape
        assert np.asarray(rt[k]).tobytes() == np.asarray(pt[k]).tobytes()
    want = np.asarray(rk.execute({k: jnp.asarray(v) for k, v in rt.items()},
                                 jnp.asarray(x), rspec))
    got = pk.execute({k: torch.from_numpy(np.array(v)) for k, v in pt.items()},
                     torch.from_numpy(x), pspec)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=1e-4)


CONV_CASES = [  # (H, W, stride): odd/even sizes, both strides
    (9, 7, 1), (10, 11, 1), (8, 8, 2), (9, 7, 2), (5, 6, 2),
]


@pytest.mark.parametrize("kernel", ["ConvDirect", "ConvIm2col"])
@pytest.mark.parametrize("H,W,stride", CONV_CASES)
def test_conv_kernels_match_reference(kernel, H, W, stride):
    rng = _rng(1, H, W, stride)
    O, I = 12, 5
    spec_args = ("c", "conv2d",
                 {"kernel": 3, "stride": stride, "padding": "SAME"},
                 {"w": (O, I, 3, 3), "b": (O,)})
    raw = {"w": rng.standard_normal((O, I, 3, 3)).astype(np.float32),
           "b": rng.standard_normal(O).astype(np.float32)}
    x = rng.standard_normal((2, H, W, I)).astype(np.float32)
    _check(kernel, spec_args, raw, x)


@pytest.mark.parametrize("H,W", [(9, 7), (10, 11), (1, 1), (16, 16)])
def test_winograd_matches_reference(H, W):
    rng = _rng(2, H, W)
    O, I = 9, 6
    spec_args = ("c", "conv2d", {"kernel": 3, "stride": 1, "padding": "SAME"},
                 {"w": (O, I, 3, 3), "b": (O,)})
    raw = {"w": rng.standard_normal((O, I, 3, 3)).astype(np.float32),
           "b": rng.standard_normal(O).astype(np.float32)}
    x = rng.standard_normal((2, H, W, I)).astype(np.float32)
    _check("ConvWinograd", spec_args, raw, x)


def test_winograd_refuses_stride2_and_1x1():
    for cfg in ({"kernel": 3, "stride": 2}, {"kernel": 1, "stride": 1}):
        spec = PR.LayerSpec("c", "conv2d", cfg, {"w": (4, 4, 3, 3)})
        assert not PR.ConvWinograd().supports(spec)
        assert not RR.ConvWinograd().supports(
            RR.LayerSpec("c", "conv2d", cfg, {"w": (4, 4, 3, 3)}))


def test_conv_1x1_and_valid_padding():
    rng = _rng(3)
    raw = {"w": rng.standard_normal((7, 4, 1, 1)).astype(np.float32)}
    x = rng.standard_normal((1, 5, 6, 4)).astype(np.float32)
    for kernel in ("ConvDirect", "ConvIm2col"):
        _check(kernel, ("c", "conv2d", {"kernel": 1, "stride": 1}, {"w": (7, 4, 1, 1)}),
               raw, x)
    raw3 = {"w": rng.standard_normal((3, 4, 3, 3)).astype(np.float32)}
    for kernel in ("ConvDirect", "ConvIm2col"):
        _check(kernel, ("c", "conv2d",
                        {"kernel": 3, "stride": 2, "padding": "VALID"},
                        {"w": (3, 4, 3, 3)}), raw3, x)


@pytest.mark.parametrize("kernel", ["LinearDirect", "LinearPacked"])
@pytest.mark.parametrize("lead,K,N", [((4,), 70, 33), ((2, 3), 300, 150),
                                      ((1,), 256, 100), ((5,), 128, 128)])
def test_linear_kernels_match_reference(kernel, lead, K, N):
    rng = _rng(4, K, N, len(lead))
    spec_args = ("l", "linear", {"in_features": K, "out_features": N},
                 {"w": (K, N), "b": (N,)})
    raw = {"w": rng.standard_normal((K, N)).astype(np.float32),
           "b": rng.standard_normal(N).astype(np.float32)}
    x = rng.standard_normal((*lead, K)).astype(np.float32)
    _check(kernel, spec_args, raw, x)


def test_registry_names_and_order_match():
    for op in ("linear", "conv2d"):
        assert ([type(k).__name__ for k in PR.registry_for(op)]
                == [type(k).__name__ for k in RR.registry_for(op)])
        assert ([k.name for k in PR.registry_for(op)]
                == [k.name for k in RR.registry_for(op)])
    with pytest.raises(NotImplementedError):
        PR.registry_for("linear", allow_lossy=True)


@pytest.mark.parametrize("case", range(4))
def test_shape_class_keys_match(case):
    cfgs = [
        ("c", "conv2d", {"kernel": 3, "stride": 1, "padding": "SAME",
                         "in_channels": 8, "out_channels": 16},
         {"w": (16, 8, 3, 3), "b": (16,)}, (1, 24, 24, 8)),
        ("l", "linear", {"in_features": 70, "out_features": 33},
         {"w": (70, 33), "b": (33,)}, (4, 70)),
        ("s", "stateless", {}, {}, (1, 6, 6, 8)),
        ("c2", "conv2d", {"kernel": 3, "stride": 2, "padding": "SAME"},
         {"w": (4, 4, 3, 3)}, None),
    ]
    name, op, cfg, ws, xshape = cfgs[case]
    rs, ps = RR.LayerSpec(name, op, cfg, ws), PR.LayerSpec(name, op, cfg, ws)
    assert rs.weight_bytes == ps.weight_bytes
    kw = dict(input_shape=xshape, input_dtype="float32" if xshape else None,
              weight_dtypes={k: "float32" for k in ws} or None)
    assert RR.shape_class_key(rs, **kw) == PR.shape_class_key(ps, **kw)
    assert (RR.shape_class_sibling_key(rs, **kw)
            == PR.shape_class_sibling_key(ps, **kw))
    assert RR._canon(cfg) == PR._canon(cfg)
