"""The port's cold-inference slice (ColdEngine.decide -> run_cold) against the
JAX package's, on the CPU at small sizes.

* Plan: with SyntheticProfiler in both packages (and the wall-clock I/O
  interference calibration off), both produce the identical plan for every
  CNN_NAMES model.
* Output: under that one plan — and under pinned plans that force the
  Winograd and packed kernels — run_cold matches the reference within
  rtol=1e-4, atol=1e-4 (f32, different summation orders), in nnv12 and
  sequential modes, for the bundle and super store formats.
* Store: a store written by one package opens in the other with equal bytes
  and CRCs, and plan.json reads across.
* Conversion and device: from_reference equals build_cnn; asking for CUDA
  without a card raises.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro.core.engine import ColdEngine as RefEngine
from repro.core.profiler import SyntheticProfiler as RefSynthetic
from repro.core.scheduler import Choice as RefChoice
from repro.models.cnn import CNN_NAMES as REF_CNN_NAMES
from repro.models.cnn import build_cnn as ref_build_cnn
from repro_torch.core.engine import ColdEngine
from repro_torch.core.profiler import SyntheticProfiler
from repro_torch.core.scheduler import Choice, Plan
from repro_torch.kernels import ops
from repro_torch.models.cnn import (
    CNN_NAMES, STATELESS_FNS, build_cnn, from_reference, stateless_kind,
)

# one intra-op thread: the suite runs in parallel workers, and the engine's
# CorePool threads already run layers concurrently
torch.set_num_threads(1)

SMALL = dict(image=17, width=0.25)


def _engines(tmp_path, name, fmt="bundle", **build):
    build = build or SMALL
    rl, rx = ref_build_cnn(name, **build)
    pl, px = build_cnn(name, **build)
    assert np.array_equal(rx, px)
    ref = RefEngine(rl, tmp_path / "ref", store_fmt=fmt)
    ref.profiler_factory = RefSynthetic
    port = ColdEngine(pl, tmp_path / "port", store_fmt=fmt, device="cpu")
    port.profiler_factory = SyntheticProfiler
    rs = ref.decide(rx, n_little=2, calibrate_interference=False)
    ps = port.decide(px, n_little=2, calibrate_interference=False)
    return ref, port, rx, rs, ps


def test_cnn_names_match():
    assert CNN_NAMES == REF_CNN_NAMES


@pytest.mark.parametrize("name", CNN_NAMES)
def test_plan_identical_under_synthetic_profiles(tmp_path, name):
    ref, port, _, rs, ps = _engines(tmp_path, name)
    assert port.plan.to_dict() == ref.plan.to_dict()
    assert ps["choices"] == {k: tuple(v) for k, v in rs["choices"].items()}
    assert ps["shape_classes"] == rs["shape_classes"]
    assert ps["planned_cold_read_bytes"] == rs["planned_cold_read_bytes"]


def _assert_out(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fmt", ["bundle", "super"])
@pytest.mark.parametrize("name", ["resnet18", "squeezenet", "mobilenet"])
def test_run_cold_matches_reference(tmp_path, name, fmt):
    ref, port, x, _, _ = _engines(tmp_path, name, fmt)
    ops.reset_launch_counts()
    for mode in ("nnv12", "sequential"):
        _assert_out(port.run_cold(x, mode=mode).output,
                    ref.run_cold(x, mode=mode).output)
    _assert_out(port.run_cold(x, mode="nnv12_nosteal").output,
                ref.run_cold(x).output)
    assert port.run_warm(x, repeats=1) > 0
    assert all(n == 0 for n in ops.launch_counts().values())
    assert not port.repairs.of_kind("kernel_demoted")


def _pinned(layers, conv_s1, conv_s2, head, choice_cls):
    out = []
    for l in layers:
        if l.spec.op_type == "stateless":
            out.append(choice_cls("fn", False))
        elif l.spec.op_type == "linear":
            out.append(choice_cls(head, False))
        else:
            s1 = (l.spec.config.get("stride", 1) == 1
                  and l.spec.config["kernel"] == 3)
            out.append(choice_cls(conv_s1 if s1 else conv_s2, False))
    return out


@pytest.mark.parametrize("kernels", [
    ("winograd_f2x3", "im2col_sgemm", "packed"),
    ("im2col_sgemm", "direct", "direct"),
])
@pytest.mark.parametrize("fmt", ["bundle", "super"])
def test_run_cold_pinned_kernels_match_reference(tmp_path, kernels, fmt):
    ref, port, x, _, _ = _engines(tmp_path, "resnet18", fmt,
                                  image=18, width=0.3)
    ref.plan = replace(ref.plan, choices=_pinned(ref.layers, *kernels,
                                                 RefChoice))
    ref._runtimes.clear()
    port.set_plan(replace(port.plan, choices=_pinned(port.layers, *kernels,
                                                     Choice)))
    assert port.plan.to_dict() == ref.plan.to_dict()
    _assert_out(port.run_cold(x).output, ref.run_cold(x).output)
    assert not port.repairs.of_kind("kernel_demoted")


def test_faulting_kernel_demotes_to_reference_kernel(tmp_path, monkeypatch):
    """The degradation ladder: a kernel that raises at execute is demoted to
    the registry head, the repair is journaled, the output stays right."""
    ref, port, x, _, _ = _engines(tmp_path, "mobilenet")
    want = ref.run_cold(x).output
    port.set_plan(replace(port.plan, choices=_pinned(
        port.layers, "winograd_f2x3", "im2col_sgemm", "direct", Choice)))

    def boom(*a, **k):
        raise RuntimeError("injected kernel fault")

    monkeypatch.setattr(ops, "winograd_tile_matmul", boom)
    _assert_out(port.run_cold(x).output, want)
    demoted = port.repairs.of_kind("kernel_demoted")
    assert demoted and all(d["kernel"] == "winograd_f2x3" for d in demoted)
    assert port.breaker.open_keys()


def test_store_and_plan_read_across(tmp_path):
    from repro.checkpoint import LayerStore as RefStore
    from repro.checkpoint import read_super_header as ref_header
    from repro_torch.checkpoint import LayerStore, read_super_header

    ref, port, x, _, _ = _engines(tmp_path, "squeezenet", "super")
    # the two packages wrote the same container, byte for byte
    rfile = tmp_path / "ref" / "model.superbundle"
    pfile = tmp_path / "port" / "model.superbundle"
    assert rfile.read_bytes() == pfile.read_bytes()
    assert ref_header(rfile) == read_super_header(rfile)
    # each package opens the other's store
    a, b = LayerStore(tmp_path / "ref", fmt="super"), \
        RefStore(tmp_path / "port", fmt="super")
    for l in port.layers:
        if not l.spec.weight_shapes:
            continue
        for k, v in a.read_raw(l.spec.name).items():
            assert np.asarray(v).tobytes() == l.weights[k].tobytes()
        for k, v in b.read_raw(l.spec.name).items():
            assert np.asarray(v).tobytes() == l.weights[k].tobytes()
    # plan.json written by the reference loads in the port and runs there
    pl, _ = build_cnn("squeezenet", **SMALL)
    other = ColdEngine(pl, tmp_path / "ref", store_fmt="super", device="cpu")
    assert other.ensure_plan(x).to_dict() == ref.plan.to_dict()
    assert not other.repairs.of_kind("plan_fallback")
    _assert_out(other.run_cold(x).output, ref.run_cold(x).output)
    assert Plan.from_dict(ref.plan.to_dict()).to_dict() == ref.plan.to_dict()


@pytest.mark.parametrize("name", CNN_NAMES)
def test_from_reference_equals_build_cnn(name):
    ref_layers, rx = ref_build_cnn(name, image=20, width=0.3, seed=3)
    mine, px = build_cnn(name, image=20, width=0.3, seed=3)
    conv = from_reference(ref_layers)
    assert np.array_equal(rx, px) and len(conv) == len(mine)
    for a, b in zip(conv, mine):
        assert a.spec == b.spec
        assert sorted(a.weights) == sorted(b.weights)
        for k in a.weights:
            assert a.weights[k].dtype == b.weights[k].dtype
            assert np.array_equal(a.weights[k], b.weights[k])
        assert a.fn is b.fn


def test_stateless_fns_match_reference():
    import jax
    import jax.numpy as jnp

    x = np.random.default_rng(5).standard_normal((2, 6, 7, 3)).astype(
        np.float32)
    ref = {
        "relu": jax.nn.relu(jnp.asarray(x)),
        "gap": jnp.mean(jnp.asarray(x), axis=(1, 2)),
        "pool": jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                      (1, 2, 2, 1), (1, 2, 2, 1), "VALID"),
    }
    for kind, fn in STATELESS_FNS.items():
        np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(),
                                   np.asarray(ref[kind]), atol=1e-6)
    assert stateless_kind("head_gap") == "gap"
    assert stateless_kind("s0b1_relu2") == "relu"
    with pytest.raises(KeyError):
        stateless_kind("softmax")


def test_cuda_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the request would succeed")
    layers, _ = build_cnn("mobilenet", **SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        ColdEngine(layers, tmp_path / "s")
    with pytest.raises(RuntimeError, match="CUDA"):
        ColdEngine(layers, tmp_path / "s", device="cuda")


def test_stage_weights_contract(tmp_path):
    """Read-only (file-backed) views are copied before staging; heap arrays
    alias as on the reference's CPU backend; the host stage engine stages
    CPU tensors."""
    from repro_torch.core.staging import stage_weights
    from repro_torch.ioengine import StageEngine

    ro = np.arange(6, dtype=np.float32)
    ro.flags.writeable = False
    rw = np.arange(4, dtype=np.float32)
    st = stage_weights({"ro": ro, "rw": rw}, "cpu")
    assert st.event is None
    assert st["ro"].data_ptr() != ro.ctypes.data
    assert st["rw"].data_ptr() == rw.ctypes.data
    eng = StageEngine("host")
    try:
        out = eng.stage({"rw": rw}, torch.device("cpu"))
        assert torch.equal(out["rw"], torch.from_numpy(rw))
        assert eng.stats["staged"] == 1
    finally:
        eng.close()


def test_set_plan_validates(tmp_path):
    from repro_torch.faults import PlanFault

    _, port, _, _, _ = _engines(tmp_path, "mobilenet")
    with pytest.raises(PlanFault):
        port.set_plan(replace(port.plan, choices=port.plan.choices[:-1]))
    bad = list(port.plan.choices)
    bad[0] = Choice("no_such_kernel", False)
    with pytest.raises(PlanFault):
        port.set_plan(replace(port.plan, choices=bad))
