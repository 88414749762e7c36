"""The port's continuous-mode kernel switching (``core.switching``) against
the JAX package's, on the CPU at small size.

* Twin of ``tests/test_engine.py::test_continuous_session_switching``:
  squeezenet (image 24, width 0.35), the reference's weights carried over
  by ``from_reference``, one K_cold pinned in both packages over
  ``SyntheticProfiler`` profiles (so K_warm, the fastest-execute kernels,
  is the same too): the same layers switch, and the cold, 2nd and 3rd
  outputs agree with the reference's within 1e-4 of max|ref|. The test
  fails if no layer switches.
* ``warm_infer``'s three arms: a prepared warm kernel, the cold run's
  resident tensors, and a read-transform-stage on the spot.
* Warm weights are staged copies: an identity transform's read-only mmap
  view is never aliased.
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import ColdEngine as RefEngine  # noqa: E402
from repro.core.profiler import SyntheticProfiler as RefSynthetic  # noqa: E402
from repro.core.scheduler import Choice as RefChoice  # noqa: E402
from repro.core.switching import ContinuousSession as RefSession  # noqa: E402
from repro.models.cnn import build_cnn as ref_build_cnn  # noqa: E402
from repro_torch.core.engine import ColdEngine  # noqa: E402
from repro_torch.core.profiler import SyntheticProfiler  # noqa: E402
from repro_torch.core.scheduler import Choice  # noqa: E402
from repro_torch.core.switching import ContinuousSession  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.cnn import build_cnn, from_reference  # noqa: E402

torch.set_num_threads(1)

GRAPH = dict(image=24, width=0.35)
# K_cold pins: (conv kernel, linear kernel); the synthetic K_warm is
# im2col_sgemm for every conv and direct for the head
PINS = {"direct_convs_packed_head": ("direct", "packed"),
        "direct_convs": ("direct", "direct")}


def _pin(layers, conv, head, choice_cls):
    out = []
    for l in layers:
        if l.spec.op_type == "stateless":
            out.append(choice_cls("fn", False))
        elif l.spec.op_type == "linear":
            out.append(choice_cls(head, False))
        else:
            out.append(choice_cls(conv, False))
    return out


def _twins(tmp_path, pin):
    rl, x = ref_build_cnn("squeezenet", **GRAPH)
    ref = RefEngine(rl, tmp_path / "ref")
    ref.profiler_factory = RefSynthetic
    port = ColdEngine(from_reference(rl), tmp_path / "port", device="cpu")
    port.profiler_factory = SyntheticProfiler
    ref.decide(x, n_little=2, calibrate_interference=False)
    port.decide(x, n_little=2, calibrate_interference=False)
    assert port.plan.to_dict() == ref.plan.to_dict()
    if pin is not None:
        ref.plan = replace(ref.plan, choices=_pin(ref.layers, *pin,
                                                  RefChoice))
        ref._runtimes.clear()
        port.set_plan(replace(port.plan, choices=_pin(port.layers, *pin,
                                                      Choice)))
        assert port.plan.to_dict() == ref.plan.to_dict()
    return ref, port, x


def _close(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert rel <= 1e-4, rel


@pytest.mark.parametrize("pin", list(PINS), ids=list(PINS))
def test_switching_matches_reference(tmp_path, pin):
    ref, port, x = _twins(tmp_path, PINS[pin])
    rs = RefSession(ref, n_little=2)
    ps = ContinuousSession(port, n_little=2)
    ops.reset_launch_counts()
    _close(ps.cold_infer(x).output, rs.cold_infer(x).output)
    _close(ps.warm_infer(x, wait=True).output,
           rs.warm_infer(x, wait=True).output)
    r3 = ps.warm_infer(x)
    _close(r3.output, rs.warm_infer(x).output)
    switched = sorted(ps.warm_weights)
    assert switched, "no layer switched"
    assert switched == sorted(rs.warm_weights)
    # every weighted layer the pin moved off K_warm switches once prepared
    want = [l.spec.name for l, w, c in zip(port.layers,
                                           port.warm_best_choices(),
                                           port.plan.choices)
            if l.spec.weight_shapes and w.kernel != c.kernel]
    assert switched == sorted(want)
    assert all(ps.warm_weights[n][0] == w.kernel
               for n, w in zip([l.spec.name for l in port.layers],
                               port.warm_best_choices())
               if n in ps.warm_weights)
    # one execute trace a layer, in order
    assert [t.layer for t in r3.traces] == [l.spec.name for l in port.layers]
    assert all(t.kind == "execute" for t in r3.traces)
    # CPU tensors take the plain versions: nothing launched
    assert all(n == 0 for n in ops.launch_counts().values())


def test_no_switch_when_the_plan_is_warm_best(tmp_path):
    _, port, x = _twins(tmp_path, None)
    assert [c.kernel for c in port.plan.choices] == \
        [c.kernel for c in port.warm_best_choices()]
    sess = ContinuousSession(port, n_little=2)
    r1 = sess.cold_infer(x)
    assert sess._bg is None and not sess.warm_weights
    assert torch.equal(sess.warm_infer(x, wait=True).output, r1.output)


@pytest.fixture
def session(tmp_path):
    layers, x = build_cnn("squeezenet", **GRAPH)
    eng = ColdEngine(layers, tmp_path / "port", device="cpu")
    eng.profiler_factory = SyntheticProfiler
    eng.decide(x, n_little=2, calibrate_interference=False)
    eng.set_plan(replace(eng.plan, choices=_pin(
        eng.layers, *PINS["direct_convs_packed_head"], Choice)))
    sess = ContinuousSession(eng, n_little=2)
    r1 = sess.cold_infer(x)
    sess._bg.wait(60)
    return sess, x, r1


def test_unswitched_layers_run_on_the_resident_cold_tensors(session):
    """With no warm kernel prepared, a warm inference is the cold plan on
    the cold run's staged tensors: bit for bit the cold output."""
    sess, x, r1 = session
    sess.warm_weights.clear()
    assert torch.equal(sess.warm_infer(x).output, r1.output)


def test_layers_with_nothing_resident_are_prepared_on_the_spot(session):
    sess, x, r1 = session
    sess.warm_weights.clear()
    sess.cold_weights.clear()
    assert torch.equal(sess.warm_infer(x).output, r1.output)


def test_warm_weights_never_alias_the_store(session):
    """The head switches from ``packed`` to ``direct``, an identity
    transform: the store hands back read-only mmap views, and staging must
    copy them, never alias them."""
    sess, _, _ = session
    head = next(l.spec.name for l in sess.engine.layers
                if l.spec.op_type == "linear")
    assert sess.warm_weights[head][0] == "direct"
    for _, w in sess.warm_weights.values():
        for t in w.values():
            assert isinstance(t, torch.Tensor)
            assert t.numpy().flags.writeable
