"""bfloat16 in the port without ``ml_dtypes`` (``repro_torch.bf16``).

The port carries bf16 host arrays as uint16 bit patterns under a dtype
tagged "bfloat16". With ``ml_dtypes`` hidden from the import system, a bf16
store still writes and reads with the reference's bytes and tags, staging
gives ``torch.bfloat16`` tensors, avatars and kernel-cache keys say
"bfloat16", and the cold-LLM path decides and runs.
"""
import sys

import numpy as np
import pytest
import torch

from repro_torch import bf16

torch.set_num_threads(1)


@pytest.fixture
def no_ml_dtypes(monkeypatch):
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with pytest.raises(ImportError):
        import ml_dtypes  # noqa: F401


def _vals(n=257, seed=0):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    x[:4] = [0.0, -0.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8]  # two ties
    return x


def test_rounding_matches_torch_and_tag_survives(no_ml_dtypes):
    x = _vals()
    b = bf16.from_float(x)
    want = torch.from_numpy(x).to(torch.bfloat16)
    assert torch.equal(bf16.to_tensor(b), want)
    assert b.dtype == np.uint16 and bf16.dtype_name(b) == "bfloat16"
    for view in (b[1:], b.reshape(1, -1).T, np.array(b), b.copy(),
                 np.ascontiguousarray(b[::2])):
        assert bf16.is_bf16(view) and bf16.dtype_name(view) == "bfloat16"
    assert not bf16.is_bf16(b.view(np.uint16).astype(np.uint16) + 0)
    back = bf16.to_numpy(want)
    assert bf16.is_bf16(back) and back.tobytes() == b.tobytes()
    assert bf16.dtype_name(torch.bfloat16) == "bfloat16"
    assert bf16.np_dtype("bfloat16") == bf16.BFLOAT16
    assert bf16.np_dtype("float32") == np.float32


@pytest.mark.parametrize("fmt", ["bundle", "super", "npy"])
def test_bf16_store_round_trip(tmp_path, fmt, no_ml_dtypes):
    from repro_torch.checkpoint import LayerStore

    w = {"w": bf16.from_float(_vals(96).reshape(8, 12)),
         "f": _vals(5, seed=1)}
    st = LayerStore(tmp_path / "s", fmt=fmt)
    st.write_raw("l0", {"f": w["f"]})
    st.write_cached("l0", "bf16_cast", w)
    if fmt == "super":
        st.maintain()
    for store in (st, LayerStore(tmp_path / "s", fmt=fmt)):
        got = store.read_cached("l0", "bf16_cast")
        assert sorted(got) == ["f", "w"]
        assert bf16.dtype_name(got["w"]) == "bfloat16"
        assert got["w"].shape == (8, 12)
        assert got["w"].tobytes() == w["w"].tobytes()
        assert got["f"].dtype == np.float32
        if fmt != "npy":
            assert store.audit_cached("l0", "bf16_cast")


def test_bf16_staging_and_avatars(tmp_path, no_ml_dtypes):
    from repro_torch.core.compile_cache import _dtype_name
    from repro_torch.core.profiler import avatars_of
    from repro_torch.core.staging import stage_weights
    from repro_torch.device import to_device, to_numpy
    from repro_torch.ioengine import StageEngine

    b = bf16.from_float(_vals(12).reshape(3, 4))
    ro = b.copy()
    ro.flags.writeable = False
    want = bf16.to_tensor(b)
    st = stage_weights({"b": b, "ro": ro}, "cpu")
    for t in st.values():
        assert t.dtype == torch.bfloat16 and torch.equal(t, want)
    eng = StageEngine("host")
    try:
        out = eng.stage({"b": b}, torch.device("cpu"))
        assert out["b"].dtype == torch.bfloat16
        assert torch.equal(out["b"], want)
    finally:
        eng.close()
    t = to_device(b, torch.device("cpu"))
    assert t.dtype == torch.bfloat16 and torch.equal(t, want)
    assert bf16.dtype_name(to_numpy(t)) == "bfloat16"
    assert avatars_of({"b": b, "f": np.zeros(2, np.float32)}) == {
        "b": [[3, 4], "bfloat16"], "f": [[2], "float32"]}
    assert _dtype_name(torch.bfloat16) == _dtype_name(b.dtype) == "bfloat16"


def test_cold_llm_path_runs_without_ml_dtypes(tmp_path, no_ml_dtypes):
    import json

    from repro_torch.core.engine import ColdEngine
    from repro_torch.core.llm_graph import tiny_llm_graph
    from repro_torch.core.profiler import SyntheticProfiler

    layers, x = tiny_llm_graph(2)
    eng = ColdEngine(layers, tmp_path / "s", store_fmt="super", device="cpu")
    eng.profiler_factory = SyntheticProfiler
    stats = eng.decide(x, n_little=2, calibrate_interference=False)
    assert any(k == "bf16_cast" and c for k, c in stats["choices"].values())
    out = eng.run_cold(x).output
    assert out.dtype == torch.float32 and tuple(out.shape) == (1, 64, 512)
    assert torch.isfinite(out).all()
    db = json.loads((tmp_path / "s" / "profile_db.json").read_text())
    text = json.dumps(db)
    assert '"bfloat16"' in text and '"uint16"' not in text
